"""Build a compressed Llama- or Qwen3-MoE-scale bundle without its
full-precision weights.

Port of ``modelopt_tpu/models/synthetic.py::build_compressed_bundle``. The
decoder is built on the meta device; then, layer by layer on ``device``,
every kernel the preset quantizes is drawn from a ``torch.Generator`` in
bf16 (``N(0, 1) * init_scale``) and packed at once, so the transient is one
weight; an expert kernel [E, in, out] is drawn directly in its folded shape
[in, E*out] (the reference's synthetic.py:62-72; one Qwen3-30B-A3B gate
weight is a 403 MB transient). Norm scales start at 1 and every other
parameter (embedding, lm_head, router) is drawn the same way in
``param_dtype``. The bundle carries ``quantize`` and ``compress`` records,
like a quantized-then-compressed model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.bundle import ModelBundle, ModeRecord
from ..nn.layers import QuantDense, QuantEinsum, RMSNorm
from ..quant import mode as _mode  # noqa: F401  (registers quantize/compress)
from ..quant.config import get_config
from ..quant.qtensor import compressible_format, quantize_qtensor, spec_folds
from .transformer import Decoder, DecoderConfig


def build_compressed_bundle(cfg: DecoderConfig, quant_preset, seed: int = 0,
                            init_scale: float = 0.02, device="cuda") -> ModelBundle:
    qcfg = get_config(quant_preset)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Decoder(cfg, device="meta")
    for mod in model.modules():
        shape = None
        specs = qcfg.resolve(mod.path + "/weight_quantizer")
        if isinstance(mod, QuantDense):
            shape = (mod.in_features, mod.features)
        elif isinstance(mod, QuantEinsum) and specs and spec_folds(specs[0]):
            E, fin, fout = mod.kernel_shape
            shape = (fin, E * fout)
        if shape is not None:
            if specs and specs[0].enable and compressible_format(specs[0], shape):
                w = torch.randn(shape, generator=gen, device=device,
                                dtype=torch.bfloat16) * init_scale
                mod.set_qweight(quantize_qtensor(w, specs[0])[0])
                del w
        for name, p in list(mod.named_parameters(recurse=False)):
            if isinstance(mod, RMSNorm) and name == "scale":
                arr = torch.ones(p.shape, dtype=p.dtype, device=device)
            elif name == "bias":
                arr = torch.zeros(p.shape, dtype=p.dtype, device=device)
            else:
                arr = (torch.randn(p.shape, generator=gen, device=device)
                       * init_scale).to(p.dtype)
            setattr(mod, name, nn.Parameter(arr, requires_grad=False))
    records = (ModeRecord("quantize", qcfg, {}),
               ModeRecord("compress", {}, {"compressed": "synthetic"}))
    return ModelBundle(module=model, records=records)
