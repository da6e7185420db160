"""Build a Llama-, Qwen3-MoE- or DeepSeek-scale bundle from random weights:
full precision (``build_bundle``, the counterpart of ``module.init`` in
the reference's quantize-then-compress flow), or compressed without its
full-precision weights (``build_compressed_bundle``).

Port of ``modelopt_tpu/models/synthetic.py::build_compressed_bundle``. The
decoder is built on the meta device; then, layer by layer on ``device``,
every kernel the preset quantizes is drawn from a ``torch.Generator`` in
bf16 (``N(0, 1) * init_scale``) and packed at once, so the transient is one
weight; an expert kernel [E, in, out] is drawn directly in its folded shape
[in, E*out] (the reference's synthetic.py:62-72; one Qwen3-30B-A3B gate
weight is a 403 MB transient). Norm scales start at 1 and every other
parameter (embedding, lm_head, router) is drawn the same way in
``param_dtype``. Every packed format of ``quant/qtensor.py`` is drawn so
(int4, int8, e4m3, NVFP4). The bundle carries ``quantize`` and
``compress`` records, like a quantized-then-compressed model. A kernel the
preset quantizes but no packed format fits (DeepSeek-V2-Lite's first down
projection, K=10944) stays a dense ``param_dtype`` kernel, fake-quantized
in every forward, as the reference's ``compress`` leaves it; MLA's
absorbed ``kv_b_proj`` packs like any linear layer.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.bundle import ModelBundle, ModeRecord
from ..nn.layers import QuantDense, QuantEinsum, RMSNorm
from ..quant import mode as _mode  # noqa: F401  (registers quantize/compress)
from ..quant.config import get_config
from ..quant.qtensor import compressible_format, quantize_qtensor, spec_folds, unfold_experts
from .mla import AbsorbedKernel
from .transformer import Decoder, DecoderConfig


def _param(mod, name: str, p, gen, init_scale: float, device) -> torch.Tensor:
    """A non-kernel parameter: norm scales 1, biases 0, the rest
    ``N(0, 1) * init_scale`` drawn in f32, in the parameter's dtype."""
    if isinstance(mod, RMSNorm) and name == "scale":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if name == "bias":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    return (torch.randn(p.shape, generator=gen, device=device) * init_scale).to(p.dtype)


def build_bundle(cfg: DecoderConfig, seed: int = 0, init_scale: float = 0.02,
                 device="cuda") -> ModelBundle:
    """A full-precision Decoder on ``device`` with no mode applied, ready
    for ``quant.api.quantize``: every kernel drawn as
    ``build_compressed_bundle`` draws one (bf16 ``N(0, 1) * init_scale``, an
    expert kernel in its folded [in, E*out] shape, then unfolded), stored in
    ``cfg.param_dtype``; the other parameters by ``_param``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Decoder(cfg, device="meta")
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if name == "kernel" and isinstance(mod, QuantEinsum):
                E, fin, fout = mod.kernel_shape
                w = torch.randn((fin, E * fout), generator=gen, device=device,
                                dtype=torch.bfloat16) * init_scale
                arr = unfold_experts(w, E).to(p.dtype).contiguous()
            elif name == "kernel":
                arr = (torch.randn(p.shape, generator=gen, device=device,
                                   dtype=torch.bfloat16) * init_scale).to(p.dtype)
            else:
                arr = _param(mod, name, p, gen, init_scale, device)
            setattr(mod, name, nn.Parameter(arr, requires_grad=False))
    return ModelBundle(module=model)


def build_compressed_bundle(cfg: DecoderConfig, quant_preset, seed: int = 0,
                            init_scale: float = 0.02, device="cuda") -> ModelBundle:
    qcfg = get_config(quant_preset)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Decoder(cfg, device="meta")
    for mod in model.modules():
        shape = None
        specs = qcfg.resolve(mod.path + "/weight_quantizer")
        if isinstance(mod, (QuantDense, AbsorbedKernel)):
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
            setattr(mod, name, nn.Parameter(_param(mod, name, p, gen, init_scale, device),
                                            requires_grad=False))
    records = (ModeRecord("quantize", qcfg, {}),
               ModeRecord("compress", {}, {"compressed": "synthetic"}))
    return ModelBundle(module=model, records=records)
