"""Carry a reference (JAX) model's variables into the port.

``from_jax_variables`` takes the reference bundle's variables as a nested
dict of numpy arrays (or tensors) — ``params`` (kernels [in, out] and
expert kernels [E, in, out], embedding, norm scales including the q/k and
MLA norms, the MoE router's kernel and bias, MLA's absorbed ``kv_b_proj``
kernel, a kernel left dense by ``compress``) and ``quant`` (packed ``qweight``
{data, scale} in the same [in, out] layout, the folded [in, E*out] one for
experts, plus NVFP4's ``scale2``, the e4m3 arrays of fp8 and NVFP4 weights
carried bit for bit; calibrated quantizer ``amax``, per tensor or per
channel, the ``pre_quant_scale`` SmoothQuant, AWQ and SVDQuant set on
input quantizers, and SVDQuant's ``svd_lora_a`` / ``svd_lora_b`` of a
dense layer) — and loads them into a port Decoder, so both packages compute
the same model. Every leaf must be consumed: a leaf the port has no place
for (an unported quantizer state) raises instead of being dropped.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.bundle import ModelBundle, ModeRecord
from ..core.tree import flatten_with_paths
from ..nn.layers import QuantDense, QuantEinsum
from ..nn.quantizer import TensorQuantizer
from ..quant import mode as _mode  # noqa: F401  (registers quantize/compress)
from ..quant.config import get_config
from .mla import AbsorbedKernel
from .transformer import Decoder, DecoderConfig


_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name in _BIT_VIEWS:  # ml_dtypes types torch cannot read: the bits
        raw, dtype = _BIT_VIEWS[arr.dtype.name]
        return torch.from_numpy(arr.view(raw).copy()).view(dtype).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def from_jax_variables(variables: dict, cfg: DecoderConfig, quant_config=None,
                       device="cuda") -> ModelBundle:
    """A ModelBundle of the port holding the reference's weights; with
    ``quant_config`` (a preset name or QuantizeConfig) it carries a
    ``quantize`` record, plus ``compress`` when packed weights are present."""
    leaves = {}
    for coll in ("params", "quant"):
        for path, leaf in flatten_with_paths(variables.get(coll, {})):
            leaves[f"{coll}/{path}"] = leaf
    extra = set(variables) - {"params", "quant"}
    if extra:
        raise ValueError(f"from_jax_variables: unported collections {sorted(extra)}")

    def take(key):
        if key not in leaves:
            raise KeyError(f"from_jax_variables: missing {key}")
        return _tensor(leaves.pop(key), device)

    model = Decoder(cfg, device="meta")
    compressed = False
    for mod in model.modules():
        base = mod.path
        if (isinstance(mod, (QuantDense, QuantEinsum, AbsorbedKernel))
                and f"quant/{base}/qweight/data" in leaves):
            qt = {k: take(f"quant/{base}/qweight/{k}") for k in ("data", "scale")}
            if f"quant/{base}/qweight/scale2" in leaves:  # NVFP4
                qt["scale2"] = take(f"quant/{base}/qweight/scale2")
            mod.set_qweight(qt)
            compressed = True
        if isinstance(mod, QuantDense):  # SVDQuant's low-rank branch
            for name in ("svd_lora_a", "svd_lora_b"):
                if f"quant/{base}/{name}" in leaves:
                    setattr(mod, name, take(f"quant/{base}/{name}").float())
        if isinstance(mod, TensorQuantizer):
            for name in ("amax", "pre_quant_scale"):
                if f"quant/{base}/{name}" in leaves:
                    setattr(mod, name, take(f"quant/{base}/{name}").float())
        for name, _ in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(take(f"params/{base}/{name}"),
                                            requires_grad=False))
    if leaves:
        raise ValueError(f"from_jax_variables: leaves the port cannot place: "
                         f"{sorted(leaves)[:8]}")
    records = ()
    if quant_config is not None:
        records = (ModeRecord("quantize", get_config(quant_config), {}),)
        if compressed:
            records += (ModeRecord("compress", {}, {"compressed": "reference"}),)
    return ModelBundle(module=model, records=records)
