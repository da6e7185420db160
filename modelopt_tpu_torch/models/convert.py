"""Carry a reference (JAX) model's variables into the port.

``from_jax_variables`` takes the reference bundle's variables as a nested
dict of numpy arrays — ``params`` (kernels [in, out] and expert kernels
[E, in, out], embedding, norm scales including the q/k norms, the MoE
router's kernel and bias) and ``quant`` (packed ``qweight`` {data, scale}
in the same [in, out] layout, the folded [in, E*out] one for experts, k/v
quantizer ``amax``) — and loads them into a port Decoder, so both packages
compute the same model. Every leaf must be consumed: a leaf
the port has no place for (a pre-quant scale, an unported quantizer state)
raises instead of being dropped.
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
from .transformer import Decoder, DecoderConfig


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


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
        if (isinstance(mod, (QuantDense, QuantEinsum))
                and f"quant/{base}/qweight/data" in leaves):
            mod.set_qweight({"data": take(f"quant/{base}/qweight/data"),
                             "scale": take(f"quant/{base}/qweight/scale")})
            compressed = True
        if isinstance(mod, TensorQuantizer) and f"quant/{base}/amax" in leaves:
            mod.amax = take(f"quant/{base}/amax").float()
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
