"""Fake quantization for the specs of the serving slice.

Port of the int8 parts of ``modelopt_tpu/quant/fake_quant.py``: per-tensor
static int8 (a calibrated amax) and per-token dynamic int8 (a scale per row
from this call's values). Other specs (fp formats, int4 fake-quant,
two-level blocks) raise NotImplementedError. Inference only: no straight-
through gradients are defined.
"""

from __future__ import annotations

import torch

from .qspec import QuantizerSpec

_TINY = 1e-24


def fake_quant_int(x: torch.Tensor, amax, num_bits: int = 8, unsigned: bool = False,
                   narrow_range: bool = False) -> torch.Tensor:
    """Symmetric integer fake quantization with 2^(b-1)-1 levels:
    round(clip(x * bound/amax)) / (bound/amax), in f32."""
    bound = 2 ** (num_bits - (0 if unsigned else 1)) - 1
    min_bound = 0 if unsigned else (-bound if narrow_range else -bound - 1)
    amax = torch.as_tensor(amax, device=x.device).abs().float().clamp_min(_TINY)
    scale = bound / amax
    xq = torch.round(torch.clamp(x.float() * scale, min_bound, bound))
    return (xq / scale).to(x.dtype)


def fake_quant_int8_per_token(x: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Dynamic per-row int8 (block {-1: 0}): scale = max(|row|)/bound."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(_TINY)
    scale = amax / spec.int_bound
    y = torch.round(torch.clamp(xf / scale, -spec.int_bound - 1, spec.int_bound)) * scale
    return y.to(x.dtype)


def is_per_token_int8(spec: QuantizerSpec) -> bool:
    return bool(not spec.is_fp and spec.num_bits == 8 and spec.block is not None
                and spec.block.dynamic and not spec.block.two_level
                and tuple(spec.block.sizes) == ((-1, 0),))


def fake_quantize(x: torch.Tensor, spec: QuantizerSpec, amax=None) -> torch.Tensor:
    """Fake-quantize ``x`` per ``spec``; ``amax`` is the calibrated amax for
    static specs (None = from this call's values)."""
    if not spec.enable:
        return x
    if spec.is_fp or spec.rotate or spec.bias_mode is not None:
        raise NotImplementedError(f"fake quantization of {spec} is not ported")
    if spec.block is not None:
        if is_per_token_int8(spec):
            return fake_quant_int8_per_token(x, spec)
        raise NotImplementedError(f"block fake quantization of {spec} is not ported")
    if spec.axis is not None:
        raise NotImplementedError("per-channel fake quantization is not ported")
    if amax is None:
        amax = x.abs().amax().float()
    return fake_quant_int(x, amax, spec.num_bits, spec.unsigned, spec.narrow_range)
