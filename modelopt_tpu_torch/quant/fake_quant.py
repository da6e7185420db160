"""Fake quantization for the specs of the serving slices.

Port of the integer parts of ``modelopt_tpu/quant/fake_quant.py``:
per-tensor static int8 (a calibrated amax), per-token dynamic int8 (a scale
per row from this call's values) and dynamic one-level integer blocks (the
int4 block-128 weight spec on a kernel too ragged to pack, such as
DeepSeek-V2-Lite's first down projection, K=10944), with the reference's
zero padding of a dimension the block does not divide. Other specs (fp
formats, two-level or static blocks) raise NotImplementedError. Inference
only: no straight-through gradients are defined.
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


def fake_quant_block_int(x: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Dynamic one-level integer block fake quantization (the reference's
    ``_blocked`` + ``fake_quant_block``): each blocked axis is zero-padded up
    to a multiple of its block (zeros never raise a block's amax) and split
    into (n_blocks, block); scale = max(amax, 1e-24) / bound per block,
    round-half-even(clip(x / scale, -bound-1, bound)) * scale in f32, then
    the padding is cut away."""
    xf = x.float()
    shape = xf.shape
    sizes = dict(spec.block.sizes)
    pads = [0] * xf.dim()
    bs_dim = [None] * xf.dim()
    for i, d in enumerate(shape):
        bs = next((s for a, s in sizes.items() if a % xf.dim() == i), None)
        if bs is None:
            continue
        bs = d if bs <= 0 else min(bs, max(d, 1))
        bs_dim[i] = bs
        pads[i] = (-d) % bs
    if any(pads):
        pad_arg = []
        for p in reversed(pads):
            pad_arg += [0, p]
        xf = torch.nn.functional.pad(xf, pad_arg)
    padded = xf.shape
    new_shape, block_axes = [], []
    for i, d in enumerate(padded):
        if bs_dim[i] is None:
            new_shape.append(d)
        else:
            new_shape += [d // bs_dim[i], bs_dim[i]]
            block_axes.append(len(new_shape) - 1)
    xb = xf.reshape(new_shape)
    amax = xb.abs().amax(dim=tuple(block_axes), keepdim=True)
    scale = amax.clamp_min(_TINY) / spec.int_bound
    y = torch.round(torch.clamp(xb / scale, -spec.int_bound - 1, spec.int_bound)) * scale
    y = y.reshape(padded)[tuple(slice(0, d) for d in shape)]
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
        if (spec.block.dynamic and not spec.block.two_level
                and spec.block.scale_format is None and not spec.block.four_over_six):
            return fake_quant_block_int(x, spec)
        raise NotImplementedError(f"block fake quantization of {spec} is not ported")
    if spec.axis is not None:
        raise NotImplementedError("per-channel fake quantization is not ported")
    if amax is None:
        amax = x.abs().amax().float()
    return fake_quant_int(x, amax, spec.num_bits, spec.unsigned, spec.narrow_range)
