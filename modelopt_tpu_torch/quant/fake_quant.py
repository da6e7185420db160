"""Fake quantization for the specs of the serving slices.

Port of ``modelopt_tpu/quant/fake_quant.py`` for: per-tensor static int8
(a calibrated amax), per-token dynamic int8 (a scale per row from this
call's values), per-channel integer (the INT8 presets' weights, a
calibrated amax per kept axis), dynamic one-level integer blocks (the int4
block-128 weight spec on a kernel too ragged to pack, such as
DeepSeek-V2-Lite's first down projection, K=10944), per-tensor fp (the FP8 presets' e4m3 activations and
weights: ``fake_quant_fp``) and NVFP4's dynamic two-level blocks (e2m1
elements, e4m3 block scales over an f32 per-tensor scale), with the
reference's zero padding of a dimension the block does not divide. Other
specs (per-channel fp, static or e8m0 blocks, 4/6 scales, affine) raise
NotImplementedError; a rotated spec's rotation is TensorQuantizer's.
Inference only: no straight-through gradients are defined.
"""

from __future__ import annotations

import torch

from .formats import FPFormat, cast_to_fp, parse_format, true_divide
from .qspec import QuantizerSpec

_TINY = 1e-24


def reduce_amax(x: torch.Tensor, axis=None, keepdims: bool = True) -> torch.Tensor:
    """Max of |x| over every dim except those ``axis`` names (the kept ones);
    ``axis=None`` reduces all of them to a scalar."""
    x = x.abs()
    if axis is None:
        return x.amax()
    keep = {a % x.dim() for a in axis}
    red = tuple(i for i in range(x.dim()) if i not in keep)
    return x.amax(dim=red, keepdim=keepdims)


def fake_quant_int(x: torch.Tensor, amax, num_bits: int = 8, unsigned: bool = False,
                   narrow_range: bool = False) -> torch.Tensor:
    """Symmetric integer fake quantization with 2^(b-1)-1 levels:
    round(clip(x * bound/amax)) / (bound/amax), in f32."""
    bound = 2 ** (num_bits - (0 if unsigned else 1)) - 1
    min_bound = 0 if unsigned else (-bound if narrow_range else -bound - 1)
    amax = torch.as_tensor(amax, device=x.device).abs().float().clamp_min(_TINY)
    scale = amax.new_full(amax.shape, float(bound)) / amax  # a true division
    xq = torch.round(torch.clamp(x.float() * scale, min_bound, bound))
    return (xq / scale).to(x.dtype)


def fake_quant_fp(x: torch.Tensor, amax, fmt: FPFormat) -> torch.Tensor:
    """FP fake quantization: scale = maxval / max(|amax|, 1e-24), then
    cast_to_fp(clip(x * scale, +-maxval)) / scale, in f32 (the clip is
    cast_to_fp's own saturation)."""
    amax = torch.as_tensor(amax, device=x.device).abs().float().clamp_min(_TINY)
    # a true division (``float / tensor`` is a reciprocal times the float)
    scale = amax.new_full(amax.shape, fmt.maxval) / amax
    return (cast_to_fp(x.float() * scale, fmt) / scale).to(x.dtype)


def fake_quant_int8_per_token(x: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Dynamic per-row int8 (block {-1: 0}): scale = max(|row|)/bound."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(_TINY)
    scale = true_divide(amax, spec.int_bound)
    y = torch.round(torch.clamp(xf / scale, -spec.int_bound - 1, spec.int_bound)) * scale
    return y.to(x.dtype)


def _blocked(xf: torch.Tensor, spec: QuantizerSpec):
    """The reference's ``_blocked``: each blocked axis zero-padded up to a
    multiple of its block (zeros never raise a block's amax) and split into
    (n_blocks, block). Returns (xb, unblock, block_axes)."""
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

    def unblock(y):
        return y.reshape(padded)[tuple(slice(0, d) for d in shape)]

    return xf.reshape(new_shape), unblock, tuple(block_axes)


def fake_quant_block_int(x: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Dynamic one-level integer block fake quantization (the reference's
    ``fake_quant_block``): scale = max(amax, 1e-24) / bound per block,
    round-half-even(clip(x / scale, -bound-1, bound)) * scale in f32, then
    the padding is cut away."""
    xb, unblock, axes = _blocked(x.float(), spec)
    amax = xb.abs().amax(dim=axes, keepdim=True)
    scale = true_divide(amax.clamp_min(_TINY), spec.int_bound)
    y = torch.round(torch.clamp(xb / scale, -spec.int_bound - 1, spec.int_bound)) * scale
    return unblock(y).to(x.dtype)


def _block_scales_two_level(block_amax, elem_max: float, scale_fmt: FPFormat, tensor_amax):
    """NVFP4's two-level scales: s2 = max(tensor_amax, 1e-24) /
    (elem_max * scale_fmt.maxval), each block's s1 = cast_to_fp(amax /
    elem_max / s2, scale_fmt); returns max(s1 * s2, 1e-24)."""
    # true divisions: a CUDA tensor over a Python float is a reciprocal
    # times it, an ulp from the CPU's quotient (formats.true_divide)
    s2 = true_divide(torch.as_tensor(tensor_amax, device=block_amax.device).float()
                     .clamp_min(_TINY), elem_max * scale_fmt.maxval)
    s1 = cast_to_fp(true_divide(block_amax, elem_max) / s2, scale_fmt)
    return (s1 * s2).clamp_min(_TINY)


def fake_quant_block_two_level(x: torch.Tensor, spec: QuantizerSpec,
                               tensor_amax=None) -> torch.Tensor:
    """Dynamic two-level fp block fake quantization (NVFP4): per-block amax
    from this call, the per-tensor amax calibrated (``tensor_amax``) or
    from this call; cast_to_fp(clip(x / scale, +-maxval)) * scale in f32."""
    xf = x.float()
    xb, unblock, axes = _blocked(xf, spec)
    block_amax = xb.abs().amax(dim=axes, keepdim=True)
    t_amax = tensor_amax if tensor_amax is not None else xf.abs().amax()
    scale = _block_scales_two_level(block_amax, spec.maxval,
                                    parse_format(spec.block.scale_format), t_amax)
    fmt = spec.fp_format
    y = cast_to_fp(torch.clamp(xb / scale, -fmt.maxval, fmt.maxval), fmt) * scale
    return unblock(y).to(x.dtype)


def is_per_token_int8(spec: QuantizerSpec) -> bool:
    return bool(not spec.is_fp and spec.num_bits == 8 and spec.block is not None
                and spec.block.dynamic and not spec.block.two_level
                and tuple(spec.block.sizes) == ((-1, 0),))


def is_two_level_fp(spec: QuantizerSpec) -> bool:
    """NVFP4's block spec: dynamic two-level blocks of fp elements with
    e4m3 (non-e8m0) block scales, no 4/6 choice."""
    b = spec.block
    return bool(spec.is_fp and b is not None and b.dynamic and b.two_level
                and b.scale_format not in (None, "e8m0") and not b.four_over_six)


def fake_quantize(x: torch.Tensor, spec: QuantizerSpec, amax=None,
                  tensor_amax=None) -> torch.Tensor:
    """Fake-quantize ``x`` per ``spec``; ``amax`` is the calibrated amax for
    static specs (None = from this call's values), ``tensor_amax`` the
    calibrated per-tensor amax of a two-level block spec. ``spec.rotate``
    is the caller's: TensorQuantizer rotates x around this call, as in the
    reference."""
    if not spec.enable:
        return x
    if spec.bias_mode is not None:
        raise NotImplementedError(f"fake quantization of {spec} is not ported")
    if spec.block is not None:
        if is_per_token_int8(spec):
            return fake_quant_int8_per_token(x, spec)
        if is_two_level_fp(spec):
            return fake_quant_block_two_level(x, spec, tensor_amax)
        if (not spec.is_fp and spec.block.dynamic and not spec.block.two_level
                and spec.block.scale_format is None and not spec.block.four_over_six):
            return fake_quant_block_int(x, spec)
        raise NotImplementedError(f"block fake quantization of {spec} is not ported")
    if spec.axis is not None and spec.is_fp:
        raise NotImplementedError("per-channel fp fake quantization is not ported")
    if amax is None:
        amax = reduce_amax(x, spec.axis).float()
    if spec.is_fp:
        return fake_quant_fp(x, amax, spec.fp_format)
    return fake_quant_int(x, amax, spec.num_bits, spec.unsigned, spec.narrow_range)
