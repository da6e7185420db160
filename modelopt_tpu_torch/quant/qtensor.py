"""Packed (real-quant) weight storage and (de)quantization.

Port of the int4, int8, fp8 and NVFP4 parts of
``modelopt_tpu/quant/qtensor.py``. A packed weight is a dict of tensors
whose format follows from its QuantizerSpec. Every layout is bit-identical
to the reference's, so a packed weight from either package feeds the other:

  * INT4: uint8 [K/2, N], split-half and HYBRID — the low nibble of row p
    holds weight row p as offset-binary q+8, the high nibble holds row
    K/2+p in two's complement; f32 scales [K/block, N].
  * INT8: int8 [K, N] with per-out-channel f32 scales [1, N].
  * FP8: e4m3 [K, N] with one f32 scale [1, 1].
  * NVFP4: uint8 [K/2, N] split-half e2m1 sign-magnitude codes (low
    nibble row p, high nibble row K/2+p), e4m3 block-16 scales [K/16, N]
    and one f32 ``scale2`` [1, 1]: w ~ e2m1 * scale * scale2.

Scales are the dequantization multipliers (w ~ code * scale), each a true
quotient (``formats.true_divide``), so the card packs the CPU's bits.

MoE expert kernels [E, in, out] pack as their FOLDED view [in, E*out]
(``fold_experts``, the reference's quant/compress.py:37-49): expert e is
columns e*out:(e+1)*out, in-dim scale blocks map one to one, and each
expert's scales fall out of its own columns. Specs with a positive
(explicit per-expert) axis do not fold (``spec_folds``).
"""

from __future__ import annotations

import torch

from .formats import true_divide
from .qspec import QuantizerSpec


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q int in [-8, 7], shape [K, N], K even -> uint8 [K/2, N] hybrid
    split-half nibbles."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"pack_int4: K={K} must be even")
    q = q.to(torch.int32)
    lo = (q[: K // 2] + 8).to(torch.uint8)
    hi = (q[K // 2:] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [K/2, N] -> int32 [K, N] in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = ((packed >> 4).to(torch.int32) ^ 8) - 8  # two's-complement nibble
    return torch.cat([lo, hi], dim=0)


def quantize_int4(w: torch.Tensor, block: int = 128) -> dict:
    """w [K, N] -> {'data': uint8 [K/2, N], 'scale': f32 [K/block, N]};
    symmetric [-7, 7] grid per (input block, out channel)."""
    K, N = w.shape
    if K % 2 or K % block:
        raise ValueError(f"quantize_int4: K={K} must be even and a multiple of {block}")
    wb = w.float().reshape(K // block, block, N)
    amax = wb.abs().amax(dim=1, keepdim=True)
    scale = true_divide(amax.clamp_min(1e-12), 7.0)
    q = torch.clamp(torch.round(wb / scale), -8, 7).to(torch.int32).reshape(K, N)
    return {"data": pack_int4(q), "scale": scale[:, 0, :]}


def dequantize_int4(qt: dict, block: int = 128) -> torch.Tensor:
    q = unpack_int4(qt["data"]).float()
    K, N = q.shape
    return (q.reshape(K // block, block, N) * qt["scale"][:, None, :]).reshape(K, N)


def quantize_int8(w: torch.Tensor) -> dict:
    """w [K, N] -> {'data': int8 [K, N], 'scale': f32 [1, N]} per out channel."""
    wf = w.float()
    scale = true_divide(wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-12), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"data": q, "scale": scale}


def dequantize_int8(qt: dict) -> torch.Tensor:
    return qt["data"].float() * qt["scale"]


def quantize_fp8(w: torch.Tensor) -> dict:
    """w [K, N] -> {'data': e4m3 [K, N], 'scale': f32 [1, 1]}: one scale
    max(|w|, 1e-12)/448, codes cast with round half to even."""
    wf = w.float()
    scale = true_divide(wf.abs().amax().clamp_min(1e-12), 448.0)
    data = torch.clamp(wf / scale, -448.0, 448.0).to(torch.float8_e4m3fn)
    return {"data": data, "scale": scale.reshape(1, 1)}


def dequantize_fp8(qt: dict) -> torch.Tensor:
    return qt["data"].float() * qt["scale"]


E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def _encode_e2m1(x: torch.Tensor) -> torch.Tensor:
    """x already scaled into [-6, 6] -> uint8 codes 0..15 (bit 3 the sign):
    the nearest e2m1 magnitude, an exact midpoint rounding down (the
    reference's ``sum(|x| > midpoints)``, here one bucketize: no
    [..., 7] boolean transient)."""
    table = torch.tensor(E2M1_VALUES, dtype=torch.float32, device=x.device)
    mids = (table[:-1] + table[1:]) / 2.0
    idx = torch.bucketize(x.abs(), mids, out_int32=True)
    return (idx + 8 * (x < 0).to(torch.int32)).to(torch.uint8)


def _decode_e2m1(codes: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(E2M1_VALUES, dtype=torch.float32, device=codes.device)
    mag = table[(codes & 7).long()]
    return torch.where((codes & 8) > 0, -mag, mag)


def quantize_nvfp4(w: torch.Tensor, block: int = 16) -> dict:
    """w [K, N] -> {'data': uint8 [K/2, N] split-half e2m1 codes,
    'scale': e4m3 [K/block, N], 'scale2': f32 [1, 1]}: scale2 =
    max(|w|, 1e-12)/(6*448), each block's scale max(amax, 1e-12)/6/scale2
    cast to e4m3, codes of w / max(scale*scale2, 1e-20) clipped to +-6."""
    K, N = w.shape
    wf = w.float()
    wb = wf.reshape(K // block, block, N)
    bamax = wb.abs().amax(dim=1, keepdim=True)
    scale2 = true_divide(wf.abs().amax().clamp_min(1e-12), 6.0 * 448.0)
    s1 = torch.clamp(true_divide(bamax.clamp_min(1e-12), 6.0) / scale2, -448.0, 448.0) \
        .to(torch.float8_e4m3fn)
    eff = (s1.float() * scale2).clamp_min(1e-20)
    codes = _encode_e2m1(torch.clamp(wb / eff, -6.0, 6.0)).reshape(K, N)
    return {"data": codes[:K // 2] | (codes[K // 2:] << 4),
            "scale": s1[:, 0, :],
            "scale2": scale2.reshape(1, 1)}


def dequantize_nvfp4(qt: dict, block: int = 16) -> torch.Tensor:
    packed = qt["data"]
    vals = torch.cat([_decode_e2m1(packed & 0xF), _decode_e2m1(packed >> 4)], dim=0)
    K, N = vals.shape
    scale = qt["scale"].float() * qt["scale2"]
    return (vals.reshape(K // block, block, N) * scale[:, None, :]).reshape(K, N)


def spec_folds(spec: QuantizerSpec) -> bool:
    """Whether a 3-D expert kernel under ``spec`` packs through the folded
    view: no axis or block axis counted from the front."""
    axes = tuple(spec.axis or ())
    if spec.block is not None:
        axes = axes + tuple(int(a) for a, _ in spec.block.sizes)
    return not any(a >= 0 for a in axes)


def fold_experts(kernel: torch.Tensor) -> torch.Tensor:
    """[E, in, out] -> [in, E*out]."""
    E, fin, fout = kernel.shape
    return kernel.transpose(0, 1).reshape(fin, E * fout)


def unfold_experts(w2d: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[in, E*out] -> [E, in, out], the inverse of ``fold_experts``."""
    fin = w2d.shape[0]
    return w2d.reshape(fin, n_experts, -1).transpose(0, 1)


def compressible_format(spec: QuantizerSpec, shape):
    """Which packed format this spec + 2-D weight shape maps to: "int4",
    "int8", "fp8", "nvfp4", or None (formats the port does not pack yet,
    mxfp4, mxfp8 and nf4, also give None)."""
    if len(shape) != 2:
        return None
    K, _ = shape
    if spec.is_fp:
        fmt = spec.fp_format
        if (fmt.exp_bits, fmt.man_bits) == (4, 3) and spec.block is None:
            return "fp8"
        if ((fmt.exp_bits, fmt.man_bits) == (2, 1) and spec.block is not None
                and spec.block.scale_format != "e8m0"):
            b = block_of(spec, None) or dict(spec.block.sizes).get(-1)
            if b and K % b == 0 and K % 2 == 0 and (K // 2) % b == 0:
                return "nvfp4"
        return None
    if spec.num_bits == 8 and spec.axis is not None:
        return "int8"
    if spec.num_bits == 4 and spec.block is not None and spec.variant is None:
        bs = dict(spec.block.sizes)
        b = bs.get(0, bs.get(-2)) or bs.get(-1)
        if b and K % b == 0 and K % 2 == 0:
            return "int4"
    return None


def block_of(spec: QuantizerSpec, default: int = 128) -> int:
    bs = dict(spec.block.sizes) if spec.block else {}
    return bs.get(0, bs.get(-2, default))


def quantize_qtensor(w: torch.Tensor, spec: QuantizerSpec):
    fmt = compressible_format(spec, tuple(w.shape))
    if fmt == "int4":
        return quantize_int4(w, block_of(spec)), fmt
    if fmt == "int8":
        return quantize_int8(w), fmt
    if fmt == "fp8":
        return quantize_fp8(w), fmt
    if fmt == "nvfp4":
        return quantize_nvfp4(w, block_of(spec, 16)), fmt
    raise NotImplementedError(f"spec {spec} has no packed format in the port for {tuple(w.shape)}")


def dequantize_qtensor(qt: dict, spec: QuantizerSpec, shape) -> torch.Tensor:
    fmt = compressible_format(spec, tuple(shape))
    if fmt == "int4":
        return dequantize_int4(qt, block_of(spec))
    if fmt == "int8":
        return dequantize_int8(qt)
    if fmt == "fp8":
        return dequantize_fp8(qt)
    if fmt == "nvfp4":
        return dequantize_nvfp4(qt, block_of(spec, 16))
    raise NotImplementedError(f"spec {spec} has no packed format in the port")
