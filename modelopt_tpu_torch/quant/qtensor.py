"""Packed (real-quant) weight storage and (de)quantization.

Port of the int4 and int8 parts of ``modelopt_tpu/quant/qtensor.py``. A
packed weight is a dict of tensors whose format follows from its
QuantizerSpec. The int4 layout is bit-identical to the reference's, so a
packed weight from either package feeds the other:

  * INT4: uint8 [K/2, N], split-half and HYBRID — the low nibble of row p
    holds weight row p as offset-binary q+8, the high nibble holds row
    K/2+p in two's complement; f32 scales [K/block, N].
  * INT8: int8 [K, N] with per-out-channel f32 scales [1, N].

Scales are the dequantization multipliers (w ~ code * scale).

MoE expert kernels [E, in, out] pack as their FOLDED view [in, E*out]
(``fold_experts``, the reference's quant/compress.py:37-49): expert e is
columns e*out:(e+1)*out, in-dim scale blocks map one to one, and each
expert's scales fall out of its own columns. Specs with a positive
(explicit per-expert) axis do not fold (``spec_folds``).
"""

from __future__ import annotations

import torch

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
    scale = amax.clamp_min(1e-12) / 7.0
    q = torch.clamp(torch.round(wb / scale), -8, 7).to(torch.int32).reshape(K, N)
    return {"data": pack_int4(q), "scale": scale[:, 0, :]}


def dequantize_int4(qt: dict, block: int = 128) -> torch.Tensor:
    q = unpack_int4(qt["data"]).float()
    K, N = q.shape
    return (q.reshape(K // block, block, N) * qt["scale"][:, None, :]).reshape(K, N)


def quantize_int8(w: torch.Tensor) -> dict:
    """w [K, N] -> {'data': int8 [K, N], 'scale': f32 [1, N]} per out channel."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"data": q, "scale": scale}


def dequantize_int8(qt: dict) -> torch.Tensor:
    return qt["data"].float() * qt["scale"]


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
    "int8", or None (formats the port does not pack yet also give None)."""
    if len(shape) != 2 or spec.is_fp:
        return None
    K, _ = shape
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
    raise NotImplementedError(f"spec {spec} has no packed format in the port for {tuple(w.shape)}")


def dequantize_qtensor(qt: dict, spec: QuantizerSpec, shape) -> torch.Tensor:
    fmt = compressible_format(spec, tuple(shape))
    if fmt == "int4":
        return dequantize_int4(qt, block_of(spec))
    if fmt == "int8":
        return dequantize_int8(qt)
    raise NotImplementedError(f"spec {spec} has no packed format in the port")
