"""W4A8 GEMM: int8 activations x int4 block-quantized weights.

Counterpart of ``modelopt_tpu/kernels/quant_gemm.py::w4a8_gemm``. On a CUDA
tensor ``w4a8_gemm`` launches the hand-written kernel in
``csrc/w4a8_gemm.cu``; on a CPU tensor it computes the same function with
``w4a8_gemm_plain``, which also serves as the card's oracle.

Packed layout (quant/qtensor.py): uint8 [K/2, N] hybrid split-half nibbles,
f32 scales [K/block, N] — rows [0, K/(2*block)) scale the low half.
"""

from __future__ import annotations

import torch

from . import _build

# above this M the result leaves the kernel in ``out_dtype`` (prefill);
# at or below it in f32 (decode) — quant/backends.py:134 of the reference
PREFILL_MIN_M = 256


def w4a8_gemm_plain(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    block: int = 128, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch W4A8 with the kernel's rounding points: exact integer
    dots per scale block (f32 holds them exactly: |sum| < 2^24), then
    ``acc + qlo*s_lo`` and ``+ qhi*s_hi`` in f32, block by block."""
    K2, N = packed.shape
    if K2 % block:
        raise NotImplementedError(
            "scale blocks straddling the split-half boundary (K/2 % block != 0) "
            "are not ported yet")
    nblk = K2 // block
    p = packed.to(torch.int32)
    qlo = ((p & 0xF) - 8).float()
    qhi = (((p >> 4) ^ 8) - 8).float()
    xf = xq.float()
    acc = torch.zeros(xq.shape[0], N, dtype=torch.float32, device=xq.device)
    for b in range(nblk):
        rows = slice(b * block, (b + 1) * block)
        dlo = xf[:, rows] @ qlo[rows]
        dhi = xf[:, K2 + b * block:K2 + (b + 1) * block] @ qhi[rows]
        acc = acc + dlo * scale[b]
        acc = acc + dhi * scale[nblk + b]
    return acc.to(out_dtype)


def w4a8_gemm(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              block: int = 128, out_dtype=torch.float32) -> torch.Tensor:
    """xq int8 [M, K] @ int4-packed W -> [M, N] (the caller applies the
    per-token activation scales). For M <= 256 the product is f32 and then
    cast to ``out_dtype``; above, the kernel writes ``out_dtype`` itself."""
    M, K = xq.shape
    K2, N = packed.shape
    if K != 2 * K2 or tuple(scale.shape) != (K // block, N):
        raise ValueError(f"w4a8_gemm: shapes x {tuple(xq.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}")
    acc_dtype = out_dtype if M > PREFILL_MIN_M else torch.float32
    if xq.device.type == "cpu":
        return w4a8_gemm_plain(xq, packed, scale, block, acc_dtype).to(out_dtype)
    if block != 128 or K2 % block:
        raise NotImplementedError(
            "the CUDA w4a8_gemm takes block-128 weights with K/2 % 128 == 0; "
            "straddle shapes (K=1408, 2880) are not ported yet")
    if N % 64:
        raise ValueError(f"w4a8_gemm: N={N} must be a multiple of 64")
    if (xq.dtype, packed.dtype, scale.dtype) != (torch.int8, torch.uint8, torch.float32):
        raise ValueError("w4a8_gemm: wants int8 x, uint8 packed, f32 scale")
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w4a8_gemm: out_dtype {out_dtype} not supported")
    _build.check_cuda("w4a8_gemm", xq, packed, scale)
    if xq.data_ptr() % 16:
        raise ValueError("w4a8_gemm: x must be 16-byte aligned")
    fn = _build.function("w4a8_gemm", [_build.c_ptr] * 5 + [_build.c_int] * 3
                         + [_build.c_ptr])
    out = torch.empty(M, N, dtype=acc_dtype, device=xq.device)
    f32 = acc_dtype == torch.float32
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr() if f32 else None,
                 None if f32 else out.data_ptr(), M, N, K2, _build.stream(xq))
    w4a8_gemm.launches += 1
    _build.raise_on_error("w4a8_gemm", err)
    return out.to(out_dtype)


w4a8_gemm.launches = 0
