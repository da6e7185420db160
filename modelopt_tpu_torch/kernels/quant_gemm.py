"""Int4-weight GEMMs: W4A8, W4A16 and their grouped (per-expert) forms.

Counterparts of ``modelopt_tpu/kernels/quant_gemm.py``: ``w4a8_gemm`` (K1),
``w4a16_gemm`` (K6), ``grouped_w4a16_gemm`` (K10) and
``grouped_w4a8_combine_gemm`` (K12). On a CUDA tensor each wrapper launches
its hand-written kernel (``csrc/w4a8_gemm.cu``, ``csrc/w4a16_gemm.cu``,
``csrc/grouped_w4a8_gemm.cu``) or raises; on a CPU tensor it computes the
same function with its ``*_plain`` twin, which also serves as the card's
oracle.

Packed layout (quant/qtensor.py): uint8 [K/2, N] hybrid split-half nibbles,
f32 scales [K/block, N] — rows [0, K/(2*block)) scale the low half. When
K/2 is not a whole number of blocks (K=1408: the straddle layout) scale row
K/2 // block covers the low half's tail and the high half's head, and the
high half's blocks follow it. The grouped kernels take the folded expert
layout [K/2, E*N] (expert e is columns e*N:(e+1)*N,
quant/qtensor.py::fold_experts). Every twin computes straddle shapes; of
the CUDA kernels K12 takes them, K1, K6 and K10 refuse them.
"""

from __future__ import annotations

import torch

from . import _build

# above this M the result leaves the kernel in ``out_dtype`` (prefill);
# at or below it in f32 (decode) — quant/backends.py:134 of the reference.
# Also the largest M the grouped kernels serve (backends.py:183).
PREFILL_MIN_M = 256


def _block_dots(xf: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                block: int, n_per_expert=None) -> torch.Tensor:
    """f32 ``xf [..., M, K] @ W`` with the kernels' rounding points: one
    product per scale block, its scale on the f32 accumulator
    (``acc + d*s``), block by block in the reference's order
    (``_w4a8_body`` / ``_w4a16_body``). When K/2 % block == 0 each block's
    halves go together, ``acc + d_lo*s_lo + d_hi*s_hi``. Otherwise (straddle
    shapes, K=1408: ``rem = K/2 % block``) every low-half block comes first,
    then the block straddling the half boundary (the low-nibble tail of
    packed rows [nfull*block, K/2) plus the high-nibble head of packed rows
    [0, rem), summed before its one scale row ``nfull``), then the high-half
    blocks at packed rows rem + b*block with scale rows nfull+1+b.
    ``n_per_expert``: W is the folded [K/2, E*N] layout and xf [E, M, K];
    returns [E, M, N]."""
    K2 = packed.shape[0]
    nfull, rem = divmod(K2, block)
    p = packed.to(torch.int32)
    qlo = ((p & 0xF) - 8).float()
    qhi = (((p >> 4) ^ 8) - 8).float()
    sc = scale
    if n_per_expert is not None:
        E = packed.shape[1] // n_per_expert
        qlo, qhi, sc = (a.reshape(a.shape[0], E, n_per_expert).transpose(0, 1)
                        for a in (qlo, qhi, scale))
    acc = torch.zeros(*xf.shape[:-1], qlo.shape[-1], dtype=torch.float32,
                      device=xf.device)

    def lo(r0, n):
        return xf[..., r0:r0 + n] @ qlo[..., r0:r0 + n, :]

    def hi(r0, n):
        return xf[..., K2 + r0:K2 + r0 + n] @ qhi[..., r0:r0 + n, :]

    if rem == 0:
        for b in range(nfull):
            acc = acc + lo(b * block, block) * sc[..., b:b + 1, :]
            acc = acc + hi(b * block, block) * sc[..., nfull + b:nfull + b + 1, :]
        return acc
    for b in range(nfull):
        acc = acc + lo(b * block, block) * sc[..., b:b + 1, :]
    acc = acc + (lo(nfull * block, rem) + hi(0, rem)) * sc[..., nfull:nfull + 1, :]
    for b in range(nfull):
        r = nfull + 1 + b
        acc = acc + hi(rem + b * block, block) * sc[..., r:r + 1, :]
    return acc


def _check_packed(name, packed, scale, block, K, EN):
    K2 = packed.shape[0]
    if K != 2 * K2 or tuple(scale.shape) != (K // block, EN) or packed.shape[1] != EN:
        raise ValueError(f"{name}: shapes K={K}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")


def _check_card(name, packed, scale, block, N, n_mult, straddle=False):
    """What the CUDA kernels take: block-128 weights, N a multiple of
    ``n_mult``; straddle shapes (K/2 % 128 == 64) only where ``straddle``."""
    if block != 128 or (packed.shape[0] % block and not straddle) or packed.shape[0] % 64:
        raise NotImplementedError(
            f"the CUDA {name} takes block-128 weights with K/2 % 128 == 0; "
            "straddle shapes (K=1408, 2880) are not ported to it yet")
    if N % n_mult:
        raise ValueError(f"{name}: N={N} must be a multiple of {n_mult}")
    if (packed.dtype, scale.dtype) != (torch.uint8, torch.float32):
        raise ValueError(f"{name}: wants uint8 packed, f32 scale")


# ---------------------------------------------------------------------------
# K1: W4A8
# ---------------------------------------------------------------------------
def w4a8_gemm_plain(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    block: int = 128, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch W4A8 with the kernel's rounding points: exact integer
    dots per scale block (f32 holds them exactly: |sum| < 2^24), then
    ``acc + qlo*s_lo`` and ``+ qhi*s_hi`` in f32, block by block."""
    return _block_dots(xq.float(), packed, scale, block).to(out_dtype)


def w4a8_gemm(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              block: int = 128, out_dtype=torch.float32) -> torch.Tensor:
    """xq int8 [M, K] @ int4-packed W -> [M, N] (the caller applies the
    per-token activation scales). For M <= 256 the product is f32 and then
    cast to ``out_dtype``; above, the kernel writes ``out_dtype`` itself."""
    M, K = xq.shape
    K2, N = packed.shape
    _check_packed("w4a8_gemm", packed, scale, block, K, N)
    acc_dtype = out_dtype if M > PREFILL_MIN_M else torch.float32
    if xq.device.type == "cpu":
        return w4a8_gemm_plain(xq, packed, scale, block, acc_dtype).to(out_dtype)
    _check_card("w4a8_gemm", packed, scale, block, N, 64)
    if xq.dtype != torch.int8:
        raise ValueError("w4a8_gemm: wants int8 x")
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


# ---------------------------------------------------------------------------
# K6 / K10: W4A16 and its grouped form
# ---------------------------------------------------------------------------
def w4a16_gemm_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                     block: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch W4A16 with the kernel's rounding points: x rounded to
    bf16 (the reference's ``astype(bf16)``), the widened nibbles exact, an
    f32 product per scale block and half, the scale on the f32 accumulator
    (``acc + d*s``), then ``out_dtype``."""
    return _block_dots(x.to(torch.bfloat16).float(), packed, scale, block).to(out_dtype)


def grouped_w4a16_gemm_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                             n_per_expert: int, block: int = 128,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert ``w4a16_gemm_plain``: x [E, M, K] on the folded layout ->
    [E, M, N]."""
    return _block_dots(x.to(torch.bfloat16).float(), packed, scale, block,
                       n_per_expert).to(out_dtype)


def _w4a16_launch(name, x3, packed, scale, n, block, out_dtype, grouped):
    E, M, K = x3.shape
    _check_card(name, packed, scale, block, n, 64)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported")
    x3 = x3.to(torch.bfloat16).contiguous()
    _build.check_cuda(name, x3, packed, scale)
    if x3.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    out = torch.empty(E, M, n, dtype=out_dtype, device=x3.device)
    f32 = out_dtype == torch.float32
    args = [x3.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            out.data_ptr() if f32 else None, None if f32 else out.data_ptr()]
    ints = [E, M, n, packed.shape[0]] if grouped else [M, n, packed.shape[0]]
    fn = _build.function(name, [_build.c_ptr] * 5 + [_build.c_int] * len(ints)
                         + [_build.c_ptr], source="w4a16_gemm")
    with torch.cuda.device(x3.device):
        err = fn(*args, *ints, _build.stream(x3))
    return out, err


def w4a16_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               block: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [M, K] (rounded to bf16) @ int4-packed W -> [M, N] in ``out_dtype``
    (f32 or bf16), every M: 16-row tiles up to M = 16, 64-row tiles above."""
    M, K = x.shape
    N = packed.shape[1]
    _check_packed("w4a16_gemm", packed, scale, block, K, N)
    if x.device.type == "cpu":
        return w4a16_gemm_plain(x, packed, scale, block, out_dtype)
    out, err = _w4a16_launch("w4a16_gemm", x[None], packed, scale, N, block,
                             out_dtype, grouped=False)
    w4a16_gemm.launches += 1
    _build.raise_on_error("w4a16_gemm", err)
    return out[0]


w4a16_gemm.launches = 0


def grouped_w4a16_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       n_per_expert: int, block: int = 128,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert GEMMs ``y[e] = x[e] @ W_e`` in one launch: x [E, M, K]
    (rounded to bf16), packed/scale the folded [K/2, E*N] layout ->
    [E, M, N] in ``out_dtype``."""
    E, M, K = x.shape
    _check_packed("grouped_w4a16_gemm", packed, scale, block, K, E * n_per_expert)
    if x.device.type == "cpu":
        return grouped_w4a16_gemm_plain(x, packed, scale, n_per_expert, block, out_dtype)
    out, err = _w4a16_launch("grouped_w4a16_gemm", x, packed, scale, n_per_expert,
                             block, out_dtype, grouped=True)
    grouped_w4a16_gemm.launches += 1
    _build.raise_on_error("grouped_w4a16_gemm", err)
    return out


grouped_w4a16_gemm.launches = 0


# ---------------------------------------------------------------------------
# K12: grouped W4A8 fused with the routed combine
# ---------------------------------------------------------------------------
def grouped_w4a8_combine_gemm_plain(xq: torch.Tensor, gscale: torch.Tensor,
                                    packed: torch.Tensor, scale: torch.Tensor,
                                    n_per_expert: int, block: int = 128) -> torch.Tensor:
    """Plain PyTorch fused combine with the kernel's rounding points: each
    expert's W4A8 product exactly as ``w4a8_gemm_plain``, its gated term
    ``acc_e * gscale[e]`` rounded, then ``out = out + term`` for
    e = 0..E-1 in order, in f32."""
    y = _block_dots(xq.float(), packed, scale, block, n_per_expert)  # [E, M, N]
    out = torch.zeros(y.shape[1:], dtype=torch.float32, device=y.device)
    for e in range(y.shape[0]):
        out = out + y[e] * gscale[e][:, None]
    return out


def grouped_w4a8_combine_gemm(xq: torch.Tensor, gscale: torch.Tensor,
                              packed: torch.Tensor, scale: torch.Tensor,
                              n_per_expert: int, block: int = 128) -> torch.Tensor:
    """``out[m] = sum_e gscale[e, m] * (xq[e, m] @ W_e)``: xq int8 [E, M, K],
    gscale f32 [E, M] (routing gate x per-row activation scale),
    packed/scale the folded layout -> f32 [M, N]."""
    E, M, K = xq.shape
    N = n_per_expert
    _check_packed("grouped_w4a8_combine_gemm", packed, scale, block, K, E * N)
    if tuple(gscale.shape) != (E, M):
        raise ValueError(f"grouped_w4a8_combine_gemm: gscale {tuple(gscale.shape)}, "
                         f"want {(E, M)}")
    if xq.device.type == "cpu":
        return grouped_w4a8_combine_gemm_plain(xq, gscale, packed, scale, N, block)
    _check_card("grouped_w4a8_combine_gemm", packed, scale, block, N, 16, straddle=True)
    if (xq.dtype, gscale.dtype) != (torch.int8, torch.float32):
        raise ValueError("grouped_w4a8_combine_gemm: wants int8 x, f32 gscale")
    _build.check_cuda("grouped_w4a8_combine_gemm", xq, gscale, packed, scale)
    if xq.data_ptr() % 16:
        raise ValueError("grouped_w4a8_combine_gemm: x must be 16-byte aligned")
    fn = _build.function("grouped_w4a8_combine_gemm",
                         [_build.c_ptr] * 5 + [_build.c_int] * 4 + [_build.c_ptr],
                         source="grouped_w4a8_gemm")
    out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), gscale.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), E, M, N, packed.shape[0], _build.stream(xq))
    grouped_w4a8_combine_gemm.launches += 1
    _build.raise_on_error("grouped_w4a8_combine_gemm", err)
    return out


grouped_w4a8_combine_gemm.launches = 0
