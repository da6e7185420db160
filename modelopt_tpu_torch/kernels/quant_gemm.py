"""Quantized-weight GEMMs: int4 (W4A8, W4A16 and their grouped forms),
int8, e4m3 and NVFP4.

Counterparts of ``modelopt_tpu/kernels/quant_gemm.py``: ``w4a8_gemm`` (K1),
``w4a16_gemm`` (K6), ``w8a16_gemm`` (K7), ``wfp8_gemm`` (K8),
``nvfp4_gemm`` (K9), ``grouped_w4a16_gemm`` (K10), ``grouped_w4a8_gemm``
(K11), ``grouped_w4a8_combine_gemm`` (K12) and ``grouped_nvfp4_gemm``
(K13). On a
CUDA tensor each wrapper launches its hand-written kernel
(``csrc/w4a8_gemm.cu``, ``csrc/w4a16_gemm.cu``, ``csrc/grouped_w4a8_gemm.cu``,
``csrc/w8a16_gemm.cu``, ``csrc/nvfp4_gemm.cu``) or raises; on a CPU tensor
it computes the same function with its ``*_plain`` twin, which also serves
as the card's oracle.

Packed layout (quant/qtensor.py): uint8 [K/2, N] hybrid split-half nibbles,
f32 scales [K/block, N] — rows [0, K/(2*block)) scale the low half. When
K/2 is not a whole number of blocks (K=1408: the straddle layout) scale row
K/2 // block covers the low half's tail and the high half's head, and the
high half's blocks follow it. The grouped kernels take the folded expert
layout [K/2, E*N] (expert e is columns e*N:(e+1)*N,
quant/qtensor.py::fold_experts). Every twin computes straddle shapes; of
the CUDA kernels K6, K10, K11 and K12 take them (K/2 % 128 == 64), K1
refuses them. The NVFP4 kernels (K9, K13) take K/2 % 64 == 0: whole
128-row packed blocks and at most one 64-row tail.
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
    if block != 128 or packed.shape[0] % (64 if straddle else block):
        raise NotImplementedError(
            f"the CUDA {name} takes block-128 weights with K/2 % "
            f"{'64' if straddle else '128'} == 0, got block {block}, K/2 = {packed.shape[0]}"
            + ("" if straddle else "; straddle shapes (K=1408, 2880) are not ported to it yet"))
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
    cast to ``out_dtype``; above, the kernel writes ``out_dtype`` itself.
    One launch: up to M = 8 the mma.sync decode tile (the 128-row blocks
    split over a cluster of ``_w4a8_ranks`` CTAs that replays the f32 block
    recurrence in order), above it the wgmma tile."""
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
    if xq.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w4a8_gemm: x, packed and scale must be 16-byte aligned")
    fn = _build.function("w4a8_gemm", [_build.c_ptr] * 5 + [_build.c_int] * 4
                         + [_build.c_ptr])
    out = torch.empty(M, N, dtype=acc_dtype, device=xq.device)
    f32 = acc_dtype == torch.float32
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr() if f32 else None,
                 None if f32 else out.data_ptr(), M, N, K2, _w4a8_ranks(M, N, K2),
                 _build.stream(xq))
    w4a8_gemm.launches += 1
    _build.raise_on_error("w4a8_gemm", err)
    return out.to(out_dtype)


w4a8_gemm.launches = 0


# K1's decode tile (csrc/w4a8_gemm.cu, dec::smem_bytes): a ring of 4
# half-block stages (the raw packed [64, 128] tile, x's two halves, a
# block's scale rows: 40 KB) and, where a cluster of R > 1 splits the
# blocks, each of a rank's blocks but its last W4A8_REG_BLOCKS (which wait
# in local memory, then in the ring) held for the in-order f32 replay (its
# rounded products [2][8][128] f32: 8 KB) and the replay's table (4 bytes a
# block), within the 227 KB a CTA may use
W4A8_RING_BYTES = 4 * (8192 + 1024 + 1024)
W4A8_HELD_BYTES = 8192
W4A8_REG_BLOCKS = 4
SMEM_LIMIT = 227 * 1024


def _w4a8_smem(blocks: int, r: int) -> int:
    """Shared memory of a K1 decode-tile CTA whose cluster of ``r`` splits
    ``blocks`` 128-row blocks."""
    if r == 1:
        return W4A8_RING_BYTES
    held = max(-(-blocks // r) - W4A8_REG_BLOCKS, 0)
    return W4A8_RING_BYTES + held * W4A8_HELD_BYTES + 4 * blocks


def _w4a8_ranks(M, N, K2) -> int:
    """Cluster size of K1's decode tile (M <= 8; 1 above, where the wgmma
    tile takes no R): the largest of 1, 2, 4, 8 that keeps the 128-column
    tiles x R within BYTE_TARGET_CTAS (the tile only draws weight bytes, as
    K7 / K8's decode tile), each rank at least one 128-row block, and a
    rank's held blocks and the ring within a CTA's shared memory."""
    if M > 8:
        return 1
    tiles, blocks = -(-N // 128), K2 // 128
    best = 1
    for r in (2, 4, 8):
        if r <= blocks and r * tiles <= BYTE_TARGET_CTAS and _w4a8_smem(blocks, r) <= SMEM_LIMIT:
            best = r
    return best


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


# CTAs a cluster split of K aims for: one on each of the H100's 132 SMs. A
# rank costs a fixed prologue and the cluster's barriers and partial sums,
# which pay only while SMs would otherwise idle (on the card both the
# W4A16 decode tile and the NVFP4 wgmma tile ran N = 4096 faster at ~128
# CTAs than at 256-512; PERF.md)
CLUSTER_TARGET_CTAS = 132


def _cluster_ranks(tiles: int, blocks: int, target: int = CLUSTER_TARGET_CTAS) -> int:
    """CTAs of one thread-block cluster that share an output tile, each
    walking a contiguous run of the ``blocks`` 128-row blocks, their
    partials summed in the same launch: the largest of 1, 2, 4, 8 that
    keeps ``tiles`` x R within ``target`` CTAs and R at most ``blocks``."""
    r = 1
    while r < 8 and 2 * r <= blocks and 2 * r * tiles <= target:
        r *= 2
    return r


def _w4a16_stages(K2) -> int:
    """The f32 updates of a W4A16 product's block recurrence: one a 128-row
    block (both halves) where K/2 % 128 == 0; else (straddle K) the
    reference's 2 nfull + 1, each low-half block, the straddle block and
    each high-half block on its own (``_block_dots``)."""
    return K2 // 128 if K2 % 128 == 0 else 2 * (K2 // 128) + 1


def _w4a16_ranks(E, M, N, K2) -> int:
    """Cluster size of a W4A16 product: up to M = 16 the decode tile's
    (one 64-column tile per cluster, E * N / 64 tiles, each rank a
    contiguous run of the stages); 1 above."""
    return _cluster_ranks(E * (N // 64), _w4a16_stages(K2)) if M <= 16 else 1


def _w4a16_launch(name, x3, packed, scale, n, block, out_dtype, grouped):
    E, M, K = x3.shape
    _check_card(name, packed, scale, block, n, 64, straddle=True)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported")
    x3 = x3.to(torch.bfloat16).contiguous()
    _build.check_cuda(name, x3, packed, scale)
    if x3.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{name}: x, packed and scale must be 16-byte aligned")
    out = torch.empty(E, M, n, dtype=out_dtype, device=x3.device)
    f32 = out_dtype == torch.float32
    args = [x3.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            out.data_ptr() if f32 else None, None if f32 else out.data_ptr()]
    K2 = packed.shape[0]
    ints = ([E, M, n, K2] if grouped else [M, n, K2]) + [_w4a16_ranks(E, M, n, K2)]
    fn = _build.function(name, [_build.c_ptr] * 5 + [_build.c_int] * len(ints)
                         + [_build.c_ptr], source="w4a16_gemm")
    with torch.cuda.device(x3.device):
        err = fn(*args, *ints, _build.stream(x3))
    return out, err


def w4a16_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               block: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [M, K] (rounded to bf16) @ int4-packed W -> [M, N] in ``out_dtype``
    (f32 or bf16), every M: up to M = 16 the mma.sync decode tile (64
    weight columns, the stages of the block recurrence split over a cluster
    of ``_w4a16_ranks`` CTAs), above it the wgmma tile (128 weight columns x
    64 or 128 tokens). One launch either way; straddle K (K/2 % 128 == 64)
    included."""
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
# K11: grouped W4A8, one product per expert
# ---------------------------------------------------------------------------
# columns a CTA of K12 and of K11 (csrc/grouped_w4a8_gemm.cu)
GROUPED_BN = 128

def grouped_w4a8_gemm_plain(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                            n_per_expert: int, block: int = 128) -> torch.Tensor:
    """Per-expert ``w4a8_gemm_plain``: xq int8 [E, M, K] on the folded
    layout -> f32 [E, M, N], each expert's exact integer dots and f32 block
    updates in the reference's order."""
    return _block_dots(xq.float(), packed, scale, block, n_per_expert)


def grouped_w4a8_gemm(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                      n_per_expert: int, block: int = 128) -> torch.Tensor:
    """Per-expert W4A8 GEMMs ``y[e] = xq[e] @ W_e`` in one launch: xq int8
    [E, M, K] (the caller applies the per-row activation scales),
    packed/scale the folded [K/2, E*N] layout (straddle widths included) ->
    f32 [E, M, N]. On the card one CTA of K1's decode tile per (32-token
    tile, expert, 128-column tile), so N must be a multiple of 128."""
    E, M, K = xq.shape
    N = n_per_expert
    _check_packed("grouped_w4a8_gemm", packed, scale, block, K, E * N)
    if xq.device.type == "cpu":
        return grouped_w4a8_gemm_plain(xq, packed, scale, N, block)
    _check_card("grouped_w4a8_gemm", packed, scale, block, N, GROUPED_BN, straddle=True)
    if xq.dtype != torch.int8:
        raise ValueError("grouped_w4a8_gemm: wants int8 x")
    _build.check_cuda("grouped_w4a8_gemm", xq, packed, scale)
    if xq.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("grouped_w4a8_gemm: x, packed and scale must be 16-byte aligned")
    fn = _build.function("grouped_w4a8_gemm", [_build.c_ptr] * 4 + [_build.c_int] * 4
                         + [_build.c_ptr])
    out = torch.empty(E, M, N, dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), E, M, N,
                 packed.shape[0], _build.stream(xq))
    grouped_w4a8_gemm.launches += 1
    _build.raise_on_error("grouped_w4a8_gemm", err)
    return out


grouped_w4a8_gemm.launches = 0


# ---------------------------------------------------------------------------
# K12: grouped W4A8 fused with the routed combine
# ---------------------------------------------------------------------------
# K12's shared memory (combine_smem): a ring of 4 stages (the raw packed
# [64, 128] tile, x's two halves of TOK (8 or 16) tokens, a block's scale
# rows), at straddle K the high blocks' products each thread holds
# ([K/256, TOK, 128] f32), the held gated terms [TOK, 128] f32 a slot (one
# slot, the running sum, at R = 1), the list of used experts, 80 bytes more
COMBINE_STAGES = 4
COMBINE_MISC = 80
# a K12 CTA's shared memory for three CTAs an SM (3 x (75 + 1) KB of the
# SM's 228), so that 16 clusters of 16 fit one wave (on the card only 14
# did at 78 KB a CTA: PERF.md), and the fewest held slots a rank takes
COMBINE_WAVE_SMEM = 75 * 1024
COMBINE_MIN_SLOTS = 3
# CTAs K12's clusters aim for: four an SM (above 16 rows two token tiles
# of 16 at clusters of 16, 512 CTAs, ran 7-25% faster than clusters of 8)
COMBINE_TARGET_CTAS = 528


def _combine_tokens(M) -> int:
    """Tokens a K12 CTA: 8 or 16 (one or two n8 tiles); above 16 rows,
    tiles of 16 (a 32-token instance's registers left two CTAs an SM)."""
    return 8 if M <= 8 else 16


def _combine_smem(E, M, K2, r, slots) -> int:
    """Dynamic shared memory of a K12 CTA: the ring, the straddle hold,
    ``slots`` held gated terms where a cluster of ``r`` > 1 splits the
    experts (one, the running sum, at ``r`` = 1), the used list."""
    tok = _combine_tokens(M)
    stage = 64 * GROUPED_BN + 2 * tok * 64 + 2 * GROUPED_BN * 4
    hold = (K2 // 128) * tok * GROUPED_BN * 4 if K2 % 128 else 0
    held = (slots if r > 1 else 1) * tok * GROUPED_BN * 4
    return COMBINE_STAGES * stage + hold + held + 4 * E + COMBINE_MISC


def _combine_plan(E, M, N, K2):
    """(R, slots) of K12: the largest cluster R of 1, 2, 4, 8, 16 (at most
    E) that keeps the 128-column tiles x 16-token tiles x R within
    COMBINE_TARGET_CTAS, and the gated terms a rank holds per round: as many
    as fit COMBINE_WAVE_SMEM (three CTAs an SM), up to ceil(E / R), but at
    least COMBINE_MIN_SLOTS within the 227 KB (fewer rounds beat a third
    CTA an SM at 16 tokens). More used experts than R x slots run in
    rounds. R = 1 sums in order in one CTA."""
    tiles = N // GROUPED_BN * -(-M // 16)
    r = 1
    while r < 16 and 2 * r <= E and 2 * r * tiles <= COMBINE_TARGET_CTAS:
        r *= 2
    if r == 1:
        return 1, 0
    slot = _combine_tokens(M) * GROUPED_BN * 4
    fit = (COMBINE_WAVE_SMEM - _combine_smem(E, M, K2, r, 0)) // slot
    slots = min(-(-E // r), max(fit, COMBINE_MIN_SLOTS))
    while slots > 1 and _combine_smem(E, M, K2, r, slots) > SMEM_LIMIT:
        slots -= 1
    return r, slots


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
    packed/scale the folded layout -> f32 [M, N]. On the card one launch
    of K1's decode tile over the experts some row is routed to (128
    columns a CTA, so N must be a multiple of 128), split over a cluster of
    ``_combine_plan`` CTAs and summed in expert order."""
    E, M, K = xq.shape
    N = n_per_expert
    _check_packed("grouped_w4a8_combine_gemm", packed, scale, block, K, E * N)
    if tuple(gscale.shape) != (E, M):
        raise ValueError(f"grouped_w4a8_combine_gemm: gscale {tuple(gscale.shape)}, "
                         f"want {(E, M)}")
    if xq.device.type == "cpu":
        return grouped_w4a8_combine_gemm_plain(xq, gscale, packed, scale, N, block)
    _check_card("grouped_w4a8_combine_gemm", packed, scale, block, N, GROUPED_BN,
                straddle=True)
    if (xq.dtype, gscale.dtype) != (torch.int8, torch.float32):
        raise ValueError("grouped_w4a8_combine_gemm: wants int8 x, f32 gscale")
    _build.check_cuda("grouped_w4a8_combine_gemm", xq, gscale, packed, scale)
    if xq.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("grouped_w4a8_combine_gemm: x, packed and scale must be 16-byte "
                         "aligned")
    fn = _build.function("grouped_w4a8_combine_gemm",
                         [_build.c_ptr] * 5 + [_build.c_int] * 6 + [_build.c_ptr],
                         source="grouped_w4a8_gemm")
    K2 = packed.shape[0]
    out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), gscale.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), E, M, N, K2, *_combine_plan(E, M, N, K2), _build.stream(xq))
    grouped_w4a8_combine_gemm.launches += 1
    _build.raise_on_error("grouped_w4a8_combine_gemm", err)
    return out


grouped_w4a8_combine_gemm.launches = 0


# ---------------------------------------------------------------------------
# K7 / K8: byte weights (int8 per-channel, e4m3 per-tensor)
# ---------------------------------------------------------------------------
def w8a16_gemm_plain(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch W8A16 with the kernel's rounding points: x rounded to
    bf16, the int8 weights exact, one f32 product over K, then ``* scale``
    [1, N] in f32 and ``out_dtype``."""
    acc = x.to(torch.bfloat16).float() @ data.float()
    return (acc * scale.float()).to(out_dtype)


def wfp8_gemm_plain(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch W(FP8)A16: as ``w8a16_gemm_plain`` with e4m3 weights
    (exact in bf16) and one f32 scale [1, 1]."""
    acc = x.to(torch.bfloat16).float() @ data.float()
    return (acc * scale.float().reshape(1, 1)).to(out_dtype)


# CTAs a K7 / K8 cluster split aims for while one token tile covers M (at
# most 64 tokens): two on each of the H100's 132 SMs. Such a product only
# draws its weight bytes, and on the card the Llama decode shapes ran 19-28%
# faster at two CTAs an SM than at one (PERF.md); above 64 tokens the wgmma
# tile keeps CLUSTER_TARGET_CTAS
BYTE_TARGET_CTAS = 264


def _byte_ranks(M, N, K) -> int:
    """Cluster size of a K7 / K8 product (CTAs that split one output tile's
    128-row blocks, their partials summed in the same launch), over the
    output's 128-column tiles: one a tile up to M = 16 (the decode tile),
    one a tile and 64 tokens above (the wgmma tile)."""
    tiles = -(-N // 128) * (1 if M <= 16 else -(-M // 64))
    return _cluster_ranks(tiles, K // 128, BYTE_TARGET_CTAS if M <= 64 else CLUSTER_TARGET_CTAS)


def _check_byte(name, x, data, scale, scale_shape):
    if data.shape[0] != x.shape[-1] or tuple(scale.shape) != scale_shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, W {tuple(data.shape)}, "
                         f"scale {tuple(scale.shape)}")


def byte_gemm_ok(K: int, N: int) -> bool:
    """Whether the CUDA byte GEMMs (K7 ``w8a16_gemm``, K8 ``wfp8_gemm``)
    take a [K, N] weight: whole 128-row blocks and 64-column tiles."""
    return K % 128 == 0 and N % 64 == 0


def nvfp4_gemm_ok(K: int, N: int) -> bool:
    """Whether an NVFP4 [K, N] weight (N per expert for K13) goes to the
    kernels: K % 128 == 0, the reference's ``_pallas_ok`` rule for NVFP4
    (so K/2 is whole 128-row packed blocks and at most one 64-row tail),
    and 64-column tiles."""
    return K % 128 == 0 and N % 64 == 0


def _byte_launch(name, x, data, scale, out_dtype, want_dtype):
    M, K = x.shape
    N = data.shape[1]
    if not byte_gemm_ok(K, N):
        raise NotImplementedError(f"the CUDA {name} takes K % 128 == 0 and N % 64 == 0, "
                                  f"got K={K}, N={N}")
    if (data.dtype, scale.dtype) != (want_dtype, torch.float32):
        raise ValueError(f"{name}: wants {want_dtype} W, f32 scale")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16 or data.data_ptr() % 16:
        raise ValueError(f"{name}: x and W must be 16-byte aligned")
    _build.check_cuda(name, x, data, scale)
    fn = _build.function(name, [_build.c_ptr] * 5 + [_build.c_int] * 4 + [_build.c_ptr],
                         source="w8a16_gemm")
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    f32 = out_dtype == torch.float32
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), data.data_ptr(), scale.data_ptr(),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 M, N, K, _byte_ranks(M, N, K), _build.stream(x))
    return out, err


def w8a16_gemm(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [M, K] (rounded to bf16) @ int8 W [K, N] * scale [1, N] -> [M, N]
    in ``out_dtype`` (f32 or bf16), every M in one launch: up to M = 16
    the mma.sync decode tile, above it the wgmma tile, each splitting the
    128-row blocks over a cluster of ``_byte_ranks`` CTAs where tiles are
    few."""
    _check_byte("w8a16_gemm", x, data, scale, (1, data.shape[1]))
    if x.device.type == "cpu":
        return w8a16_gemm_plain(x, data, scale, out_dtype=out_dtype)
    out, err = _byte_launch("w8a16_gemm", x, data, scale, out_dtype, torch.int8)
    w8a16_gemm.launches += 1
    _build.raise_on_error("w8a16_gemm", err)
    return out


w8a16_gemm.launches = 0


def wfp8_gemm(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [M, K] (rounded to bf16) @ e4m3 W [K, N] * scale [1, 1] -> [M, N]
    in ``out_dtype`` (f32 or bf16), as ``w8a16_gemm``."""
    _check_byte("wfp8_gemm", x, data, scale, (1, 1))
    if x.device.type == "cpu":
        return wfp8_gemm_plain(x, data, scale, out_dtype=out_dtype)
    out, err = _byte_launch("wfp8_gemm", x, data, scale, out_dtype, torch.float8_e4m3fn)
    wfp8_gemm.launches += 1
    _build.raise_on_error("wfp8_gemm", err)
    return out


wfp8_gemm.launches = 0


# ---------------------------------------------------------------------------
# K9 / K13: NVFP4 and its grouped form
# ---------------------------------------------------------------------------
def _decode_e2m1(code: torch.Tensor) -> torch.Tensor:
    """int32 codes 0..15 (sign, exponent, exponent, mantissa) -> f32 by the
    reference kernel's bit assembly: exponent field 126+e for e > 0, 0.5 or
    0 for e == 0."""
    s = (code >> 3) & 1
    e = (code >> 1) & 3
    m = code & 1
    bits = (s << 31) | torch.where(e > 0, ((126 + e) << 23) | (m << 22), m * (126 << 23))
    return bits.view(torch.float32)


def nvfp4_unit_weights(packed: torch.Tensor, scale: torch.Tensor,
                       block: int = 16) -> torch.Tensor:
    """The bf16 weights the NVFP4 kernels multiply, in f32 [K, EN]: each
    e2m1 value times its e4m3 block scale (at most 6 significant bits:
    exact in f32 and in bf16); ``scale2`` is left to the f32 result."""
    p = packed.to(torch.int32)
    vals = torch.cat([_decode_e2m1(p & 0xF), _decode_e2m1(p >> 4)], dim=0)
    return vals * scale.float().repeat_interleave(block, dim=0)


def nvfp4_gemm_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                     scale2: torch.Tensor, block: int = 16,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch NVFP4 with the kernel's rounding points: x rounded to
    bf16, the exact scaled weights, one f32 product over K, then
    ``* scale2`` in f32 and ``out_dtype``."""
    acc = x.to(torch.bfloat16).float() @ nvfp4_unit_weights(packed, scale, block)
    return (acc * scale2.float().reshape(1, 1)).to(out_dtype)


def grouped_nvfp4_gemm_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                             scale2: torch.Tensor, n_per_expert: int, block: int = 16,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert ``nvfp4_gemm_plain``: x [E, M, K] on the folded layout ->
    [E, M, N]."""
    E, _, K = x.shape
    w = nvfp4_unit_weights(packed, scale, block).reshape(K, E, n_per_expert).transpose(0, 1)
    acc = torch.bmm(x.to(torch.bfloat16).float(), w)
    return (acc * scale2.float().reshape(1, 1, 1)).to(out_dtype)


def _check_nvfp4(name, packed, scale, scale2, block, K, EN):
    K2 = packed.shape[0]
    if (K != 2 * K2 or K2 % block or tuple(scale.shape) != (K // block, EN)
            or packed.shape[1] != EN or scale2.numel() != 1):
        raise ValueError(f"{name}: shapes K={K}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}, scale2 {tuple(scale2.shape)}")


def _nvfp4_ranks(E, M, N, K2) -> int:
    """Cluster size of an NVFP4 product (CTAs that split one output tile's
    128-row blocks, a 64-row tail counted as one, their partials summed in
    the same launch): up to M = 16
    over E experts' 64-column tiles of the decode tile, which only draws
    weight bytes, at K7 / K8's BYTE_TARGET_CTAS (where R is 1 and tiles are
    many the kernel takes 128 columns a CTA); above over 128 columns x 64
    tokens of the wgmma tile."""
    blocks = -(-K2 // 128)
    if M <= 16:
        return _cluster_ranks(E * (N // 64), blocks, BYTE_TARGET_CTAS)
    return _cluster_ranks(E * -(-N // 128) * -(-M // 64), blocks)


def _nvfp4_launch(name, x3, packed, scale, scale2, n, block, out_dtype, grouped):
    E, M, K = x3.shape
    K2 = packed.shape[0]
    if block != 16 or K2 % 64 or n % 64:
        raise NotImplementedError(f"the CUDA {name} takes block-16 scales, K/2 % 64 == 0 "
                                  f"and N % 64 == 0, got block {block}, K={K}, N={n}")
    if (packed.dtype, scale.dtype, scale2.dtype) != (torch.uint8, torch.float8_e4m3fn,
                                                     torch.float32):
        raise ValueError(f"{name}: wants uint8 packed, e4m3 scale, f32 scale2")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported")
    x3 = x3.to(torch.bfloat16).contiguous()
    _build.check_cuda(name, x3, packed, scale, scale2)
    if x3.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{name}: x, packed and scale must be 16-byte aligned")
    out = torch.empty(E, M, n, dtype=out_dtype, device=x3.device)
    f32 = out_dtype == torch.float32
    ints = ([E, M, n, K2] if grouped else [M, n, K2]) + [_nvfp4_ranks(E, M, n, K2)]
    fn = _build.function(name, [_build.c_ptr] * 6 + [_build.c_int] * len(ints) + [_build.c_ptr],
                         source="nvfp4_gemm")
    with torch.cuda.device(x3.device):
        err = fn(x3.data_ptr(), packed.data_ptr(), scale.data_ptr(), scale2.data_ptr(),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 *ints, _build.stream(x3))
    return out, err


def nvfp4_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               scale2: torch.Tensor, block: int = 16, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [M, K] (rounded to bf16) @ NVFP4 W (packed uint8 [K/2, N], e4m3
    scale [K/block, N], f32 scale2 [1, 1]) -> [M, N] in ``out_dtype``, every
    M in one launch: up to M = 16 the mma.sync decode tile, above it the
    wgmma tile, each splitting the 128-row blocks (and a 64-row tail where
    K/2 % 128 == 64) over a cluster of ``_nvfp4_ranks`` CTAs where tiles
    are few."""
    M, K = x.shape
    N = packed.shape[1]
    _check_nvfp4("nvfp4_gemm", packed, scale, scale2, block, K, N)
    if x.device.type == "cpu":
        return nvfp4_gemm_plain(x, packed, scale, scale2, block, out_dtype=out_dtype)
    out, err = _nvfp4_launch("nvfp4_gemm", x[None], packed, scale, scale2, N, block,
                             out_dtype, grouped=False)
    nvfp4_gemm.launches += 1
    _build.raise_on_error("nvfp4_gemm", err)
    return out[0]


nvfp4_gemm.launches = 0


def grouped_nvfp4_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       scale2: torch.Tensor, n_per_expert: int, block: int = 16,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert NVFP4 GEMMs ``y[e] = x[e] @ W_e`` in one launch: x
    [E, M, K] (rounded to bf16), packed/scale the folded [K/2, E*N] and
    [K/block, E*N] layout, one scale2 -> [E, M, N] in ``out_dtype``."""
    E, M, K = x.shape
    _check_nvfp4("grouped_nvfp4_gemm", packed, scale, scale2, block, K, E * n_per_expert)
    if x.device.type == "cpu":
        return grouped_nvfp4_gemm_plain(x, packed, scale, scale2, n_per_expert, block,
                                        out_dtype)
    out, err = _nvfp4_launch("grouped_nvfp4_gemm", x, packed, scale, scale2, n_per_expert,
                             block, out_dtype, grouped=True)
    grouped_nvfp4_gemm.launches += 1
    _build.raise_on_error("grouped_nvfp4_gemm", err)
    return out


grouped_nvfp4_gemm.launches = 0
