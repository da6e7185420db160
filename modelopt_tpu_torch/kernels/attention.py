"""KV-cache write, fused decode attention and read-only decode attention
over lane-merged caches.

Counterparts of ``modelopt_tpu/kernels/attention.py::dense_kv_write`` (K3),
``::fused_decode_attention`` (K2) and ``::decode_attention`` (K5). Caches
are [B, S, KH*D] (heads merged into the last dim, the reference's layout);
K2 and K3 update them IN PLACE: where the reference donates/aliases the
cache buffers, these functions write into the tensors they are given and
hand the same tensors back. K5 only reads.

K3's ``dense_kv_write_pair`` writes an MHA layer's K and V in one launch.
On CUDA tensors the wrappers launch ``csrc/kv_write.cu``,
``csrc/fused_decode_attention.cu`` and ``csrc/decode_attention.cu`` (at
MLA's geometry K5's entry runs ``csrc/latent_decode.cuh``'s cluster kernel,
int8 or e4m3, else its one-CTA body); on CPU
tensors the ``*_plain`` versions compute the same functions (and serve as
the card's oracles). Caches hold bf16 values or int8 or e4m3 codes with
f32 scalar scales; e4m3 codes are read as the reference reads them
(``e4m3_decode_plain``), in every kernel's e4m3 branch.
"""

from __future__ import annotations

import torch

from . import _build


def _clamped_starts(start: torch.Tensor, S: int, T: int) -> list:
    return [min(max(int(s), 0), S - T) for s in start.tolist()]


def dense_kv_write_plain(cache: torch.Tensor, vals: torch.Tensor,
                         start: torch.Tensor) -> torch.Tensor:
    """Write vals [B, T, KH*D] into cache [B, S, KH*D] at rows
    [start[b], start[b]+T), start clamped to [0, S-T] like the reference's
    vmapped dynamic_update_slice."""
    T = vals.shape[1]
    for b, s in enumerate(_clamped_starts(start, cache.shape[1], T)):
        cache[b, s:s + T] = vals[b].to(cache.dtype)
    return cache


def dense_kv_write_pair_plain(k_cache: torch.Tensor, v_cache: torch.Tensor,
                              k_vals: torch.Tensor, v_vals: torch.Tensor,
                              start: torch.Tensor):
    """An MHA layer's K and V rows, one ``dense_kv_write_plain`` a cache
    (the reference's two calls)."""
    return (dense_kv_write_plain(k_cache, k_vals, start),
            dense_kv_write_plain(v_cache, v_vals, start))


def _kv_write(name: str, caches: tuple, vals: tuple, start: torch.Tensor) -> None:
    """K3 over one or two caches of one shape and dtype: the plain version on
    the CPU, else one launch (counted as one ``dense_kv_write`` launch)."""
    B, S, KHD = caches[0].shape
    T = vals[0].shape[1]
    if (T > S or any(c.shape != caches[0].shape or c.dtype != caches[0].dtype for c in caches)
            or any(v.shape != (B, T, KHD) for v in vals)):
        raise ValueError(f"{name}: caches {[tuple(c.shape) for c in caches]}, "
                         f"vals {[tuple(v.shape) for v in vals]}")
    if caches[0].device.type == "cpu":
        for c, v in zip(caches, vals):
            dense_kv_write_plain(c, v, start)
        return
    vals = tuple(v.to(c.dtype) for c, v in zip(caches, vals))
    row_bytes = KHD * caches[0].element_size()
    if row_bytes % 16 or start.dtype != torch.int32 or start.shape != (B,):
        raise ValueError(f"{name}: rows must be 16-byte multiples and start int32 [B]")
    _build.check_cuda(name, *caches, *vals, start)
    if any(t.data_ptr() % 16 for t in caches + vals):
        raise ValueError(f"{name}: caches and vals must be 16-byte aligned")
    fn = _build.function("kv_write", [_build.c_ptr] * 5 + [_build.c_int] * 5
                         + [_build.c_ptr])
    second = len(caches) == 2
    with torch.cuda.device(caches[0].device):
        err = fn(caches[0].data_ptr(), caches[1].data_ptr() if second else None,
                 vals[0].data_ptr(), vals[1].data_ptr() if second else None,
                 start.data_ptr(), len(caches), B, S, T, row_bytes, _build.stream(caches[0]))
    dense_kv_write.launches += 1
    _build.raise_on_error(name, err)


def dense_kv_write(cache: torch.Tensor, vals: torch.Tensor,
                   start: torch.Tensor) -> torch.Tensor:
    """In-place per-slot cache write (see ``dense_kv_write_plain``)."""
    _kv_write("dense_kv_write", (cache,), (vals,), start)
    return cache


def dense_kv_write_pair(k_cache: torch.Tensor, v_cache: torch.Tensor, k_vals: torch.Tensor,
                        v_vals: torch.Tensor, start: torch.Tensor):
    """``dense_kv_write`` of an MHA layer's K and V rows into two caches of
    one shape and dtype, in place: on the card one K3 launch for both.
    Returns (k_cache, v_cache)."""
    _kv_write("dense_kv_write_pair", (k_cache, v_cache), (k_vals, v_vals), start)
    return k_cache, v_cache


dense_kv_write.launches = 0


def e4m3_decode_plain(codes: torch.Tensor) -> torch.Tensor:
    """e4m3 codes -> f32 by the reference's bit assembly
    (``_e4m3_to_bf16``): exponent field e + 120 and mantissa m << 20 for
    e > 0, m * 2^-9 for e == 0, the sign bit on top. Every code decodes to
    a number: 0x7f and 0xff give +-480, where a float8_e4m3fn cast gives
    NaN (no NaN code is ever written to a cache). Exact in bf16."""
    b = codes.view(torch.uint8).to(torch.int32)
    e = (b >> 3) & 0xF
    m = b & 0x7
    norm = ((e + 120) << 23) | (m << 20)
    sub = (m.float() * 2.0**-9).view(torch.int32)
    bits = ((b & 0x80) << 24) | torch.where(e > 0, norm, sub)
    return bits.view(torch.float32)


def e4m3_pair_decode(codes: torch.Tensor) -> torch.Tensor:
    """The latent cluster kernel's e4m3 operand decode
    (``csrc/e4m3.cuh``'s ``e4m3_cache_pair``: the code's fields shifted into
    a bf16's, times 2^120 in bf16) applied to every code of ``codes`` on the
    card, f32 out; on a CPU tensor ``e4m3_decode_plain``. A probe of the
    device function, not a kernel of the port: no path calls it."""
    if codes.device.type == "cpu":
        return e4m3_decode_plain(codes)
    if codes.dtype not in (torch.float8_e4m3fn, torch.uint8):
        raise ValueError(f"e4m3_pair_decode: wants e4m3 codes, got {codes.dtype}")
    codes = codes.contiguous()
    _build.check_cuda("e4m3_pair_decode", codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    fn = _build.function("e4m3_pair_decode", [_build.c_ptr] * 2 + [_build.c_int, _build.c_ptr],
                         source="decode_attention")
    with torch.cuda.device(codes.device):
        err = fn(codes.data_ptr(), out.data_ptr(), codes.numel(), _build.stream(codes))
    _build.raise_on_error("e4m3_pair_decode", err)
    return out


def e4m3_decode(codes: torch.Tensor) -> torch.Tensor:
    """The CUDA kernels' e4m3 decode (``csrc/e4m3.cuh``, which K2 and K15
    read their caches through) applied to every code of ``codes`` on the
    card, f32 out; on a CPU tensor ``e4m3_decode_plain``. A probe of the
    device function, not a kernel of the port: no path calls it."""
    if codes.device.type == "cpu":
        return e4m3_decode_plain(codes)
    if codes.dtype not in (torch.float8_e4m3fn, torch.uint8):
        raise ValueError(f"e4m3_decode: wants e4m3 codes, got {codes.dtype}")
    codes = codes.contiguous()
    _build.check_cuda("e4m3_decode", codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    fn = _build.function("e4m3_decode", [_build.c_ptr] * 2 + [_build.c_int, _build.c_ptr],
                         source="fused_decode_attention")
    with torch.cuda.device(codes.device):
        err = fn(codes.data_ptr(), out.data_ptr(), codes.numel(), _build.stream(codes))
    _build.raise_on_error("e4m3_decode", err)
    return out


def _kv_values(c: torch.Tensor) -> torch.Tensor:
    """Cache codes as the reference's non-int8 attention reads them
    (``_load_kv_block``): e4m3 through ``e4m3_decode_plain``, others rounded
    to bf16; f32 out."""
    if c.dtype == torch.float8_e4m3fn:
        return e4m3_decode_plain(c)
    return c.to(torch.bfloat16).float()


# cache dtype -> the CUDA kernels' cache kind argument
CACHE_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def _scalar(t, device) -> torch.Tensor:
    """A scale as a 0-d f32 tensor on ``device`` (None = 1)."""
    if t is None:
        return torch.ones((), device=device)
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(())


def _decode_chunk(S: int, chunk: int) -> int:
    # the reference's rule (attention.py:559): 256-key chunks only when they
    # tile S, else one chunk of S — it changes the int8 probability codes
    return S if S % chunk else chunk


def _attend_chunks(qf, k_cache, v_cache, L, ks, int8: bool, chunk: int, starts=None,
                   live=None):
    """The reference's ``_attend_chunk`` over every chunk holding a key
    below ``L[b]`` (the online softmax state after them): q rows qf
    [B, KH, G, D] in f32 (bf16 values), caches [B, S, KH*D], scalar k scale
    ``ks``. Returns (m, l, acc) of shapes [B, KH, G, 1] x 2 and
    [B, KH, G, D]. Block-sparse (K17): chunk c of slot b is the cache rows
    [c*chunk, (c+1)*chunk) at key positions ``starts[b, c]`` on, attended
    where ``live[b, c]`` (both [B, n_chunks]), keys at or past L[b]
    masked."""
    B, S, _ = k_cache.shape
    KH, G, D = qf.shape[1:]
    dev = qf.device
    inv_sqrt_d = ks / torch.sqrt(torch.tensor(float(D), device=dev))
    if int8:
        qmax = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        # a true division, as the kernels and the reference compute it
        # (``127.0 / t`` would be ``t.reciprocal() * 127``, rounded twice)
        q8 = torch.round(qf * (torch.tensor(127.0, device=dev) / qmax))
        fs = qmax * (inv_sqrt_d / 127.0)
    k4 = k_cache.view(B, S, KH, D)
    v4 = v_cache.view(B, S, KH, D)
    m = torch.full((B, KH, G, 1), -1e30, device=dev)
    l = torch.zeros((B, KH, G, 1), device=dev)
    acc = torch.zeros((B, KH, G, D), device=dev)
    if starts is None:
        n_chunks = -(-int(L.max()) // chunk) if B else 0
        starts = (torch.arange(n_chunks, device=dev) * chunk).expand(B, n_chunks)
        live = starts < L[:, None]
    for c in range(starts.shape[1]):
        base = c * chunk
        kb = k4[:, base:base + chunk]
        vb = v4[:, base:base + chunk]
        if int8:
            # integer dots: exact in f32 (|sum| <= 127*127*640 < 2^24)
            s = torch.einsum("bhgd,bthd->bhgt", q8, kb.float()) * fs
        else:
            s = torch.einsum("bhgd,bthd->bhgt", qf, _kv_values(kb)) * inv_sqrt_d
        col = starts[:, c, None] + torch.arange(kb.shape[1], device=dev)    # [B, chunk]
        s = torch.where(col[:, None, None, :] < L[:, None, None, None], s,
                        torch.tensor(-1e30, device=dev))
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        e = torch.exp(s - m_cur)
        if int8:
            e8 = torch.round(e * 127.0)
            esum = e8.sum(-1, keepdim=True) * (1.0 / 127.0)
            # e8 . v8 sums pass 2^24: exact in f64
            y = (torch.einsum("bhgt,bthd->bhgd", e8.double(), vb.double())
                 .float() * (1.0 / 127.0))
        else:
            esum = e.sum(-1, keepdim=True)
            y = torch.einsum("bhgt,bthd->bhgd", e.to(torch.bfloat16).float(),
                             _kv_values(vb))
        on = live[:, c, None, None, None]
        l = torch.where(on, l * alpha + esum, l)
        acc = torch.where(on, acc * alpha + y, acc)
        m = torch.where(on, m_cur, m)
    return m, l, acc


def fused_decode_ok(q_shape, S: int, cache_dtype) -> bool:
    """Whether a dense-cache decode step takes K2. The reference's rule for
    its TPU kernel (``fused_decode_ok``): S <= 8192, D % 128 == 0 and
    S % 8 == 0 (whole 8-row slabs); its backend test is not followed (on a
    CPU tensor the wrapper computes the kernel's twin). Then what the CUDA
    kernel takes: D = 128, G in (1, 2, 4, 8) and an int8, e4m3 or bf16
    cache. Other steps write the cache by K3 and attend by K5 or the
    einsum, as the reference's do where its gate says no."""
    B, KH, G, D = q_shape
    return (S <= 8192 and D % 128 == 0 and S % 8 == 0
            and D == 128 and G in (1, 2, 4, 8) and cache_dtype in CACHE_KIND)


def fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos,
                                 k_scale=None, v_scale=None,
                                 out_dtype=torch.bfloat16, chunk: int = 256):
    """Plain PyTorch fused decode step with the reference kernel's rounding
    points (see csrc/fused_decode_attention.cu for the list)."""
    B, S, KHD = k_cache.shape
    KH, G, D = q.shape[1:]
    chunk = _decode_chunk(S, chunk)
    dev = q.device
    int8 = k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8
    ks, vs = (_scalar(t, dev) for t in (k_scale, v_scale))
    inv_sqrt_d = ks / torch.sqrt(torch.tensor(float(D), device=dev))
    L = pos.long().clamp(max=S - 1)
    qf = q.to(torch.bfloat16).float()                        # [B, KH, G, D]
    m, l, acc = _attend_chunks(qf, k_cache, v_cache, L, ks, int8, chunk)
    kn = k_new.reshape(B, KH, 1, D).float()
    vn = v_new.reshape(B, KH, 1, D).float()
    s_n = (qf * kn).sum(-1, keepdim=True) * inv_sqrt_d
    m_fin = torch.maximum(m, s_n)
    alpha = torch.exp(m - m_fin)
    e_n = torch.exp(s_n - m_fin)
    l_fin = l * alpha + e_n
    acc = acc * alpha + e_n * vn
    out = acc * (vs / l_fin.clamp_min(1e-30))
    rows = torch.arange(B, device=dev)
    k_cache[rows, L] = k_new.reshape(B, KHD).to(k_cache.dtype)
    v_cache[rows, L] = v_new.reshape(B, KHD).to(v_cache.dtype)
    return out.to(out_dtype), k_cache, v_cache


def fused_decode_attention(q, k_new, v_new, k_cache, v_cache, pos,
                           k_scale=None, v_scale=None, out_dtype=torch.bfloat16,
                           chunk: int = 256, sinks=None, softcap=None):
    """One decode step: write k/v_new [B, 1, KH*D] (already cache codes) into
    the caches at row ``pos[b]`` IN PLACE and return the attention of
    q [B, KH, G, D] over the pos[b]+1 keys, with the caches:
    ``(out [B, KH, G, D], k_cache, v_cache)``. A pos at or past the cache
    end is clamped to S-1. Caches of int8 or e4m3 codes (``k_scale`` /
    ``v_scale`` f32 scalars, None = 1) or bf16. On the card an e4m3 cache
    runs the kernel's e4m3 branch: nothing dequantizes it first."""
    if sinks is not None or softcap is not None:
        raise NotImplementedError(
            "fused_decode_attention: attention sinks and logit softcap are not "
            "ported yet")
    B, S, KHD = k_cache.shape
    KH, G, D = q.shape[1:]
    if q.shape[0] != B or KH * D != KHD or v_cache.shape != k_cache.shape:
        raise ValueError(f"fused_decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                            pos, k_scale, v_scale, out_dtype,
                                            chunk)
    if k_cache.dtype not in CACHE_KIND or v_cache.dtype != k_cache.dtype:
        raise NotImplementedError(
            f"fused_decode_attention: {k_cache.dtype} caches are not ported "
            "to the card (int8, e4m3 and bf16 are)")
    if D != 128 or G not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"fused_decode_attention: the CUDA kernel takes D=128 and G in "
            f"(1, 2, 4, 8), got D={D}, G={G}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_decode_attention: out_dtype {out_dtype}")
    chunk = _decode_chunk(S, chunk)
    q = _build.aligned16(q.to(torch.bfloat16).contiguous())
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(v_cache.dtype).contiguous()
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError("fused_decode_attention: pos must be int32 [B]")
    scales = [None if t is None else _scalar(t, q.device)
              for t in (k_scale, v_scale)]
    _build.check_cuda("fused_decode_attention", q, k_new, v_new, k_cache,
                      v_cache, pos, *scales)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("fused_decode_attention: caches must be 16-byte aligned")
    out = torch.empty(B, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("fused_decode_attention", [_build.c_ptr] * 10
                         + [_build.c_int] * 6 + [_build.c_ptr])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                 _build.ptr(scales[0]), _build.ptr(scales[1]),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 B, S, KH, G, chunk, CACHE_KIND[k_cache.dtype], _build.stream(q))
    fused_decode_attention.launches += 1
    _build.raise_on_error("fused_decode_attention", err)
    return out, k_cache, v_cache


fused_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# K5: read-only decode attention
# ---------------------------------------------------------------------------
# what the CUDA kernel was written for (csrc/decode_attention.cu)
DECODE_MAX_G = 16
DECODE_MAX_D = 640


# K5 and K15 at MLA's geometry (one KV head, G <= 16, D a multiple of 128
# up to 640, one int8 or e4m3 tensor as K and V, chunks of at most
# LATENT_RANKS * LATENT_SLOTS * LATENT_PIECE = 2176 keys) run
# csrc/latent_decode.cuh's cluster kernel; its C entry decides
# (``latent_ok`` in csrc/decode_attention.cu), every other geometry takes
# the one-CTA body. The plan below is the kernel's, worked out on the
# device from each slot's length.
LATENT_RANKS = 16      # CTAs a cluster
LATENT_PIECE = 68      # keys a piece at most
LATENT_SLOTS = 2       # pieces a CTA holds a round
# two CTAs an SM: each may take (228 KB - 2 x 1 KB reserved) / 2 bytes
LATENT_CTA_SMEM = 115_712
# the kernel's static arrays (maxima, code sums, scales, tables), by cache
# dtype: e4m3 keeps its chunk esums in the dynamic region
LATENT_STATIC_SMEM = {torch.int8: 5_008, torch.float8_e4m3fn: 2_896}


def latent_plan(L: int, chunk: int) -> list:
    """The latent cluster kernel's split of a slot of ``L`` keys in chunks
    of ``chunk`` keys: a list of rounds, each a list over the ranks that
    hold pieces (at most LATENT_RANKS) of their pieces (chunk index, lo,
    hi). A chunk of n keys falls in ceil(n / LATENT_PIECE) balanced pieces;
    a round takes whole chunks, at most LATENT_RANKS * LATENT_SLOTS pieces,
    and of its n pieces rank r of R = min(LATENT_RANKS, n) takes
    [n r / R, n (r + 1) / R). One piece in all
    (``L <= min(LATENT_PIECE, chunk)``): rank 0 alone runs the slot."""
    if L <= 0:
        return []
    nchunks = -(-L // chunk)
    p_full = -(-chunk // LATENT_PIECE)
    p_last = -(-(L - (nchunks - 1) * chunk) // LATENT_PIECE)
    cpr = LATENT_RANKS * LATENT_SLOTS // p_full
    rounds = []
    for c0 in range(0, nchunks, cpr):
        pieces = []
        for c in range(c0, min(nchunks, c0 + cpr)):
            n, p = min(chunk, L - c * chunk), p_last if c == nchunks - 1 else p_full
            pieces += [(c, c * chunk + n * i // p, c * chunk + n * (i + 1) // p)
                       for i in range(p)]
        n = len(pieces)
        R = min(LATENT_RANKS, n)
        rounds.append([pieces[n * r // R:n * (r + 1) // R] for r in range(R)])
    return rounds


def latent_smem(D: int, cache_dtype=torch.int8) -> int:
    """Dynamic shared memory of one CTA of the latent cluster kernel:
    staged rows (the held partials over them), then for int8 caches q's
    int8 A fragments, the scores and the 7-bit codes of its two pieces; for
    e4m3 caches q's bf16 A fragments and a region of 8 x 32 x 16 bytes
    (the warps' piece maxima, the gathered maxima, one piece's bf16
    probabilities and the warps' sums of them, the gathered and the
    chunks' sums, each in turn). ``chip_smoke.py`` holds it to the kernel's
    own count (``latent_decode_smem``)."""
    rows = LATENT_SLOTS * LATENT_PIECE * D
    if cache_dtype == torch.float8_e4m3fn:
        return rows + 2 * 16 * D + 8 * LATENT_RANKS * LATENT_SLOTS * 16
    return rows + 16 * D + 4 * LATENT_SLOTS * 16 * 72 + LATENT_SLOTS * 16 * 112


def decode_attention_ok(q_shape, S: int, cache_dtype) -> bool:
    """Whether a decode step takes K5: the reference's rule for its TPU
    kernel (``decode_attention_ok``), quantized caches (int8 or e4m3) with
    S <= 8192 and D % 128 == 0; other decodes take the einsum path. The
    reference's CPU branch (always the einsum path) is not followed: on a
    CPU tensor the wrapper computes the kernel's twin."""
    D = q_shape[-1]
    return cache_dtype in (torch.int8, torch.float8_e4m3fn) and S <= 8192 and D % 128 == 0


def decode_attention_plain(q, k_cache, v_cache, lengths, k_scale=None,
                           v_scale=None, out_dtype=torch.bfloat16,
                           chunk: int = 256):
    """Plain PyTorch K5 with the reference kernel's rounding points (the
    chunk rule; int8 caches: q requantized to int8 per (head, group) row,
    7-bit probability codes against the running max; bf16 and e4m3 caches:
    f32 scores, the denominator from f32 e, PV from e rounded to bf16, e4m3
    codes decoded as the reference decodes them; see
    csrc/decode_attention.cu): attention of q [B, KH, G, D] over keys
    [0, lengths[b]) of caches [B, S, KH*D] -> [B, KH, G, D]."""
    S = k_cache.shape[1]
    chunk = _decode_chunk(S, chunk)
    dev = q.device
    int8 = k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8
    ks, vs = (_scalar(t, dev) for t in (k_scale, v_scale))
    L = lengths.long().clamp(max=S)
    _, l, acc = _attend_chunks(q.to(torch.bfloat16).float(), k_cache, v_cache, L,
                               ks, int8, chunk)
    return (acc * (vs / l.clamp_min(1e-30))).to(out_dtype)


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None,
                     out_dtype=torch.bfloat16, chunk: int = 256, sinks=None,
                     softcap=None):
    """Attention of q [B, KH, G, D] over the first ``lengths[b]`` keys of
    caches [B, S, KH*D] (int8 or e4m3 codes with f32 scalar scales, or
    bf16), which it only reads; K and V may be one tensor (MLA passes its
    latent cache twice). A length past the cache is clamped to S. Returns
    [B, KH, G, D] in ``out_dtype``. On the card an e4m3 cache runs the
    kernel's e4m3 branch: nothing dequantizes it first."""
    if sinks is not None or softcap is not None:
        raise NotImplementedError(
            "decode_attention: attention sinks and logit softcap are not ported yet")
    B, S, KHD = k_cache.shape
    KH, G, D = q.shape[1:]
    if q.shape[0] != B or KH * D != KHD or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if lengths.shape != (B,):
        raise ValueError("decode_attention: lengths must be [B]")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, k_scale,
                                      v_scale, out_dtype, chunk)
    if k_cache.dtype not in CACHE_KIND or v_cache.dtype != k_cache.dtype:
        raise NotImplementedError(
            f"decode_attention: {k_cache.dtype} caches are not ported to the card "
            "(int8, e4m3 and bf16 are)")
    if D % 128 or D > DECODE_MAX_D or not 1 <= G <= DECODE_MAX_G:
        raise NotImplementedError(
            f"decode_attention: the CUDA kernel takes D a multiple of 128 up to "
            f"{DECODE_MAX_D} and G up to {DECODE_MAX_G}, got D={D}, G={G}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: out_dtype {out_dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("decode_attention: lengths must be int32")
    chunk = _decode_chunk(S, chunk)
    q = _build.aligned16(q.to(torch.bfloat16).contiguous())
    scales = [None if t is None else _scalar(t, q.device) for t in (k_scale, v_scale)]
    _build.check_cuda("decode_attention", q, k_cache, v_cache, lengths, *scales)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: caches must be 16-byte aligned")
    out = torch.empty(B, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("decode_attention", [_build.c_ptr] * 8
                         + [_build.c_int] * 7 + [_build.c_ptr])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), _build.ptr(scales[0]), _build.ptr(scales[1]),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 B, S, KH, G, D, chunk, CACHE_KIND[k_cache.dtype], _build.stream(q))
    decode_attention.launches += 1
    _build.raise_on_error("decode_attention", err)
    return out


decode_attention.launches = 0
