"""Paged decode attention (K15) and paged KV write (K16) over page pools.

Counterparts of ``modelopt_tpu/kernels/paged_attention.py``. KV lives in
global page pools ``[n_pages, page_size, KH*D]`` (heads merged into the
last dim); a per-slot ``page_table [B, PMAX]`` int32 maps a slot-local page
index to a pool page id, unused entries pointing at the null page 0.

On CUDA tensors the wrappers launch ``csrc/decode_attention.cu``'s
``paged_decode_attention`` entry (at D = 128 and G in {1, 2, 4, 8} a
thread-block cluster of 8 CTAs per slot and KV head that splits the
slot's pages, ``csrc/cluster_decode.cuh``; at MLA's geometry K5's
latent cluster kernel, ``csrc/latent_decode.cuh``, one page a chunk, for
int8 and e4m3 latent pools; else
K5's one-CTA body walking one page per chunk) and
``csrc/paged_kv_write.cu``; on CPU
tensors the ``*_plain`` versions compute the same functions (and serve as
the card's oracles). K16 writes the pool IN PLACE and hands it back,
where the reference aliases it. Its two entries run one body:
``paged_kv_write`` (the reference kernel's signature, slots given) and
``paged_kv_write_rows``, a paged layer's whole write in one launch (the
page lookup, MLA's zero pad and every pool).
"""

from __future__ import annotations

import torch
from torch import nn

from . import _build
from .attention import CACHE_KIND, DECODE_MAX_D, DECODE_MAX_G, _attend_chunks, _scalar


def paged_gather_dense(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages [n_pages, page_size, KH*D], page_table [B, PMAX] -> dense
    [B, PMAX*page_size, KH*D] (the chunked-prefill read path and the twins'
    gather)."""
    B, PMAX = page_table.shape
    _, ps, KHD = pages.shape
    return pages[page_table.reshape(-1).long()].reshape(B, PMAX * ps, KHD)


def paged_attention_ok(B: int, KH: int, G: int, D: int, page_size: int) -> bool:
    """The reference's rule for its TPU kernel (D % 128 == 0 and
    page_size % 8 == 0) and what the CUDA kernel was written for (D up to
    640, G up to 16); other decodes take the gather + einsum path. The
    reference's CPU branch (always the gather path) is not followed: on a
    CPU tensor the wrapper computes the kernel's twin."""
    return (D % 128 == 0 and page_size % 8 == 0 and D <= DECODE_MAX_D
            and 1 <= G <= DECODE_MAX_G)


# ---------------------------------------------------------------------------
# K15: paged decode attention
# ---------------------------------------------------------------------------
def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, k_scale=None,
                                 v_scale=None, out_dtype=torch.bfloat16):
    """Plain PyTorch K15 with the reference kernel's rounding points: the
    pages gathered dense and ``_attend_chunks`` (K5's twin) with one page
    per chunk, keys [0, lengths[b]) bounded by the table's width. int8
    pools: q requantized per (head, group) row, 7-bit probability codes
    against each page's running max; bf16 and e4m3 pools: f32 scores, bf16
    PV operands, e4m3 codes decoded as the reference decodes them."""
    B, PMAX = page_table.shape
    ps = k_pages.shape[1]
    dev = q.device
    int8 = k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8
    ks, vs = (_scalar(t, dev) for t in (k_scale, v_scale))
    kd = paged_gather_dense(k_pages, page_table)
    vd = kd if v_pages is k_pages else paged_gather_dense(v_pages, page_table)
    L = lengths.long().clamp(max=PMAX * ps)
    _, l, acc = _attend_chunks(q.to(torch.bfloat16).float(), kd, vd, L, ks, int8, ps)
    return (acc * (vs / l.clamp_min(1e-30))).to(out_dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, k_scale=None,
                           v_scale=None, out_dtype=torch.bfloat16, sinks=None, softcap=None):
    """Attention of q [B, KH, G, D] over the first ``lengths[b]`` keys of
    slot b, whose rows lie in pools [n_pages, page_size, KH*D] (int8 or
    e4m3 codes with f32 scalar scales, or bf16) at the pages
    ``page_table [B, PMAX]`` names; the pools are only read, and K and V may
    be one tensor (MLA passes its latent pool twice). A length past the
    table's capacity is clamped to ``PMAX * page_size``. Returns
    [B, KH, G, D] in ``out_dtype``. On the card an e4m3 pool runs the
    kernel's e4m3 branch: nothing dequantizes it first."""
    if sinks is not None or softcap is not None:
        raise NotImplementedError(
            "paged_decode_attention: attention sinks and logit softcap are not ported yet")
    B, KH, G, D = q.shape
    P, ps, KHD = k_pages.shape
    if KH * D != KHD or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode_attention: page_table must be [B, PMAX] and "
                         "lengths [B]")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                            k_scale, v_scale, out_dtype)
    if k_pages.dtype not in CACHE_KIND or v_pages.dtype != k_pages.dtype:
        raise NotImplementedError(
            f"paged_decode_attention: {k_pages.dtype} pools are not ported to the card "
            "(int8, e4m3 and bf16 are)")
    if not paged_attention_ok(B, KH, G, D, ps):
        raise NotImplementedError(
            f"paged_decode_attention: the CUDA kernel takes D a multiple of 128 up to "
            f"{DECODE_MAX_D}, G up to {DECODE_MAX_G} and pages of a multiple of 8 rows, "
            f"got D={D}, G={G}, page_size={ps}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode_attention: out_dtype {out_dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode_attention: page_table and lengths must be int32")
    q = _build.aligned16(q.to(torch.bfloat16).contiguous())
    scales = [None if t is None else _scalar(t, q.device) for t in (k_scale, v_scale)]
    _build.check_cuda("paged_decode_attention", q, k_pages, v_pages, page_table, lengths,
                      *scales)
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must be 16-byte aligned")
    out = torch.empty(B, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("paged_decode_attention", [_build.c_ptr] * 9
                         + [_build.c_int] * 7 + [_build.c_ptr], source="decode_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
                 lengths.data_ptr(), _build.ptr(scales[0]), _build.ptr(scales[1]),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 B, page_table.shape[1], ps, KH, G, D, CACHE_KIND[k_pages.dtype],
                 _build.stream(q))
    paged_decode_attention.launches += 1
    _build.raise_on_error("paged_decode_attention", err)
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# K16: paged KV write
# ---------------------------------------------------------------------------
def page_slots(page_table: torch.Tensor, positions: torch.Tensor, page_size: int):
    """Pool targets of the tokens at ``positions`` [B, T]: (page ids, in-page
    offsets), int32 [B, T]. A position at or past the table's capacity (a
    slot at the cache cap writing on an idle tick) takes the table's last
    column, as the reference's gather clamps the column index; the offset
    is not clamped."""
    col = torch.div(positions, page_size, rounding_mode="floor").clamp(
        max=page_table.shape[1] - 1)
    pids = page_table.gather(1, col.long())
    return pids.contiguous(), (positions % page_size).to(torch.int32).contiguous()


def paged_kv_write_plain(pool: torch.Tensor, vals: torch.Tensor, pids: torch.Tensor,
                         offs: torch.Tensor) -> torch.Tensor:
    """``pool[pids, offs] = vals`` in the pool's dtype, in place; targets
    outside the pool are dropped, as the reference's XLA scatter drops
    them."""
    P, ps, _ = pool.shape
    ok = (pids >= 0) & (pids < P) & (offs >= 0) & (offs < ps)
    pool[pids[ok].long(), offs[ok].long()] = vals[ok].to(pool.dtype)
    return pool


def paged_kv_write(pool: torch.Tensor, vals: torch.Tensor, pids: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """Scatter per-token rows vals [B, T, KH*D] into pool
    [n_pages, page_size, KH*D] at (pids[b, t], offs[b, t]) IN PLACE and
    return the pool (see ``paged_kv_write_plain``)."""
    P, ps, KHD = pool.shape
    B, T = pids.shape
    if vals.shape != (B, T, KHD) or offs.shape != (B, T):
        raise ValueError(f"paged_kv_write: pool {tuple(pool.shape)}, vals "
                         f"{tuple(vals.shape)}, pids {tuple(pids.shape)}")
    if pool.device.type == "cpu":
        return paged_kv_write_plain(pool, vals, pids, offs)
    vals = vals.to(pool.dtype).contiguous()
    row_bytes = KHD * pool.element_size()
    if row_bytes % 16 or pids.dtype != torch.int32 or offs.dtype != torch.int32:
        raise ValueError("paged_kv_write: rows must be 16-byte multiples and pids/offs int32")
    pids, offs = pids.contiguous(), offs.contiguous()
    _build.check_cuda("paged_kv_write", pool, vals, pids, offs)
    if pool.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("paged_kv_write: pool and vals must be 16-byte aligned")
    fn = _build.function("paged_kv_write", [_build.c_ptr] * 4 + [_build.c_int] * 4
                         + [_build.c_ptr])
    with torch.cuda.device(pool.device):
        err = fn(pool.data_ptr(), vals.data_ptr(), pids.data_ptr(), offs.data_ptr(),
                 B * T, P, ps, row_bytes, _build.stream(pool))
    paged_kv_write.launches += 1
    _build.raise_on_error("paged_kv_write", err)
    return pool


paged_kv_write.launches = 0


def paged_kv_write_rows_plain(pools, rows, page_table: torch.Tensor,
                              positions: torch.Tensor):
    """The reference's write of a paged layer (its ``transformer.py:481-492``,
    ``mla.py:164-177``): the slots by ``page_slots``, each row padded with
    zeros to its pool's row, one ``paged_kv_write_plain`` a pool."""
    pids, offs = page_slots(page_table, positions, pools[0].shape[1])
    for pool, vals in zip(pools, rows):
        pad = pool.shape[-1] - vals.shape[-1]
        paged_kv_write_plain(pool, nn.functional.pad(vals, (0, pad)) if pad else vals,
                             pids, offs)
    return pools


def paged_kv_write_rows(pools, rows, page_table: torch.Tensor,
                        positions: torch.Tensor):
    """A paged layer's write, IN PLACE: row (b, t) of ``rows[i]`` [B, T, w]
    into ``pools[i]`` [n_pages, page_size, row] (one or two pools of one
    shape and dtype, w <= row) at page ``page_table[b, min(pos // ps,
    PMAX - 1)]``, offset ``pos % ps`` for ``pos = positions[b, t]``, zeros
    after the w values; a target outside the pool is dropped (see
    ``paged_kv_write_rows_plain``). On the card one launch of K16, which
    counts as one ``paged_kv_write`` launch. Returns ``pools``."""
    pools, rows = tuple(pools), tuple(rows)
    P, ps, R = pools[0].shape
    B, T = positions.shape
    w = rows[0].shape[-1] if rows else 0
    if (len(pools) not in (1, 2) or len(rows) != len(pools) or w > R
            or any(p.shape != pools[0].shape or p.dtype != pools[0].dtype for p in pools)
            or any(v.shape != (B, T, w) for v in rows)
            or page_table.dim() != 2 or page_table.shape[0] != B):
        raise ValueError(f"paged_kv_write_rows: pools {[tuple(p.shape) for p in pools]}, "
                         f"rows {[tuple(v.shape) for v in rows]}, page_table "
                         f"{tuple(page_table.shape)}, positions {tuple(positions.shape)}")
    if pools[0].device.type == "cpu":
        return paged_kv_write_rows_plain(pools, rows, page_table, positions)
    rows = tuple(v.to(pools[0].dtype).contiguous() for v in rows)
    item = pools[0].element_size()
    if (R * item) % 16 or (w * item) % 16:
        raise ValueError("paged_kv_write_rows: pool rows and value rows must be 16-byte "
                         "multiples")
    if positions.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise ValueError("paged_kv_write_rows: positions and page_table must be int32")
    _build.check_cuda("paged_kv_write_rows", *pools, *rows, page_table, positions)
    if any(t.data_ptr() % 16 for t in pools + rows):
        raise ValueError("paged_kv_write_rows: pools and rows must be 16-byte aligned")
    fn = _build.function("paged_kv_write_rows", [_build.c_ptr] * 6 + [_build.c_int] * 8
                         + [_build.c_ptr], source="paged_kv_write")
    second = len(pools) == 2
    with torch.cuda.device(pools[0].device):
        err = fn(pools[0].data_ptr(), pools[1].data_ptr() if second else None,
                 rows[0].data_ptr(), rows[1].data_ptr() if second else None,
                 positions.data_ptr(), page_table.data_ptr(), len(pools), B, T,
                 page_table.shape[1], P, ps, R * item, w * item, _build.stream(pools[0]))
    paged_kv_write.launches += 1
    _build.raise_on_error("paged_kv_write_rows", err)
    return pools
