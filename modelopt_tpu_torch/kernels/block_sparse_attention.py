"""Block-sparse decode attention (K17): decode over only the KV blocks a
skip-softmax selection kept.

Counterpart of ``modelopt_tpu/kernels/block_sparse_attention.py``. The
blocks to attend come from ``sparsity/skip_softmax.py::select_blocks``:
``sel [B, NSEL]`` block indices of which the first ``nvalid[b]`` are live
(the tail aliases block 0 and is never read), over dense lane-merged caches
[B, S, KH*D] (int8 or e4m3 codes with per-tensor scales, or bf16).

On CUDA tensors the wrapper launches ``csrc/decode_attention.cu``'s
``block_sparse_decode_attention`` entry: at D = 128, G in {1, 2, 4, 8} and
blocks of 8-512 rows K15's cluster body over the selected blocks
(``csrc/cluster_decode.cuh``), else K5's one-CTA body walking them; on CPU
tensors ``block_sparse_decode_attention_plain`` computes the same function
(and serves as the card's oracle).
``block_sparse_decode_attention_xla`` is the reference's other form, a
plain softmax over the gathered dequantized blocks, which the decoder takes
outside ``block_sparse_ok``.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import CACHE_KIND, DECODE_MAX_D, DECODE_MAX_G, _attend_chunks, _scalar


def block_sparse_ok(B: int, KH: int, G: int, D: int, block_size: int) -> bool:
    """The reference's rule for its TPU kernel (D % 128 == 0,
    block_size % 8 == 0 and block_size * KH >= 128) and what the CUDA
    kernel was written for (D up to 640, G up to 16). The reference's CPU
    branch (always the xla form) is not followed: on a CPU tensor the
    wrapper computes the kernel's twin."""
    return (D % 128 == 0 and block_size % 8 == 0 and KH * G >= 1
            and block_size * KH >= 128 and D <= DECODE_MAX_D and G <= DECODE_MAX_G)


def _gather_blocks(cache, sel, block_size):
    """cache [B, S, KH*D] -> the selected blocks [B, NSEL * block_size, KH*D]."""
    B, S, KHD = cache.shape
    rows = torch.arange(B, device=cache.device)[:, None]
    blocks = cache.view(B, S // block_size, block_size, KHD)[rows, sel.long()]
    return blocks.reshape(B, -1, KHD)


def block_sparse_decode_attention_plain(q, k_cache, v_cache, sel, nvalid, lengths,
                                        k_scale=None, v_scale=None, block_size: int = 128,
                                        out_dtype=torch.bfloat16):
    """Plain PyTorch K17 with the reference kernel's rounding points: the
    selected blocks gathered in ``sel`` order and K5's twin run over them
    one block per chunk, block p of slot b at key positions
    ``sel[b, p] * block_size`` on, live where ``p < nvalid[b]``, keys at or
    past ``lengths[b]`` masked. int8 caches: q requantized per (head, group)
    row, 7-bit probability codes against each block's running max; bf16
    and e4m3 caches: f32 scores, bf16 PV operands, e4m3 codes decoded as
    the reference decodes them."""
    NSEL = sel.shape[1]
    dev = q.device
    int8 = k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8
    ks, vs = (_scalar(t, dev) for t in (k_scale, v_scale))
    kd = _gather_blocks(k_cache, sel, block_size)
    vd = _gather_blocks(v_cache, sel, block_size)
    starts = sel.long() * block_size
    live = torch.arange(NSEL, device=dev)[None, :] < nvalid.long()[:, None]
    _, l, acc = _attend_chunks(q.to(torch.bfloat16).float(), kd, vd, lengths.long(), ks,
                               int8, block_size, starts=starts, live=live)
    return (acc * (vs / l.clamp_min(1e-30))).to(out_dtype)


def block_sparse_decode_attention_xla(q, k_cache, v_cache, sel, nvalid, lengths,
                                      k_scale=None, v_scale=None, block_size: int = 128,
                                      out_dtype=torch.bfloat16):
    """The reference's fallback form: the selected blocks gathered and
    dequantized to f32, keys of dead entries or at or past ``lengths[b]``
    at -1e30, a plain f32 softmax (no 7-bit codes). Caches [B, S, KH*D]."""
    B, KH, G, D = q.shape
    NSEL = sel.shape[1]
    dev = q.device
    kg = _gather_blocks(k_cache, sel, block_size).float().view(B, -1, KH, D)
    vg = _gather_blocks(v_cache, sel, block_size).float().view(B, -1, KH, D)
    if k_scale is not None:
        kg = kg * _scalar(k_scale, dev)
    if v_scale is not None:
        vg = vg * _scalar(v_scale, dev)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), kg) / torch.sqrt(
        torch.tensor(float(D), device=dev))
    off = torch.arange(block_size, device=dev)
    pos = (sel.long()[..., None] * block_size + off).reshape(B, -1)
    slot_ok = torch.arange(NSEL, device=dev)[None, :, None] < nvalid.long()[:, None, None]
    ok = (pos < lengths.long()[:, None]) & slot_ok.expand(B, NSEL, block_size).reshape(B, -1)
    s = torch.where(ok[:, None, None, :], s, torch.tensor(-1e30, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, vg).to(out_dtype)


def block_sparse_decode_attention(q, k_cache, v_cache, sel, nvalid, lengths, k_scale=None,
                                  v_scale=None, block_size: int = 128,
                                  out_dtype=torch.bfloat16):
    """Attention of q [B, KH, G, D] over the KV blocks ``sel [B, NSEL]``
    (int32 block indices, entries p >= ``nvalid[b]`` aliasing a valid
    block) of caches [B, S, KH*D] (int8 or e4m3 codes with f32 scalar
    scales, or bf16; only read), keys below ``lengths[b]``. Returns
    [B, KH, G, D] in ``out_dtype``. Every sel entry must lie in
    [0, S / block_size): the kernel reads the blocks it names. On the card
    an e4m3 cache runs the kernel's e4m3 branch: nothing dequantizes it
    first."""
    B, KH, G, D = q.shape
    S = k_cache.shape[1]
    NSEL = sel.shape[1] if sel.dim() == 2 else -1
    if (k_cache.shape != (B, S, KH * D) or v_cache.shape != k_cache.shape
            or S % block_size):
        raise ValueError(f"block_sparse_decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, block "
                         f"{block_size}")
    if sel.shape != (B, NSEL) or nvalid.shape != (B,) or lengths.shape != (B,):
        raise ValueError("block_sparse_decode_attention: sel must be [B, NSEL], nvalid "
                         "and lengths [B]")
    if q.device.type == "cpu":
        return block_sparse_decode_attention_plain(q, k_cache, v_cache, sel, nvalid,
                                                   lengths, k_scale, v_scale, block_size,
                                                   out_dtype)
    if k_cache.dtype not in CACHE_KIND or v_cache.dtype != k_cache.dtype:
        raise NotImplementedError(
            f"block_sparse_decode_attention: {k_cache.dtype} caches are not ported to the "
            "card (int8, e4m3 and bf16 are)")
    if not block_sparse_ok(B, KH, G, D, block_size):
        raise NotImplementedError(
            f"block_sparse_decode_attention: the CUDA kernel takes D a multiple of 128 up "
            f"to {DECODE_MAX_D}, G up to {DECODE_MAX_G} and blocks of a multiple of 8 rows "
            f"with block_size * KH >= 128, got D={D}, G={G}, block_size={block_size}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"block_sparse_decode_attention: out_dtype {out_dtype}")
    if sel.dtype != torch.int32 or nvalid.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_sparse_decode_attention: sel, nvalid and lengths must be "
                         "int32")
    q = q.to(torch.bfloat16).contiguous()
    sel, nvalid, lengths = sel.contiguous(), nvalid.contiguous(), lengths.contiguous()
    scales = [None if t is None else _scalar(t, q.device) for t in (k_scale, v_scale)]
    _build.check_cuda("block_sparse_decode_attention", q, k_cache, v_cache, sel, nvalid,
                      lengths, *scales)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("block_sparse_decode_attention: caches must be 16-byte aligned")
    out = torch.empty(B, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("block_sparse_decode_attention", [_build.c_ptr] * 10
                         + [_build.c_int] * 8 + [_build.c_ptr], source="decode_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), sel.data_ptr(),
                 nvalid.data_ptr(), lengths.data_ptr(), _build.ptr(scales[0]),
                 _build.ptr(scales[1]), out.data_ptr() if f32 else None,
                 None if f32 else out.data_ptr(), B, S, NSEL, block_size, KH, G, D,
                 CACHE_KIND[k_cache.dtype], _build.stream(q))
    block_sparse_decode_attention.launches += 1
    _build.raise_on_error("block_sparse_decode_attention", err)
    return out


block_sparse_decode_attention.launches = 0
