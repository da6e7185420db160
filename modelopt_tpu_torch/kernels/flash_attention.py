"""Cached-prefill flash attention: a prompt chunk's queries against the
slot's KV cache.

Counterpart of ``modelopt_tpu/kernels/flash_attention.py::
flash_prefill_attention``. On CUDA tensors the wrapper launches
``csrc/flash_prefill_attention.cu``; on CPU tensors
``flash_prefill_attention_plain`` computes the same function (and serves as
the card's oracle).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import _scalar


def flash_prefill_attention_plain(q, ck, cv, start, k_scale=None, v_scale=None,
                                  out_dtype=torch.bfloat16):
    """The reference kernel's math in one pass: bf16 q, (code * scale) -> bf16
    keys/values, f32 scores scaled by 1/sqrt(D), -1e9 past each query's
    absolute position, f32 softmax, bf16 probabilities into the PV product."""
    B, T, KH, G, D = q.shape
    S = ck.shape[1]
    dev = q.device

    def dequant(c, scale):
        c4 = c.reshape(B, S, KH, D)
        if scale is None:
            return c4.to(torch.bfloat16).float()
        return (c4.float() * _scalar(scale, dev)).to(torch.bfloat16).float()

    k = dequant(ck, k_scale)
    v = dequant(cv, v_scale if k_scale is not None else None)
    qb = q.to(torch.bfloat16).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qb, k) * (1.0 / (D ** 0.5))
    qpos = start.long()[:, None] + torch.arange(T, device=dev)[None]   # [B, T]
    kpos = torch.arange(S, device=dev)
    causal = kpos[None, None, :] <= qpos[:, :, None]                   # [B, T, S]
    scores = torch.where(causal[:, None, None], scores,
                         torch.tensor(-1e9, device=dev))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(torch.bfloat16).float(), v)
    return out.to(out_dtype)


def flash_prefill_attention(q, ck, cv, start, k_scale=None, v_scale=None,
                            out_dtype=torch.bfloat16):
    """q [B, T, KH, G, D] chunk queries; ck/cv [B, S, KH*D] caches (bf16, or
    int8 codes with scalar k_scale/v_scale) that ALREADY hold the chunk's
    keys at rows [start, start+T); start int32 [B] the chunk's first
    absolute position. Returns [B, T, KH, G, D]."""
    B, T, KH, G, D = q.shape
    S = ck.shape[1]
    if ck.shape != (B, S, KH * D) or cv.shape != ck.shape:
        raise ValueError(f"flash_prefill_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(ck.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, ck, cv, start, k_scale,
                                             v_scale, out_dtype)
    if D != 128:
        raise NotImplementedError(
            f"flash_prefill_attention: the CUDA kernel takes D=128, got {D}")
    if ck.dtype not in (torch.int8, torch.bfloat16) or cv.dtype != ck.dtype:
        raise NotImplementedError(
            f"flash_prefill_attention: {ck.dtype} caches are not ported to the "
            "card (int8 and bf16 are)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_prefill_attention: out_dtype {out_dtype}")
    if start.dtype != torch.int32 or start.shape != (B,):
        raise ValueError("flash_prefill_attention: start must be int32 [B]")
    int8 = ck.dtype == torch.int8
    scales = [None, None]
    if not int8 and (k_scale is not None or v_scale is not None):
        raise NotImplementedError(
            "flash_prefill_attention: scaled bf16 caches are not ported")
    if int8:
        scales = [_scalar(k_scale, q.device), _scalar(v_scale, q.device)]
    q = q.to(torch.bfloat16).contiguous()
    _build.check_cuda("flash_prefill_attention", q, ck, cv, start, *scales)
    out = torch.empty(B, T, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("flash_prefill_attention", [_build.c_ptr] * 8
                         + [_build.c_int] * 5 + [_build.c_float, _build.c_int,
                                                 _build.c_ptr])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), start.data_ptr(),
                 _build.ptr(scales[0]), _build.ptr(scales[1]),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 B, T, S, KH, G, 1.0 / (D ** 0.5), int(int8), _build.stream(q))
    flash_prefill_attention.launches += 1
    _build.raise_on_error("flash_prefill_attention", err)
    return out


flash_prefill_attention.launches = 0
