"""Flash attention: cache-free causal attention (K14) and a prompt chunk's
queries against the slot's KV cache (K4).

Counterparts of ``modelopt_tpu/kernels/flash_attention.py::flash_attention``
and ``::flash_prefill_attention``. On CUDA tensors the wrappers launch
``csrc/flash_attention.cu`` and ``csrc/flash_prefill_attention.cu``; on CPU
tensors ``flash_attention_plain`` and ``flash_prefill_attention_plain``
compute the same functions (and serve as the card's oracles).
``flash_attention`` is an autograd function whose backward recomputes
through ``flash_attention_reference`` (the reference's ``custom_vjp`` over
its ``_xla_reference``; the TPU kernel has no backward kernel either).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import CACHE_KIND, _scalar


# ---------------------------------------------------------------------------
# K14: cache-free causal flash attention
# ---------------------------------------------------------------------------
def flash_attention_ok(T: int, S: int, D: int) -> bool:
    """Whether an uncached forward takes K14. The reference's rule for its
    TPU kernel: D % 64 == 0, S % 128 == 0 and S <= 8192; its backend test
    is not followed (on a CPU tensor the wrapper computes the kernel's
    twin). Then what the CUDA kernel takes: D = 64 or 128. Other uncached
    forwards take the einsum path, the next step of the reference's chain
    (the wrapper itself still raises on other widths, for direct
    callers)."""
    return D % 64 == 0 and S % 128 == 0 and S <= 8192 and D in (64, 128)


def _valid_keys(T: int, S: int, causal: bool, window, sink: int, device):
    """[T, S] bool: key s is attended by query position t."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    valid = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & ((kpos > qpos - window) | (kpos < sink))
    return valid


def flash_attention_plain(q, k, v, causal: bool = True, window=None, sink: int = 0):
    """The TPU kernel's math in one pass: q, k, v in f32 as they are, f32
    scores times 1/sqrt(D), -1e9 on invalid keys, f32 softmax normalized
    before the f32 PV product; the output in q's dtype. q [B, T, KH, G, D],
    k / v [B, S, KH, D]."""
    B, T, KH, G, D = q.shape
    S = k.shape[1]
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * (1.0 / (D ** 0.5))
    valid = _valid_keys(T, S, causal, window, sink, q.device)
    scores = torch.where(valid, scores, torch.tensor(-1e9, device=q.device))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bkgts,bskd->btkgd", p, v.float()).to(q.dtype)


def flash_attention_reference(q, k, v, causal: bool = True, window=None, sink: int = 0):
    """The reference's ``_xla_reference`` (its gradient's ground truth):
    scores divided by sqrt(D), -1e9 on invalid keys, softmax, in f32; the
    output in q's dtype. Differentiable."""
    B, T, KH, G, D = q.shape
    S = k.shape[1]
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) / torch.sqrt(
        torch.tensor(float(D), device=q.device))
    valid = _valid_keys(T, S, causal, window, sink, q.device)
    scores = torch.where(valid, scores, torch.tensor(-1e9, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd", p, v.float()).to(q.dtype)


def _flash_forward(q, k, v, causal, window, sink):
    B, T, KH, G, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, sink)
    if D not in (64, 128):
        raise NotImplementedError(f"flash_attention: the CUDA kernel takes D = 64 or 128, "
                                  f"got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention: the CUDA kernel takes q, k, v all bf16 or all f32, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.check_cuda("flash_attention", q, k, v)
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", [_build.c_ptr] * 4 + [_build.c_int] * 9
                         + [_build.c_float, _build.c_int, _build.c_ptr])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, KH, G, D,
                 int(causal), -1 if window is None else int(window), int(sink),
                 1.0 / (D ** 0.5), int(q.dtype == torch.float32), _build.stream(q))
    flash_attention.launches += 1
    _build.raise_on_error("flash_attention", err)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sink):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, sink)
        return _flash_forward(q, k, v, causal, window, sink)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_reference(*leaves, *ctx.opts)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True, window=None, sink: int = 0):
    """Causal grouped-query attention with no cache: q [B, T, KH, G, D]
    against k, v [B, S, KH, D] (bf16 or f32, one dtype on the card), with
    an optional sliding ``window`` (keys kpos > qpos - window) that keeps
    the first ``sink`` keys. Returns [B, T, KH, G, D] in q's dtype. The
    gradient recomputes through ``flash_attention_reference``."""
    return _FlashAttention.apply(q, k, v, causal, window, sink)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K4: cached-prefill flash attention
# ---------------------------------------------------------------------------
def flash_prefill_ok(T: int, S: int, D: int, cache_dtype) -> bool:
    """Whether a cached forward of T > 1 rows takes K4. The reference's rule
    for its TPU kernel (``flash_prefill_ok``): D % 64 == 0, S % 128 == 0,
    S <= 8192 and T >= 64 (below, its einsum is cheaper than a launch); its
    backend test is not followed (on a CPU tensor the wrapper computes the
    kernel's twin). Then what the CUDA kernel takes: D = 128 and an int8,
    e4m3 or bf16 cache. Other forwards take the einsum over the cache."""
    return (D % 64 == 0 and S % 128 == 0 and S <= 8192 and T >= 64
            and D == 128 and cache_dtype in CACHE_KIND)


def flash_prefill_attention_plain(q, ck, cv, start, k_scale=None, v_scale=None,
                                  out_dtype=torch.bfloat16):
    """The reference kernel's math in one pass: bf16 q, (code * scale) -> bf16
    keys/values (int8 or e4m3 codes cast to f32 as the reference casts
    them), f32 scores scaled by 1/sqrt(D), -1e9 past each query's absolute
    position, f32 softmax, bf16 probabilities into the PV product."""
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
    int8 or e4m3 codes with scalar k_scale/v_scale) that ALREADY hold the
    chunk's keys at rows [start, start+T); start int32 [B] the chunk's first
    absolute position. Returns [B, T, KH, G, D]. On the card an e4m3 cache
    runs the kernel's e4m3 branch: nothing dequantizes it first."""
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
    if ck.dtype not in CACHE_KIND or cv.dtype != ck.dtype:
        raise NotImplementedError(
            f"flash_prefill_attention: {ck.dtype} caches are not ported to the "
            "card (int8, e4m3 and bf16 are)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_prefill_attention: out_dtype {out_dtype}")
    if start.dtype != torch.int32 or start.shape != (B,):
        raise ValueError("flash_prefill_attention: start must be int32 [B]")
    codes = ck.dtype != torch.bfloat16
    scales = [None, None]
    if not codes and (k_scale is not None or v_scale is not None):
        raise NotImplementedError(
            "flash_prefill_attention: scaled bf16 caches are not ported")
    if codes:
        scales = [_scalar(k_scale, q.device), _scalar(v_scale, q.device)]
    q = q.to(torch.bfloat16).contiguous()
    _build.check_cuda("flash_prefill_attention", q, ck, cv, start, *scales)
    q, ck, cv = (_build.aligned16(t) for t in (q, ck, cv))
    out = torch.empty(B, T, KH, G, D, dtype=out_dtype, device=q.device)
    f32 = out_dtype == torch.float32
    fn = _build.function("flash_prefill_attention", [_build.c_ptr] * 8
                         + [_build.c_int] * 5 + [_build.c_float, _build.c_int,
                                                 _build.c_ptr])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), start.data_ptr(),
                 _build.ptr(scales[0]), _build.ptr(scales[1]),
                 out.data_ptr() if f32 else None, None if f32 else out.data_ptr(),
                 B, T, S, KH, G, 1.0 / (D ** 0.5), CACHE_KIND[ck.dtype],
                 _build.stream(q))
    flash_prefill_attention.launches += 1
    _build.raise_on_error("flash_prefill_attention", err)
    return out


flash_prefill_attention.launches = 0
