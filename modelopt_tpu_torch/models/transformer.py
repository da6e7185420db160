"""Quantization-aware decoder-only transformer: the llama family,
Qwen3-MoE and DeepSeek-V2.

Port of the llama, Qwen3-MoE and DeepSeek-V2 paths of
``modelopt_tpu/models/transformer.py``: RMSNorm, RoPE (plain, llama3- or
yarn-scaled), grouped-query attention with optional per-head q/k RMSNorm
and a lane-merged [B, S, KH*D] KV cache, multi-head latent attention
(``models/mla.py``, a [B, S, pad128(r+dr)] latent cache), silu-GLU MLP,
optional fused qkv and gate_up projections, and a softmax top-k routed MoE
block with optional always-on shared experts, computed dense over all
experts, as the reference does. Module names follow the reference
(``layers_0/attn/qkv_proj``, ``layers_0/mlp/gate_up_proj``,
``layers_0/moe/down_proj``, ``layers_1/moe/shared_experts/up_proj``,
``lm_head``...), so quantize configs and reference variables address the
same paths.

Cached forwards take the reference's kernel gates: T == 1 is one
``fused_decode_attention`` step under ``fused_decode_ok``; otherwise the
chunk's K/V go in by ``dense_kv_write_pair`` (K3, one launch for both),
then T > 1 attends with ``flash_prefill_attention`` under
``flash_prefill_ok``, T == 1 with
``decode_attention`` under ``decode_attention_ok``, and anything else with
the einsum over the cache, dequantized as the reference dequantizes it.
Uncached forwards of T >= 256 rows
attend with ``flash_attention`` where its rule holds, others with an
einsum. With ``cfg.skip_softmax`` (``sparsity/skip_softmax.py``) the cache
also carries per-layer block summaries: every forward writes through
``dense_kv_write_pair`` and folds its keys into them, a decode step attends the
selected blocks with ``block_sparse_decode_attention`` and a longer
forward takes the masked einsum over the cache, as the reference does. A
paged cache (``serve/paged_cache.py``: per-layer page pools and a
``page_table``) writes through ``paged_kv_write_rows`` at every T (K16 finds
each row's page and writes K and V in one launch); T == 1
attends with ``paged_decode_attention`` under the reference's rule, other
forwards gather the pages dense and take the reference's masked einsum.
Caches hold bf16 values or int8 or e4m3 codes with the k / v quantizers'
f32 scales (FP8_KV_CFG's e4m3 codes go to every kernel above, each
decoding them as the reference does; an MLA latent cache too).
Caches are updated IN PLACE (the reference donates
them through jitted steps instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.attention import (decode_attention, decode_attention_ok, dense_kv_write_pair,
                                 fused_decode_attention, fused_decode_ok)
from ..kernels.block_sparse_attention import (block_sparse_decode_attention,
                                              block_sparse_decode_attention_xla, block_sparse_ok)
from ..kernels.flash_attention import (flash_attention, flash_attention_ok,
                                       flash_prefill_attention, flash_prefill_ok)
from ..kernels.paged_attention import (paged_attention_ok, paged_decode_attention,
                                       paged_gather_dense, paged_kv_write_rows)
from ..nn.layers import QuantDense, QuantEinsum, QuantEmbed, RMSNorm
from ..nn.quantizer import TensorQuantizer, assign_paths
from ..sparsity.skip_softmax import init_block_summaries, select_blocks, update_block_summaries


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The reference's DecoderConfig, restricted to the fields the llama
    family, Qwen3-MoE and DeepSeek-V2 use. Routing variants the port does
    not run yet raise NotImplementedError."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: Optional[int] = None  # None = MHA
    head_dim: Optional[int] = None
    intermediate_size: int = 5632
    activation: str = "silu_glu"
    norm: str = "rmsnorm"
    positions: str = "rope"
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    attn_bias: bool = False
    mlp_bias: bool = False
    norm_eps: float = 1e-5
    # RoPE frequency scaling as (key, value) pairs, e.g.
    # (("rope_type", "llama3"), ("factor", 8.0), ...); None = plain RoPE
    rope_scaling: Optional[tuple] = None
    fused_qkv: bool = False
    fused_gate_up: bool = False
    # the embedding table doubles as the LM head (no lm_head parameters)
    tie_word_embeddings: bool = False
    # Qwen3-style per-head RMSNorm on q/k (over head_dim, before RoPE)
    qk_norm: bool = False
    # MoE; 0 experts = dense MLP. Dense MLPs for the first k layers.
    num_experts: int = 0
    experts_per_token: int = 2
    moe_intermediate_size: Optional[int] = None  # None = intermediate_size
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    first_k_dense: int = 0
    router_bias: bool = False
    # routing variants of the reference not ported yet (defaults only)
    router_score: str = "softmax"
    router_correction_bias: bool = False
    n_group: Optional[int] = None
    n_shared_experts: int = 0
    moe_activation: str = "silu_glu"
    moe_bias: bool = False
    # Multi-head Latent Attention (DeepSeek V2/V3, models/mla.py): the KV
    # cache stores one shared latent row [kv_lora_rank + qk_rope_head_dim]
    # per token instead of per-head K/V
    attention_type: str = "mha"  # "mha" | "mla"
    q_lora_rank: Optional[int] = None  # None = direct q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None
    # calibrated skip-softmax decode attention: a frozen
    # sparsity.skip_softmax.SkipSoftmaxConfig, or None
    skip_softmax: Optional[Any] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.activation != "silu_glu" or self.norm != "rmsnorm" or self.positions != "rope":
            raise NotImplementedError(
                "the port's decoder covers the llama family (silu_glu, rmsnorm, rope)")
        unported = {
            "router_score": self.router_score != "softmax",
            "router_correction_bias": self.router_correction_bias,
            "n_group": bool(self.n_group and self.n_group > 1),
            "moe_activation": self.moe_activation != "silu_glu",
            "moe_bias": self.moe_bias,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"MoE options {bad} are not ported (softmax top-k routing with "
                "silu-GLU experts and shared experts is)")
        if self.attention_type not in ("mha", "mla"):
            raise NotImplementedError(f"attention_type {self.attention_type!r} is not ported")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def is_moe(self, layer: int) -> bool:
        return self.num_experts > 0 and layer >= self.first_k_dense


def make_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Static-shape KV cache: per-layer tuples of [batch, max_len, KH*D]
    (heads merged into the last dim) and per-slot ``lengths`` [batch]. MLA
    (the reference's :198-209): one shared latent row per token,
    [batch, max_len, pad128(kv_lora_rank + qk_rope_head_dim)] in "k", and a
    [batch, max_len, 0] placeholder in "v". With ``cfg.skip_softmax``: per-layer
    block summaries "kmax" / "kmin" [batch, max_len / block_size, KH, D] f32
    (one tensor a layer: they are written in place)."""
    dtype = dtype or cfg.dtype
    if cfg.attention_type == "mla":
        dc = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        kshape = (batch, max_len, -(-dc // 128) * 128)
        vshape = (batch, max_len, 0)
    else:
        kshape = vshape = (batch, max_len, cfg.kv_heads * cfg.dims_per_head)
    cache = {
        "k": tuple(torch.zeros(kshape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "v": tuple(torch.zeros(vshape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }
    if cfg.skip_softmax is not None:
        if cfg.attention_type == "mla":
            raise NotImplementedError("skip-softmax attention covers MHA caches only")
        bs = cfg.skip_softmax.block_size
        if max_len % bs:
            raise ValueError(f"max_len {max_len} not divisible by skip_softmax "
                             f"block_size {bs}")
        pairs = [init_block_summaries(batch, max_len, cfg.kv_heads, cfg.dims_per_head, bs,
                                      device) for _ in range(cfg.num_layers)]
        cache["kmax"] = tuple(p[0] for p in pairs)
        cache["kmin"] = tuple(p[1] for p in pairs)
    return cache


_FREQ_CACHE: dict = {}


def _rope_freq_on(d: int, theta: float, scaling, device):
    """``_rope_params`` kept per device: a fresh host-to-device copy in every
    layer would make each forward wait for the card twice a layer."""
    key = (d, theta, scaling, str(device))
    hit = _FREQ_CACHE.get(key)
    if hit is None:
        freq, mscale = _rope_params(d, theta, scaling)
        hit = _FREQ_CACHE[key] = (freq.to(device), mscale)
    return hit


def _yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention-magnitude correction (arXiv:2309.00071 eq. 22)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_inv_freq(d: int, theta: float, scaling: dict):
    """YaRN-scaled inverse frequencies and the cos/sin attention factor (the
    reference's ``_yarn_inv_freq``: the public formula, HF
    ``_compute_yarn_parameters`` with truncate=True), computed in float64
    and rounded to f32. Returns (inv_freq [d//2] numpy f32, factor)."""
    factor = float(scaling["factor"])
    original_max = int(scaling.get("original_max_position_embeddings", 4096))
    beta_fast = float(scaling.get("beta_fast", 32))
    beta_slow = float(scaling.get("beta_slow", 1))
    truncate = bool(scaling.get("truncate", True))
    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        mscale = scaling.get("mscale")
        mscale_all = scaling.get("mscale_all_dim")
        if mscale and mscale_all:
            attention_factor = (_yarn_get_mscale(factor, mscale)
                                / _yarn_get_mscale(factor, mscale_all))
        else:
            attention_factor = _yarn_get_mscale(factor)
    pos_freqs = theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (factor * pos_freqs)

    def corr_dim(rot):
        return d * math.log(original_max / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, d - 1)
    ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0, 1)
    extra_factor = 1.0 - ramp
    inv_freq = inv_inter * (1 - extra_factor) + inv_extra * extra_factor
    return inv_freq.astype(np.float32), float(attention_factor)


def _rope_params(d: int, theta: float, scaling):
    """(inverse frequencies [d//2] f32, cos/sin factor) for plain, llama3 or
    yarn RoPE."""
    half = d // 2
    if scaling is None:
        return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half)), 1.0
    sdict = dict(scaling)
    if sdict.get("rope_type") == "yarn":
        inv, mscale = _yarn_inv_freq(d, theta, sdict)
        return torch.from_numpy(inv), mscale
    if sdict.get("rope_type") != "llama3":
        raise NotImplementedError(f"rope scaling {sdict.get('rope_type')!r} is not ported")
    # Llama-3.1+ context extension (public formula): low-frequency bands
    # divide by factor, high-frequency bands keep, a smooth ramp between
    factor = float(sdict["factor"])
    lowf = float(sdict.get("low_freq_factor", 1.0))
    highf = float(sdict.get("high_freq_factor", 4.0))
    old_ctx = float(sdict.get("original_max_position_embeddings", 8192))
    base_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    wavelen = 2 * math.pi / base_freq
    smooth = (old_ctx / wavelen - lowf) / (highf - lowf)
    smoothed = (1 - smooth) * base_freq / factor + smooth * base_freq
    out_f = np.where(wavelen > old_ctx / lowf, base_freq / factor,
                     np.where(wavelen < old_ctx / highf, base_freq, smoothed))
    return torch.from_numpy(out_f.astype(np.float32)), 1.0


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float, scaling=None):
    """Rotary embeddings on x [B, T, heads, D] at positions [B, T]. As the
    reference's code does, the two HALVES of the head dim rotate together
    (x[..., :D/2] with x[..., D/2:]), not interleaved pairs; cos and sin
    carry yarn's attention factor."""
    d = x.shape[-1]
    half = d // 2
    freq, mscale = _rope_freq_on(d, theta, scaling, x.device)
    angles = positions[..., None].float() * freq                 # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        H, KH, D, Hd = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.hidden_size

        def dense(fin, fout):
            return QuantDense(fin, fout, use_bias=cfg.attn_bias, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, device=device)

        if cfg.fused_qkv:
            self.qkv_proj = dense(Hd, (H + 2 * KH) * D)
        else:
            self.q_proj = dense(Hd, H * D)
            self.k_proj = dense(Hd, KH * D)
            self.v_proj = dense(Hd, KH * D)
        self.o_proj = dense(H * D, Hd)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(D, epsilon=cfg.norm_eps, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype, device=device)
            self.k_norm = RMSNorm(D, epsilon=cfg.norm_eps, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype, device=device)
        self.q_quantizer = TensorQuantizer()
        self.k_quantizer = TensorQuantizer()
        self.v_quantizer = TensorQuantizer()

    def forward(self, x, positions, mask=None, cache_kv=None):
        """cache_kv: None, (k_cache, v_cache, positions), paged
        (k_pool, v_pool, positions, page_table) or skip-softmax
        (k_cache, v_cache, positions, kmax, kmin) — caches and summaries
        written in place. Returns (out, the cache tensors or None)."""
        cfg = self.cfg
        H, KH, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        G = H // KH
        B, T, _ = x.shape
        if cfg.fused_qkv:
            q, k, v = torch.split(self.qkv_proj(x), [H * D, KH * D, KH * D], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, KH, D)
        v = v.reshape(B, T, KH, D)
        if cfg.qk_norm:  # Qwen3: RMSNorm over head_dim on q and k, before RoPE
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        q = self.q_quantizer(q)

        if cache_kv is not None:
            ck, cv, positions_kv = cache_kv[:3]
            page_table = cache_kv[3] if len(cache_kv) == 4 else None
            summaries = cache_kv[3:] if len(cache_kv) == 5 else None
            if ck.dtype in (torch.int8, torch.float8_e4m3fn):
                k_codes, k_scale = self.k_quantizer(k, with_scale=True)
                v_codes, v_scale = self.v_quantizer(v, with_scale=True)
                if ck.dtype == torch.int8 and (k_scale is None or v_scale is None):
                    raise ValueError(
                        "an int8 KV cache needs CALIBRATED per-tensor int8 "
                        "k/v quantizers (INT8_KV_CFG) — a scale-1 cast "
                        "would round O(1) keys to {-1, 0, 1}")
                # an e4m3 cache with no calibrated quantizer (or in CALIB
                # phase) stores a direct cast with scale 1, as the reference
                if k_scale is None:
                    k_codes, k_scale = k_codes.to(ck.dtype), torch.ones((), device=k.device)
                if v_scale is None:
                    v_codes, v_scale = v_codes.to(cv.dtype), torch.ones((), device=v.device)
            elif ck.dtype.is_floating_point and ck.element_size() >= 2:
                k_codes, k_scale = self.k_quantizer(k).to(ck.dtype), None
                v_codes, v_scale = self.v_quantizer(v).to(cv.dtype), None
            else:
                raise NotImplementedError(f"{ck.dtype} KV caches are not ported")
            k_rows = k_codes.reshape(B, T, KH * D)
            v_rows = v_codes.reshape(B, T, KH * D)
            if page_table is not None:
                return self._paged(q, k_rows, v_rows, ck, cv, positions, positions_kv,
                                   page_table, k_scale, v_scale, mask)
            start = positions_kv[:, 0].to(torch.int32).contiguous()
            if summaries is not None:
                return self._skip_softmax(q, k_codes, k_rows, v_rows, ck, cv, start,
                                          k_scale, v_scale, mask, *summaries)
            return self._dense(q, k_rows, v_rows, ck, cv, positions, start, k_scale,
                               v_scale, mask), (ck, cv)

        k, v = self.k_quantizer(k), self.v_quantizer(v)
        if T >= 256 and flash_attention_ok(T, T, D):
            out = flash_attention(q.reshape(B, T, KH, G, D), k, v, causal=True)
            return self.o_proj(out.reshape(B, T, H * D)), None
        # einsum attention with an additive mask [B, T, S]
        return self._einsum(q, k, v, mask), None

    def _einsum(self, q, k, v, mask):
        """The reference's einsum attention: q [B, T, H, D] against keys and
        values [B, S, KH, D] in the model dtype, f32 scores plus the additive
        mask [B, T, S], probabilities rounded to the model dtype; through
        o_proj."""
        cfg = self.cfg
        H, KH, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        B, T = q.shape[:2]
        qg = q.reshape(B, T, KH, H // KH, D)
        scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) \
            / torch.sqrt(torch.tensor(float(D)))
        scores = scores + mask[:, None, None, :, :k.shape[1]]
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(cfg.dtype))
        return self.o_proj(out.reshape(B, T, H * D))

    def _dense(self, q, k_rows, v_rows, ck, cv, positions, start, k_scale, v_scale, mask):
        """The dense cache under the reference's gates (its :495-529 write,
        :578-593 prefill, :636-669 decode, then the einsum): a decode step
        under ``fused_decode_ok`` writes and attends in one kernel; any
        other forward writes its rows by ``dense_kv_write_pair``, then attends
        by ``flash_prefill_attention`` (T > 1, ``flash_prefill_ok``),
        ``decode_attention`` (T == 1, ``decode_attention_ok``) or the
        masked einsum over the cache, codes times their scale in the model
        dtype. K5 takes the cache's scales for int8 codes too (the
        reference passes them for e4m3 only). Through o_proj."""
        cfg = self.cfg
        H, KH, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        G = H // KH
        B, T = q.shape[:2]
        S = ck.shape[1]
        if T == 1 and fused_decode_ok((B, KH, G, D), S, ck.dtype):
            out, _, _ = fused_decode_attention(
                q[:, 0].reshape(B, KH, G, D).contiguous(), k_rows, v_rows, ck, cv, start,
                k_scale=k_scale, v_scale=v_scale, out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, 1, H * D))
        dense_kv_write_pair(ck, cv, k_rows.contiguous(), v_rows.contiguous(), start)
        if T > 1 and flash_prefill_ok(T, S, D, ck.dtype):
            out = flash_prefill_attention(
                q.reshape(B, T, KH, G, D).contiguous(), ck, cv, start,
                k_scale=k_scale, v_scale=v_scale, out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, T, H * D))
        if T == 1 and decode_attention_ok((B, KH, G, D), S, ck.dtype):
            lengths = (positions[:, 0] + 1).to(torch.int32).contiguous()
            out = decode_attention(q[:, 0].reshape(B, KH, G, D).contiguous(), ck, cv,
                                   lengths, k_scale=k_scale, v_scale=v_scale,
                                   out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, 1, H * D))
        k = ck.view(B, S, KH, D)
        v = cv.view(B, S, KH, D)
        if k_scale is not None:
            k = k.to(cfg.dtype) * k_scale.to(cfg.dtype)
            v = v.to(cfg.dtype) * v_scale.to(cfg.dtype)
        if mask is None:  # the Decoder builds none for the dense cache's kernels
            key_pos = torch.arange(S, device=q.device)
            mask = torch.where(key_pos[None, None, :] <= positions[:, :, None], 0.0,
                               -1e9).float()
        return self._einsum(q, k, v, mask)

    def _skip_softmax(self, q, k_codes, k_rows, v_rows, ck, cv, start, k_scale, v_scale,
                      mask, kmax, kmin):
        """The skip-softmax cache (the reference's :499-572): rows written
        through ``dense_kv_write_pair`` at every T (the fused decode step is not
        taken), the keys' real values (codes times k_scale) folded into the
        block summaries; a decode step attends the blocks ``select_blocks``
        keeps (``block_sparse_decode_attention`` under ``block_sparse_ok``,
        else the reference's gather-and-softmax form), a longer forward
        takes the masked einsum over the dequantized cache."""
        cfg = self.cfg
        sscfg = cfg.skip_softmax
        H, KH, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        G = H // KH
        B, T = q.shape[:2]
        dense_kv_write_pair(ck, cv, k_rows.contiguous(), v_rows.contiguous(), start)
        k_real = k_codes.float()
        if k_scale is not None:
            k_real = k_real * k_scale.float()
        update_block_summaries(kmax, kmin, k_real, start, sscfg.block_size)
        new_kv = (ck, cv, kmax, kmin)
        if T == 1:
            qg = q[:, 0].reshape(B, KH, G, D)
            lengths = start + 1
            sel, nvalid = select_blocks(qg, kmax, kmin, lengths, sscfg)
            attend = (block_sparse_decode_attention
                      if block_sparse_ok(B, KH, G, D, sscfg.block_size)
                      else block_sparse_decode_attention_xla)
            out = attend(qg.contiguous(), ck, cv, sel, nvalid, lengths, k_scale=k_scale,
                         v_scale=v_scale, block_size=sscfg.block_size, out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, 1, H * D)), new_kv
        k = ck.view(B, -1, KH, D)
        v = cv.view(B, -1, KH, D)
        if k_scale is not None:
            k = k.to(cfg.dtype) * k_scale.to(cfg.dtype)
            v = v.to(cfg.dtype) * v_scale.to(cfg.dtype)
        return self._einsum(q, k, v, mask), new_kv

    def _paged(self, q, k_rows, v_rows, k_pool, v_pool, positions, positions_kv, page_table,
               k_scale, v_scale, mask):
        """The paged cache (the reference's :481-492 write, :603-635 read):
        rows written through the page table at every T; a decode step under
        ``paged_attention_ok`` attends through the pools in place, any other
        forward gathers the pages dense ([B, PMAX * page_size] keys),
        dequantizes them in the model dtype and takes the masked einsum."""
        cfg = self.cfg
        H, KH, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        B, T = q.shape[:2]
        ps = k_pool.shape[1]
        paged_kv_write_rows((k_pool, v_pool), (k_rows, v_rows), page_table, positions_kv)
        new_kv = (k_pool, v_pool)
        if T == 1 and paged_attention_ok(B, KH, H // KH, D, ps):
            lengths = (positions[:, 0] + 1).to(torch.int32).contiguous()
            out = paged_decode_attention(
                q[:, 0].reshape(B, KH, H // KH, D).contiguous(), k_pool, v_pool, page_table,
                lengths, k_scale=k_scale, v_scale=v_scale, out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, 1, H * D)), new_kv
        k = paged_gather_dense(k_pool, page_table).reshape(B, -1, KH, D)
        v = paged_gather_dense(v_pool, page_table).reshape(B, -1, KH, D)
        if k_scale is not None:
            k = k.to(cfg.dtype) * k_scale.to(cfg.dtype)
            v = v.to(cfg.dtype) * v_scale.to(cfg.dtype)
        return self._einsum(q, k, v, mask), new_kv


class MLP(nn.Module):
    """silu-GLU MLP of width ``intermediate_size`` (default the config's)."""

    def __init__(self, cfg: DecoderConfig, device="cuda", intermediate_size=None):
        super().__init__()
        self.cfg = cfg
        Hd, I = cfg.hidden_size, intermediate_size or cfg.intermediate_size

        def dense(fin, fout):
            return QuantDense(fin, fout, use_bias=cfg.mlp_bias, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, device=device)

        if cfg.fused_gate_up:
            self.gate_up_proj = dense(Hd, 2 * I)
        else:
            self.gate_proj = dense(Hd, I)
            self.up_proj = dense(Hd, I)
        self.down_proj = dense(I, Hd)

    def forward(self, x):
        if self.cfg.fused_gate_up:
            gate, up = torch.chunk(self.gate_up_proj(x), 2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(nn.functional.silu(gate) * up)


class Router(nn.Module):
    """The MoE router: an unquantized f32 linear layer (the reference's
    ``nn.Dense(E, dtype=float32)``), kernel [hidden, E] in ``param_dtype``
    cast to f32 for the product."""

    def __init__(self, in_features: int, n_experts: int, use_bias: bool,
                 param_dtype: torch.dtype, device="cuda"):
        super().__init__()
        self.path = ""
        self.kernel = nn.Parameter(torch.empty(in_features, n_experts, dtype=param_dtype,
                                               device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(n_experts, dtype=param_dtype, device=device),
                                  requires_grad=False) if use_bias else None)

    def forward(self, x):
        y = torch.matmul(x.float(), self.kernel.float())
        return y if self.bias is None else y + self.bias.float()


class MoEBlock(nn.Module):
    """Softmax top-k routed experts (Qwen3-MoE / Mixtral / DeepSeek-V2
    semantics of the reference's MoEBlock): affinities over all experts, the
    top ``experts_per_token`` selected, their weights gathered from the
    affinities, renormalised (``norm_topk_prob``) and post-scaled. Compute is
    dense over all experts, masked by the gates, as in the reference; the
    down-projection takes the gates and returns the combined [B, T, hidden]
    (one fused kernel on the W4A8 decode path). DeepSeek's
    ``n_shared_experts`` add one always-on MLP of width
    ``n_shared_experts * moe_intermediate_size`` (``shared_experts``) to the
    routed output."""

    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        E, Hd = cfg.num_experts, cfg.hidden_size
        inter = cfg.moe_intermediate_size or cfg.intermediate_size
        self.router = Router(Hd, E, cfg.router_bias, cfg.param_dtype, device)

        def experts(shape, spec):
            return QuantEinsum(spec, shape, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                               device=device)

        self.gate_proj = experts((E, Hd, inter), "btd,edf->btef")
        self.up_proj = experts((E, Hd, inter), "btd,edf->btef")
        self.down_proj = experts((E, inter, Hd), "bteo,eod->bted")
        if cfg.n_shared_experts:
            self.shared_experts = MLP(cfg, device, cfg.n_shared_experts * inter)

    def route(self, x):
        """x [B, T, hidden] -> (gates [B, T, E] f32, selected expert ids
        [B, T, k], affinities [B, T, E])."""
        cfg = self.cfg
        E, k = cfg.num_experts, cfg.experts_per_token
        scores = torch.softmax(self.router(x), dim=-1)
        _, sel = torch.topk(scores, k, dim=-1)
        weights = scores.gather(-1, sel)
        if cfg.norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * cfg.routed_scaling_factor
        # compare-and-sum into a dense gate matrix, as the reference does
        eids = torch.arange(E, device=x.device)
        gates = torch.where(sel[..., None] == eids, weights[..., None], 0.0).sum(dim=-2)
        return gates, sel, scores

    def forward(self, x):
        gates, _, _ = self.route(x)
        h = nn.functional.silu(self.gate_proj(x)) * self.up_proj(x)  # [B, T, E, I]
        out = self.down_proj(h, gates=gates.to(self.cfg.dtype))
        if self.cfg.n_shared_experts:
            out = out + self.shared_experts(x)
        return out


class Block(nn.Module):
    def __init__(self, cfg: DecoderConfig, device="cuda", layer: int = 0):
        super().__init__()

        def norm():
            return RMSNorm(cfg.hidden_size, epsilon=cfg.norm_eps, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)

        self.input_norm = norm()
        if cfg.attention_type == "mla":
            from .mla import MLAttention

            self.attn = MLAttention(cfg, device)
        else:
            self.attn = Attention(cfg, device)
        self.post_attn_norm = norm()
        if cfg.is_moe(layer):
            self.moe = MoEBlock(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, positions, mask=None, cache_kv=None):
        h, new_kv = self.attn(self.input_norm(x), positions, mask, cache_kv)
        x = x + h
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.post_attn_norm(x)), new_kv


class Decoder(nn.Module):
    """Causal LM. forward(input_ids, cache=None, positions=None,
    logits_index=None) -> (logits, new_cache)."""

    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = QuantEmbed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                       param_dtype=cfg.param_dtype, device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", Block(cfg, device, layer=i))
        self.final_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                  dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                  device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = QuantDense(cfg.hidden_size, cfg.vocab_size, use_bias=False,
                                      dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                      device=device)
        assign_paths(self)

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, cache=None, positions=None, logits_index=None):
        """``cache``: a ``make_cache`` or ``make_paged_cache`` dict (its k/v
        tensors are written in place; the returned cache carries lengths + T
        and the page table). ``logits_index`` [B]:
        compute logits only at that position per row -> [B, V]."""
        B, T = input_ids.shape
        dev = input_ids.device
        x = self.embed_tokens(input_ids)
        if positions is None:
            base = (cache["lengths"][:, None] if cache is not None
                    else torch.zeros(B, 1, dtype=torch.int32, device=dev))
            positions = base + torch.arange(T, dtype=torch.int32, device=dev)[None]
        paged = cache is not None and "page_table" in cache
        # paged wins over skip-softmax, as in the reference
        skip = cache is not None and not paged and "kmax" in cache
        mask = None
        if cache is None:
            causal = positions[:, None, :] <= positions[:, :, None]
            mask = torch.where(causal, 0.0, -1e9).float()
        elif paged or skip or self.cfg.attention_type == "mla":
            # the cached einsum paths (MLA prefill and bf16-cache decode, the
            # paged gather path, skip-softmax prefill): keys at cache rows <=
            # the query's position, [B, T, S]; paged, S is the table's
            # capacity PMAX * page_size
            S = (cache["page_table"].shape[1] * cache["k"][0].shape[1] if paged
                 else cache["k"][0].shape[1])
            key_pos = torch.arange(S, device=dev)
            mask = torch.where(key_pos[None, None, :] <= positions[:, :, None], 0.0,
                               -1e9).float()
        ks, vs = [], []
        for i, layer in enumerate(self.layers()):
            cache_kv = None
            if cache is not None:
                cache_kv = (cache["k"][i], cache["v"][i], positions)
                if paged:
                    cache_kv = cache_kv + (cache["page_table"],)
                elif skip:
                    cache_kv = cache_kv + (cache["kmax"][i], cache["kmin"][i])
            x, new_kv = layer(x, positions, mask, cache_kv)
            if new_kv is not None:
                ks.append(new_kv[0])
                vs.append(new_kv[1])
        new_cache = None
        if cache is not None:
            new_cache = {"k": tuple(ks), "v": tuple(vs), "lengths": cache["lengths"] + T}
            if paged:
                new_cache["page_table"] = cache["page_table"]
            if skip:
                new_cache["kmax"] = cache["kmax"]
                new_cache["kmin"] = cache["kmin"]
        x = self.final_norm(x)
        if logits_index is not None:
            x = x[torch.arange(B, device=dev), logits_index.long()]
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.attend(x), new_cache
        return self.lm_head(x), new_cache


def llama_config(**overrides) -> DecoderConfig:
    base = dict(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=11008, activation="silu_glu",
        norm="rmsnorm", positions="rope", rope_theta=10000.0,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def llama3_8b_config(**overrides) -> DecoderConfig:
    base = dict(
        vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=500000.0,
        max_position_embeddings=8192,
    )
    base.update(overrides)
    return llama_config(**base)


def qwen3_moe_config(**overrides) -> DecoderConfig:
    """Qwen3-MoE (Qwen3-30B-A3B, Hugging Face ``Qwen/Qwen3-30B-A3B``
    config.json): qk-norm and softmax top-8 of 128 routed experts."""
    base = dict(
        vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
        num_kv_heads=4, head_dim=128, intermediate_size=6144,
        moe_intermediate_size=768, num_experts=128, experts_per_token=8,
        norm_topk_prob=True, qk_norm=True, rope_theta=1e6, norm_eps=1e-6,
        max_position_embeddings=40960,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def tiny_moe_test_config(**overrides) -> DecoderConfig:
    """Small Qwen3-MoE-shaped config for tests: 2 layers, 2 heads and 1 KV
    head of head_dim 128 (the attention kernels' D), 4 experts, top-2,
    qk-norm; widths whole int4 blocks (K/2 % 128 == 0)."""
    base = dict(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
        num_kv_heads=1, head_dim=128, intermediate_size=512,
        moe_intermediate_size=256, num_experts=4, experts_per_token=2,
        norm_topk_prob=True, qk_norm=True, rope_theta=1e6, norm_eps=1e-6,
        max_position_embeddings=256,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def deepseek_v2_lite_config(**overrides) -> DecoderConfig:
    """DeepSeek-V2-Lite (Hugging Face ``deepseek-ai/DeepSeek-V2-Lite``
    config.json): MLA with r=512 and no q compression, yarn RoPE, 64
    softmax-routed experts (top-6, no renormalisation) plus 2 shared, a
    dense first layer."""
    base = dict(
        vocab_size=102400, hidden_size=2048, num_layers=27, num_heads=16,
        intermediate_size=10944, moe_intermediate_size=1408,
        num_experts=64, experts_per_token=6, n_shared_experts=2,
        norm_topk_prob=False, first_k_dense=1, rope_theta=10000.0,
        rope_scaling=(("rope_type", "yarn"), ("factor", 40.0),
                      ("original_max_position_embeddings", 4096),
                      ("beta_fast", 32.0), ("beta_slow", 1.0),
                      ("mscale", 0.707), ("mscale_all_dim", 0.707)),
        max_position_embeddings=163840,
        attention_type="mla", q_lora_rank=None, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def tiny_mla_test_config(**overrides) -> DecoderConfig:
    """Small MLA config for tests (the reference's): a low-rank q, a latent
    cache, shared and routed experts."""
    base = dict(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
        intermediate_size=128, moe_intermediate_size=64,
        num_experts=4, experts_per_token=2, n_shared_experts=1,
        first_k_dense=1, max_position_embeddings=128,
        attention_type="mla", q_lora_rank=32, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def small_mla_compressed_config(**overrides) -> DecoderConfig:
    """Small DeepSeek-V2-shaped config whose widths reach the compressed
    kernels: hidden 256, 2 heads, r=128 and dr=64 (a 192-wide latent row
    padded to 256), a dense first layer of width 320 (not a whole number
    of int4 blocks, so fake-quantized like V2-Lite's 10944), 4 experts of
    width 384 (K/2 = 192: straddle blocks, like 1408), top-2, 2 shared
    experts, V2-Lite's yarn scaling."""
    base = dict(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
        intermediate_size=320, moe_intermediate_size=384,
        num_experts=4, experts_per_token=2, n_shared_experts=2,
        norm_topk_prob=False, first_k_dense=1, rope_theta=10000.0,
        rope_scaling=deepseek_v2_lite_config().rope_scaling,
        max_position_embeddings=256,
        attention_type="mla", q_lora_rank=None, kv_lora_rank=128,
        qk_nope_head_dim=64, qk_rope_head_dim=64, v_head_dim=64,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def tiny_test_config(**overrides) -> DecoderConfig:
    """Small config for tests: 2 layers, GQA, RoPE."""
    base = dict(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_position_embeddings=128,
    )
    base.update(overrides)
    return llama_config(**base)
