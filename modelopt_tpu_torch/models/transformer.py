"""Quantization-aware decoder-only transformer, llama family.

Port of the llama path of ``modelopt_tpu/models/transformer.py``: RMSNorm,
RoPE (plain or llama3-scaled), grouped-query attention with a
lane-merged [B, S, KH*D] KV cache, silu-GLU MLP, optional fused qkv and
gate_up projections. Module names follow the reference
(``layers_0/attn/qkv_proj``, ``layers_0/mlp/gate_up_proj``, ``lm_head``...),
so quantize configs and reference variables address the same paths.

Cached forwards go through the kernels: T > 1 writes the chunk's K/V with
``dense_kv_write`` then attends with ``flash_prefill_attention``; T == 1 is
one ``fused_decode_attention`` step. Caches are updated IN PLACE (the
reference donates them through jitted steps instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kernels.attention import dense_kv_write, fused_decode_attention
from ..kernels.flash_attention import flash_prefill_attention
from ..nn.layers import QuantDense, QuantEmbed, RMSNorm
from ..nn.quantizer import TensorQuantizer, assign_paths


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The reference's DecoderConfig, restricted to the fields the llama
    family uses."""

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
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.activation != "silu_glu" or self.norm != "rmsnorm" or self.positions != "rope":
            raise NotImplementedError(
                "the port's decoder covers the llama family (silu_glu, rmsnorm, rope)")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


def make_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Static-shape KV cache: per-layer tuples of [batch, max_len, KH*D]
    (heads merged into the last dim) and per-slot ``lengths`` [batch]."""
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.kv_heads * cfg.dims_per_head)
    return {
        "k": tuple(torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "v": tuple(torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }


_FREQ_CACHE: dict = {}


def _rope_freq_on(d: int, theta: float, scaling, device) -> torch.Tensor:
    """``_rope_freq`` kept per device: a fresh host-to-device copy in every
    layer would make each forward wait for the card twice a layer."""
    key = (d, theta, scaling, str(device))
    freq = _FREQ_CACHE.get(key)
    if freq is None:
        freq = _FREQ_CACHE[key] = _rope_freq(d, theta, scaling).to(device)
    return freq


def _rope_freq(d: int, theta: float, scaling) -> torch.Tensor:
    half = d // 2
    if scaling is None:
        return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))
    sdict = dict(scaling)
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
    return torch.from_numpy(out_f.astype(np.float32))


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float, scaling=None):
    """Rotary embeddings on x [B, T, heads, D] at positions [B, T]. As the
    reference's code does, the two HALVES of the head dim rotate together
    (x[..., :D/2] with x[..., D/2:]), not interleaved pairs."""
    d = x.shape[-1]
    half = d // 2
    freq = _rope_freq_on(d, theta, scaling, x.device)
    angles = positions[..., None].float() * freq                 # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
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
        self.q_quantizer = TensorQuantizer()
        self.k_quantizer = TensorQuantizer()
        self.v_quantizer = TensorQuantizer()

    def forward(self, x, positions, mask=None, cache_kv=None):
        """cache_kv: None or (k_cache, v_cache, positions) — caches written in
        place. Returns (out, (k_cache, v_cache) or None)."""
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
        q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        q = self.q_quantizer(q)

        if cache_kv is not None:
            ck, cv, positions_kv = cache_kv
            if ck.dtype == torch.int8:
                k_codes, k_scale = self.k_quantizer(k, with_scale=True)
                v_codes, v_scale = self.v_quantizer(v, with_scale=True)
                if k_scale is None or v_scale is None:
                    raise ValueError(
                        "an int8 KV cache needs CALIBRATED per-tensor int8 "
                        "k/v quantizers (INT8_KV_CFG) — a scale-1 cast "
                        "would round O(1) keys to {-1, 0, 1}")
            elif ck.dtype.is_floating_point and ck.element_size() >= 2:
                k_codes, k_scale = self.k_quantizer(k).to(ck.dtype), None
                v_codes, v_scale = self.v_quantizer(v).to(cv.dtype), None
            else:
                raise NotImplementedError(f"{ck.dtype} KV caches are not ported")
            k_rows = k_codes.reshape(B, T, KH * D)
            v_rows = v_codes.reshape(B, T, KH * D)
            start = positions_kv[:, 0].to(torch.int32).contiguous()
            if T == 1:
                out, ck, cv = fused_decode_attention(
                    q[:, 0].reshape(B, KH, G, D).contiguous(), k_rows, v_rows,
                    ck, cv, start, k_scale=k_scale, v_scale=v_scale,
                    out_dtype=cfg.dtype)
            else:
                dense_kv_write(ck, k_rows.contiguous(), start)
                dense_kv_write(cv, v_rows.contiguous(), start)
                out = flash_prefill_attention(
                    q.reshape(B, T, KH, G, D).contiguous(), ck, cv, start,
                    k_scale=k_scale, v_scale=v_scale, out_dtype=cfg.dtype)
            return self.o_proj(out.reshape(B, T, H * D)), (ck, cv)

        # uncached: einsum attention with an additive mask [B, T, S]
        k = self.k_quantizer(k)
        v = self.v_quantizer(v)
        qg = q.reshape(B, T, KH, G, D)
        scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) \
            / torch.sqrt(torch.tensor(float(D)))
        scores = scores + mask[:, None, None]
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(cfg.dtype))
        return self.o_proj(out.reshape(B, T, H * D)), None


class MLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        Hd, I = cfg.hidden_size, cfg.intermediate_size

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


class Block(nn.Module):
    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()

        def norm():
            return RMSNorm(cfg.hidden_size, epsilon=cfg.norm_eps, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)

        self.input_norm = norm()
        self.attn = Attention(cfg, device)
        self.post_attn_norm = norm()
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, mask=None, cache_kv=None):
        h, new_kv = self.attn(self.input_norm(x), positions, mask, cache_kv)
        x = x + h
        return x + self.mlp(self.post_attn_norm(x)), new_kv


class Decoder(nn.Module):
    """Causal LM. forward(input_ids, cache=None, positions=None,
    logits_index=None) -> (logits, new_cache)."""

    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = QuantEmbed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                       param_dtype=cfg.param_dtype, device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", Block(cfg, device))
        self.final_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                  dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                  device=device)
        self.lm_head = QuantDense(cfg.hidden_size, cfg.vocab_size, use_bias=False,
                                  dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                  device=device)
        assign_paths(self)

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, cache=None, positions=None, logits_index=None):
        """``cache``: a ``make_cache`` dict (its k/v tensors are written in
        place; the returned cache carries lengths + T). ``logits_index`` [B]:
        compute logits only at that position per row -> [B, V]."""
        B, T = input_ids.shape
        dev = input_ids.device
        x = self.embed_tokens(input_ids)
        if positions is None:
            base = (cache["lengths"][:, None] if cache is not None
                    else torch.zeros(B, 1, dtype=torch.int32, device=dev))
            positions = base + torch.arange(T, dtype=torch.int32, device=dev)[None]
        mask = None
        if cache is None:
            causal = positions[:, None, :] <= positions[:, :, None]
            mask = torch.where(causal, 0.0, -1e9).float()
        ks, vs = [], []
        for i, layer in enumerate(self.layers()):
            cache_kv = None if cache is None else (cache["k"][i], cache["v"][i], positions)
            x, new_kv = layer(x, positions, mask, cache_kv)
            if new_kv is not None:
                ks.append(new_kv[0])
                vs.append(new_kv[1])
        new_cache = None
        if cache is not None:
            new_cache = {"k": tuple(ks), "v": tuple(vs), "lengths": cache["lengths"] + T}
        x = self.final_norm(x)
        if logits_index is not None:
            x = x[torch.arange(B, device=dev), logits_index.long()]
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


def tiny_test_config(**overrides) -> DecoderConfig:
    """Small config for tests: 2 layers, GQA, RoPE."""
    base = dict(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_position_embeddings=128,
    )
    base.update(overrides)
    return llama_config(**base)
