"""Multi-head Latent Attention (DeepSeek V2/V3 family).

Port of ``modelopt_tpu/models/mla.py``. ``kv_a_proj`` compresses each
token to a latent ``c_kv [kv_lora_rank]`` plus one SHARED rotary key
``k_pe [qk_rope_head_dim]``; the cache holds only that row, quantized by
the layer's ``k_quantizer`` and zero-padded to whole 128-lane tiles
(``make_cache``). Attention runs ABSORBED in latent space: the expansion
``kv_b_proj`` is never applied to activations, its halves ``w_k`` and
``w_v`` fold into the query and the output:

    q_lat  = q_nope @ w_k                  [B, T, H, r]
    scores = q_lat . c_kv + q_pe . k_pe
    o_lat  = softmax(scores) . c_kv        [B, T, H, r]
    out    = o_lat @ w_v                   [B, T, H, dv]

The latent row is written by ``dense_kv_write`` at every T (a paged cache:
``paged_kv_write_rows``, which finds the page and zero-pads the row in one
launch). A decode step (T == 1) over an
int8 or e4m3 latent cache is exactly one KV head of read-only decode
attention: q_eff = [q_lat ; q_pe ; 0-pad] against the padded rows, K and V
the same tensor, the value projection commuted out of the PV product; it
runs ``decode_attention`` (K5) under the reference's rule
(``decode_attention_ok``), or over an int8 or e4m3 latent pool
``paged_decode_attention`` (K15) under ``paged_attention_ok``. Prefill and
decode over a bf16 cache take the reference's own einsum path over the
dequantized cache (a paged one gathered dense first). An e4m3 latent cache
holds the k quantizer's e4m3 codes with its scale, or, where the quantizer
has no calibrated scale, the rows cast to e4m3 with scale 1 (the
reference's rule; an int8 latent cache needs the scale).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.attention import decode_attention, decode_attention_ok, dense_kv_write
from ..kernels.paged_attention import (paged_attention_ok, paged_decode_attention,
                                       paged_gather_dense, paged_kv_write_rows)
from ..nn.layers import PackedWeight, QuantDense, RMSNorm
from ..nn.quantizer import TensorQuantizer, active_quant_config
from ..quant.qtensor import dequantize_qtensor
from .transformer import DecoderConfig, _rope, _yarn_get_mscale


class AbsorbedKernel(PackedWeight, nn.Module):
    """A linear layer consumed ABSORBED: its (fake-)quantized kernel
    [in, out] is read directly instead of being applied to activations.
    Names follow QuantDense (``kernel``, ``qweight``, ``weight_quantizer``),
    so presets, ``from_jax_variables`` and ``build_compressed_bundle``
    treat it like any linear layer; it has no input or output quantizer
    because no activation flows through it. Compressed, the packed weight
    is dequantized on read."""

    def __init__(self, in_features: int, features: int,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.param_dtype = param_dtype
        self.path = ""
        self.kernel = nn.Parameter(torch.empty(in_features, features, dtype=param_dtype,
                                               device=device), requires_grad=False)
        self._init_qweight()
        self.weight_quantizer = TensorQuantizer()

    def forward(self) -> torch.Tensor:
        if self.compressed:
            cfg = active_quant_config()
            specs = cfg.resolve(self.path + "/weight_quantizer") if cfg else None
            if not (specs and specs[0].enable):
                raise ValueError(f"{self.path}: qweight present but no active "
                                 "weight-quantizer spec to interpret it")
            return dequantize_qtensor(self.qweight, specs[0], (self.in_features, self.features)) \
                .to(self.param_dtype)
        return self.weight_quantizer(self.kernel)


def _softmax_scale(cfg: DecoderConfig) -> np.float32:
    """1/sqrt(dn + dr) in f32, times yarn's mscale^2 when the config sets
    ``mscale_all_dim`` (HF DeepseekV3Attention: scaling *= mscale^2), with
    the reference's f32 roundings."""
    scale = np.float32(1.0) / np.sqrt(np.float32(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
    if cfg.rope_scaling:
        sd = dict(cfg.rope_scaling)
        if sd.get("rope_type") == "yarn" and sd.get("mscale_all_dim"):
            ms = np.float32(_yarn_get_mscale(float(sd["factor"]), float(sd["mscale_all_dim"])))
            scale = np.float32(np.float32(scale * ms) * ms)
    return scale


class MLAttention(nn.Module):
    """DeepSeek-style Multi-head Latent Attention. ``cache_kv``: None,
    (latent cache [B, S, pad128(r+dr)], v placeholder [B, S, 0], positions)
    or, paged, (latent pool [n_pages, page_size, pad128(r+dr)], placeholder
    [n_pages, page_size, 0], positions, page_table); the cache is written in
    place. Returns (out, (latent cache, placeholder) or None)."""

    def __init__(self, cfg: DecoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        H, Hd = cfg.num_heads, cfg.hidden_size
        r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv = cfg.v_head_dim or dn

        def dense(fin, fout):
            return QuantDense(fin, fout, use_bias=cfg.attn_bias, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, device=device)

        def norm(features):
            return RMSNorm(features, epsilon=cfg.norm_eps, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)

        if cfg.q_lora_rank:
            self.q_a_proj = dense(Hd, cfg.q_lora_rank)
            self.q_a_norm = norm(cfg.q_lora_rank)
            self.q_b_proj = dense(cfg.q_lora_rank, H * (dn + dr))
        else:
            self.q_proj = dense(Hd, H * (dn + dr))
        self.kv_a_proj = dense(Hd, r + dr)
        self.kv_a_norm = norm(r)
        self.kv_b_proj = AbsorbedKernel(r, H * (dn + dv), cfg.param_dtype, device)
        self.o_proj = dense(H * dv, Hd)
        self.q_quantizer = TensorQuantizer()
        self.k_quantizer = TensorQuantizer()

    def forward(self, x, positions, mask=None, cache_kv=None):
        cfg = self.cfg
        dt = cfg.dtype
        B, T, _ = x.shape
        H = cfg.num_heads
        r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv = cfg.v_head_dim or dn

        # queries: optional low rank, per-head nope + rope parts
        if cfg.q_lora_rank:
            q = self.q_b_proj(self.q_a_norm(self.q_a_proj(x)))
        else:
            q = self.q_proj(x)
        q = q.reshape(B, T, H, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        q_pe = _rope(q_pe, positions, cfg.rope_theta, cfg.rope_scaling)
        q_nope = self.q_quantizer(q_nope)

        # the latent and the shared rotary key
        ckv = self.kv_a_proj(x)
        c_kv = self.kv_a_norm(ckv[..., :r])
        k_pe = _rope(ckv[..., r:][:, :, None, :], positions, cfg.rope_theta,
                     cfg.rope_scaling)[:, :, 0]
        w_kb = self.kv_b_proj().reshape(r, H, dn + dv)
        w_k, w_v = w_kb[..., :dn], w_kb[..., dn:]
        rows = torch.cat([c_kv, k_pe], dim=-1)                   # [B, T, r + dr]

        new_kv = None
        row_scale = None
        page_table = None
        if cache_kv is not None:
            ck, cv_ph, positions_kv = cache_kv[:3]
            page_table = cache_kv[3] if len(cache_kv) == 4 else None
            if ck.dtype in (torch.int8, torch.float8_e4m3fn):
                row_codes, row_scale = self.k_quantizer(rows, with_scale=True)
                if ck.dtype == torch.int8 and row_scale is None:
                    raise ValueError(
                        "an int8 latent cache needs a CALIBRATED per-tensor int8 "
                        "k_quantizer (INT8_KV_CFG-style)")
                if row_scale is None:  # e4m3 with no calibrated scale: a cast, scale 1
                    row_codes = row_codes.to(ck.dtype)
                    row_scale = torch.ones((), device=rows.device)
            elif ck.dtype.is_floating_point and ck.element_size() >= 2:
                row_codes = self.k_quantizer(rows).to(ck.dtype)
            else:
                raise NotImplementedError(f"{ck.dtype} latent caches are not ported")
            if page_table is not None:  # K16 finds the pages and zero-pads the rows
                paged_kv_write_rows((ck,), (row_codes,), page_table, positions_kv)
            else:
                pad = ck.shape[-1] - (r + dr)
                if pad:
                    row_codes = nn.functional.pad(row_codes, (0, pad))
                dense_kv_write(ck, row_codes.contiguous(),
                               positions_kv[:, 0].to(torch.int32).contiguous())
            new_kv = (ck, cv_ph)

        scale = _softmax_scale(cfg)
        q_lat = torch.einsum("bthd,rhd->bthr", q_nope.to(dt), w_k.to(dt))

        if cache_kv is not None and T == 1 and (
                decode_attention_ok((B, 1, H, ck.shape[-1]), ck.shape[1], ck.dtype)
                if page_table is None else
                ck.dtype in (torch.int8, torch.float8_e4m3fn)
                and paged_attention_ok(B, 1, H, ck.shape[-1], ck.shape[1])):
            # one shared KV head over the latent rows: q_eff scaled so the
            # kernel's 1/sqrt(Dc) becomes the MLA scale
            Dc = ck.shape[-1]
            pad = Dc - (r + dr)
            q_eff = torch.cat([q_lat[:, 0], q_pe[:, 0].to(dt),
                               torch.zeros(B, H, pad, dtype=dt, device=x.device)], dim=-1)
            # the multiplier rounded to the model dtype on the host (as the
            # reference's asarray(..., dtype)); a device scalar would cost a
            # host-to-device copy that waits for the card in every layer
            qmul = float(torch.tensor(float(scale * np.float32(Dc ** 0.5))).to(dt))
            q_eff = (q_eff * qmul)[:, None].contiguous()          # [B, 1, H, Dc]
            lengths = (positions[:, 0] + 1).to(torch.int32).contiguous()
            if page_table is None:
                o_lat = decode_attention(q_eff, ck, ck, lengths, k_scale=row_scale,
                                         v_scale=row_scale, out_dtype=dt)
            else:
                o_lat = paged_decode_attention(q_eff, ck, ck, page_table, lengths,
                                               k_scale=row_scale, v_scale=row_scale,
                                               out_dtype=dt)
            o_lat = o_lat[:, 0][..., :r]
            out = torch.einsum("bhr,rhd->bhd", o_lat, w_v.to(dt)).reshape(B, 1, H * dv)
            return self.o_proj(out), new_kv

        if cache_kv is not None:
            lat = (ck if page_table is None else paged_gather_dense(ck, page_table))
            lat = lat[..., :r + dr].to(dt)
            if row_scale is not None:
                lat = lat * row_scale.to(dt)
            c_all, kpe_all = lat[..., :r], lat[..., r:]           # [B, S, r], [B, S, dr]
        else:
            rows_q = self.k_quantizer(rows)
            c_all, kpe_all = rows_q[..., :r], rows_q[..., r:]
        # bf16 operands, f32 products and sums (preferred_element_type=f32)
        s = torch.einsum("bthr,bsr->bhts", q_lat.float(), c_all.to(dt).float())
        s = s + torch.einsum("bthd,bsd->bhts", q_pe.to(dt).float(), kpe_all.to(dt).float())
        S = c_all.shape[1]
        s = s * float(scale) + mask[:, None, :, :S]
        p = torch.softmax(s, dim=-1).to(dt)
        o_lat = torch.einsum("bhts,bsr->bthr", p, c_all.to(dt))
        out = torch.einsum("bthr,rhd->bthd", o_lat, w_v.to(dt)).reshape(B, T, H * dv)
        return self.o_proj(out), new_kv
