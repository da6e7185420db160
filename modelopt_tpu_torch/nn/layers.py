"""Quantization-aware layers (port of ``modelopt_tpu/nn/layers.py``:
QuantDense, QuantEinsum, QuantEmbed, RMSNorm).

Weights keep the reference's layout: a dense kernel is [in, out], so a
layer computes ``x @ kernel``; a compressed layer holds the packed
``qweight`` ({data, scale}, the same [in, out] layout) instead of a kernel
and multiplies through ``quant.backends.qgemm``. An expert kernel
[E, in, out] is packed in its folded [in, E*out] view (quant/qtensor.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..quant.backends import act_backend_quantizes, grouped_qgemm, moe_down_qgemm, qgemm
from ..quant.qtensor import dequantize_qtensor, unfold_experts
from .quantizer import TensorQuantizer, active_quant_config


class QuantDense(nn.Module):
    """Linear layer with input/weight/output quantization points."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.path = ""
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               dtype=param_dtype, device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device), requires_grad=False)
                     if use_bias else None)
        self.register_buffer("qweight_data", None)
        self.register_buffer("qweight_scale", None)
        self.input_quantizer = TensorQuantizer()
        self.weight_quantizer = TensorQuantizer()
        self.output_quantizer = TensorQuantizer()

    @property
    def compressed(self) -> bool:
        return self.qweight_data is not None

    def set_qweight(self, qt: dict) -> None:
        """Replace the dense kernel by a packed weight {data, scale}."""
        self.kernel = None
        self.qweight_data = qt["data"]
        self.qweight_scale = qt["scale"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = active_quant_config()
        act_int8 = skip_fake = False
        if self.compressed:
            act_int8, skip_fake = _act_int8(cfg, self.path)
        x = self.input_quantizer(x, skip_fake=skip_fake)
        dtype = self.dtype or x.dtype
        if self.compressed:
            specs = cfg.resolve(self.path + "/weight_quantizer") if cfg else None
            if not specs:
                raise ValueError(f"{self.path}: qweight present but no active "
                                 "weight-quantizer spec to interpret it")
            qt = {"data": self.qweight_data, "scale": self.qweight_scale}
            y2d = qgemm(x.reshape(-1, self.in_features), qt, specs[0],
                        (self.in_features, self.features), out_dtype=dtype,
                        act_int8=act_int8, act_raw=skip_fake)
            y = y2d.reshape(*x.shape[:-1], self.features)
        else:
            kernel = self.weight_quantizer(self.kernel)
            y = torch.matmul(x.to(dtype), kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return self.output_quantizer(y)


def _act_int8(cfg, path: str):
    """(act_int8, skip_fake) of a compressed layer: whether its input
    quantizer is int8, and whether the GEMM backend performs that exact
    quantization itself (the layer then skips its fake-quant pass)."""
    aspecs = cfg.resolve(path + "/input_quantizer") if cfg else None
    act_int8 = bool(aspecs and aspecs[0].enable and not aspecs[0].is_fp
                    and aspecs[0].num_bits == 8)
    return act_int8, act_backend_quantizes(aspecs)


class QuantEinsum(nn.Module):
    """Einsum layer with quantization points (kernel ``kernel_shape``). The
    MoE experts use two contractions, ``btd,edf->btef`` (gate / up) and
    ``bteo,eod->bted`` (down, kernel [E, in, out]); given ``gates``
    [B, T, E], the down contraction returns the gate-weighted sum [B, T, out]
    (one fused kernel on the W4A8 decode path,
    ``quant.backends.moe_down_qgemm``). Compressed, the layer holds the
    folded packed weight [in, E*out] and re-associates the two MoE einsums
    so the weight is never transposed: gate / up is a plain GEMM on
    [in, E*out], down a grouped GEMM per expert. Any other einsum
    dequantizes the folded weight and contracts it, as the reference does
    outside its kernels."""

    MOE_EINSUMS = ("btd,edf->btef", "bteo,eod->bted")

    def __init__(self, einsum_str: str, kernel_shape, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.einsum_str = einsum_str
        self.kernel_shape = tuple(kernel_shape)
        self.dtype = dtype
        self.path = ""
        self.kernel = nn.Parameter(torch.empty(self.kernel_shape, dtype=param_dtype,
                                               device=device), requires_grad=False)
        self.register_buffer("qweight_data", None)
        self.register_buffer("qweight_scale", None)
        self.input_quantizer = TensorQuantizer()
        self.weight_quantizer = TensorQuantizer()
        self.output_quantizer = TensorQuantizer()

    @property
    def compressed(self) -> bool:
        return self.qweight_data is not None

    def set_qweight(self, qt: dict) -> None:
        """Replace the kernel by a packed folded weight {data, scale}."""
        self.kernel = None
        self.qweight_data = qt["data"]
        self.qweight_scale = qt["scale"]

    def forward(self, x: torch.Tensor, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = active_quant_config()
        act_int8 = skip_fake = False
        if self.compressed and self.einsum_str in self.MOE_EINSUMS:
            act_int8, skip_fake = _act_int8(cfg, self.path)
        x = self.input_quantizer(x, skip_fake=skip_fake)
        dtype = self.dtype or x.dtype
        down = self.einsum_str == "bteo,eod->bted"
        if self.compressed:
            specs = cfg.resolve(self.path + "/weight_quantizer") if cfg else None
            if not specs:
                raise ValueError(f"{self.path}: qweight present but no active "
                                 "weight-quantizer spec to interpret it")
            E, fin, fout = self.kernel_shape
            qt = {"data": self.qweight_data, "scale": self.qweight_scale}
            kw = dict(out_dtype=dtype, act_int8=act_int8, act_raw=skip_fake)
            if self.einsum_str == "btd,edf->btef":
                # the folded view is a plain [fin, E*fout] GEMM
                y2d = qgemm(x.to(dtype).reshape(-1, fin), qt, specs[0], (fin, E * fout), **kw)
                y = y2d.reshape(*x.shape[:-1], E, fout)
            elif down:
                B_, T_ = x.shape[:2]
                x3 = x.to(dtype).reshape(B_ * T_, E, fin)
                if gates is not None:
                    y = moe_down_qgemm(x3, qt, specs[0], (E, fin, fout),
                                       gates.reshape(B_ * T_, E), **kw).reshape(B_, T_, fout)
                else:
                    y = grouped_qgemm(x3, qt, specs[0], (E, fin, fout),
                                      **kw).reshape(B_, T_, E, fout)
            else:
                w2d = dequantize_qtensor(qt, specs[0], (fin, E * fout))
                kernel = unfold_experts(w2d.to(dtype), E)
                y = torch.einsum(self.einsum_str, x.to(dtype), kernel)
        else:
            kernel = self.weight_quantizer(self.kernel)
            y = torch.einsum(self.einsum_str, x.to(dtype), kernel.to(dtype))
        if down and gates is not None and y.dim() == 4:
            y = torch.einsum("bted,bte->btd", y, gates.to(dtype))
        return self.output_quantizer(y)


class QuantEmbed(nn.Module):
    """Embedding table [num_embeddings, features] with a weight quantizer;
    ``attend`` reuses it as a tied LM head."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.path = ""
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features,
                                                  dtype=param_dtype, device=device),
                                      requires_grad=False)
        self.weight_quantizer = TensorQuantizer()
        self.lm_head_quantizer = TensorQuantizer()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.weight_quantizer(self.embedding)
        out = nn.functional.embedding(ids, emb)
        return out.to(self.dtype) if self.dtype else out

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """The table as a tied LM head: ``query @ embedding.T`` in the
        query's dtype, through its own quantization point."""
        emb = self.lm_head_quantizer(self.embedding)
        return torch.matmul(query, emb.T.to(query.dtype))


class RMSNorm(nn.Module):
    """RMSNorm in f32: x * rsqrt(mean(x^2) + eps) * scale."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.path = ""
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.epsilon)
        return (y * self.scale.float()).to(self.dtype or x.dtype)
