"""Quantization-aware layers (port of ``modelopt_tpu/nn/layers.py``:
QuantDense, QuantEmbed, RMSNorm).

Weights keep the reference's layout: a dense kernel is [in, out], so a
layer computes ``x @ kernel``; a compressed layer holds the packed
``qweight`` ({data, scale}, the same [in, out] layout) instead of a kernel
and multiplies through ``quant.backends.qgemm``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..quant.backends import act_backend_quantizes, qgemm
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
            aspecs = cfg.resolve(self.path + "/input_quantizer") if cfg else None
            act_int8 = bool(aspecs and aspecs[0].enable and not aspecs[0].is_fp
                            and aspecs[0].num_bits == 8)
            skip_fake = act_backend_quantizes(aspecs)
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


class QuantEmbed(nn.Module):
    """Embedding table [num_embeddings, features] with a weight quantizer."""

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

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.weight_quantizer(self.embedding)
        out = nn.functional.embedding(ids, emb)
        return out.to(self.dtype) if self.dtype else out


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
