"""SmoothQuant: move activation outliers into the weights with per-channel
scales s = act_amax^a / w_amax^(1-a); the kernel is folded with s and the
input quantizer applies pre_quant_scale = 1/s at run time.

Port of ``modelopt_tpu/quant/algorithms/smoothquant.py``."""

from __future__ import annotations

import torch

from ..api import max_calibrate, register_calib_algorithm
from .capture import capture_inputs, fused_groups, quant_linears, write_kernel

_EPS = 1e-8


def compute_smooth_scale(act_amax: torch.Tensor, w_amax: torch.Tensor,
                         alpha: float) -> torch.Tensor:
    act_amax = act_amax.clamp_min(_EPS)
    w_amax = w_amax.clamp_min(_EPS)
    s = act_amax ** alpha / w_amax ** (1.0 - alpha)
    return s.clamp(1e-4, 1e4)


def apply_group_scale(bundle, group, s: torch.Tensor):
    """Fold s into every member's kernel (in its dtype) and set the shared
    pre_quant_scale = 1/s (f32) on each member's input quantizer."""
    pqs = (1.0 / s).float()
    for info in group:
        write_kernel(info, info.kernel * s[:, None])
        info.module.input_quantizer.pre_quant_scale = pqs.clone()
    return bundle


@register_calib_algorithm("smoothquant")
def smoothquant(bundle, forward_loop=None, alpha: float = 0.5, max_tokens: int = 2048):
    captured = capture_inputs(bundle, forward_loop, max_tokens=max_tokens)
    infos = quant_linears(bundle, captured)
    # smoothing only helps where activations are quantized
    infos = [i for i in infos if i.aspec is not None and i.aspec.enable]
    for group in fused_groups(infos):
        act_amax = group[0].x.abs().amax(dim=0)  # the shared input
        w_amax = torch.stack([i.kernel.abs().amax(dim=1) for i in group]).amax(dim=0)
        bundle = apply_group_scale(bundle, group, compute_smooth_scale(act_amax, w_amax,
                                                                       alpha))
    del captured, infos
    return max_calibrate(bundle, forward_loop)
