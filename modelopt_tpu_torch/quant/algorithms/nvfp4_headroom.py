"""NVFP4 activation per-tensor amax with outlier headroom.

Port of ``modelopt_tpu/quant/algorithms/nvfp4_headroom.py``. NVFP4's
per-tensor scale fixes where the e4m3 block scales sit; max calibration
anchors it to the largest block seen, so a larger unseen activation
saturates. This calibration sets, per dense layer with a two-level fp
input spec and a max-calibrated amax,

    amax = max(rho * anchor, upper, 1e-12)

with ``upper`` and ``anchor`` percentiles of the per-block amax of the
captured inputs (linear interpolation, as ``np.percentile``); blocks below
``upper / 1e6`` are dropped before locating the anchor.
"""

from __future__ import annotations

import torch

from ..api import max_calibrate, register_calib_algorithm
from .capture import capture_inputs, quant_linears

_ANCHOR_FLOOR_RATIO = 1e6


def _percentile(v: torch.Tensor, q: float) -> float:
    """``np.percentile(v, q)`` (linear interpolation) of a 1-D tensor;
    ``torch.quantile`` takes at most 2^24 elements, which the block amax
    of one layer's captured rows stays under."""
    return float(torch.quantile(v, q / 100.0, interpolation="linear"))


def headroom_amax(x: torch.Tensor, block: int, anchor_percentile: float,
                  upper_percentile: float, rho: float) -> float:
    """The headroom amax of ``x`` [..., features] over blocks of ``block``
    along the last axis (a ragged tail is left out)."""
    n = (x.shape[-1] // block) * block
    bamax = x[..., :n].abs().reshape(-1, block).amax(dim=-1).float()
    upper = _percentile(bamax, upper_percentile)
    kept = bamax[bamax >= upper / _ANCHOR_FLOOR_RATIO]
    if kept.numel() == 0:
        return max(upper, 1e-12)
    anchor = _percentile(kept, anchor_percentile)
    return max(rho * anchor, upper, 1e-12)


@register_calib_algorithm("nvfp4_act_headroom")
def nvfp4_act_headroom(bundle, forward_loop=None, anchor_percentile: float = 1.0,
                       upper_percentile: float = 99.99, rho: float = 64.0,
                       max_tokens: int = 4096):
    bundle = max_calibrate(bundle, forward_loop)  # weights and the baseline amax
    captured = capture_inputs(bundle, forward_loop, max_tokens=max_tokens)
    for info in quant_linears(bundle, captured):
        aspec = info.aspec
        if (aspec is None or not aspec.enable or aspec.block is None
                or not aspec.block.two_level):
            continue
        quantizer = info.module.input_quantizer
        if quantizer.amax is None:
            continue
        bsz = dict(aspec.block.sizes).get(-1, 16)
        amax = headroom_amax(info.x, bsz, anchor_percentile, upper_percentile, rho)
        quantizer.amax = torch.tensor(amax, dtype=torch.float32, device=info.x.device)
    del captured
    return bundle
