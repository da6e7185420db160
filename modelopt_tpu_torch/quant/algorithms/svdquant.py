"""SVDQuant: absorb weight outliers into a 16-bit low-rank branch and
quantize the residual.

Port of ``modelopt_tpu/quant/algorithms/svdquant.py``. Per fused group:
the SmoothQuant scale s of the shared input and the members' weights,
W' = diag(s) W, the top-r singular triplets of W' (``low_rank``; r =
min(rank, min(W'.shape) // 2), a layer with r < 1 is skipped), L1 =
U_r S_r, L2 = Vh_r; the kernel becomes the residual R = W' - L1 L2 (in
its dtype, quantized as usual), the input quantizer applies
pre_quant_scale = 1/s, and the layer keeps ``svd_lora_a = diag(1/s) L1``
and ``svd_lora_b = L2`` (f32), so ``QuantDense`` adds
``x @ svd_lora_a @ svd_lora_b`` on the raw input. MoE expert kernels are
skipped: the branch lives on QuantDense only. Then max calibration.
"""

from __future__ import annotations

import torch

from ..api import max_calibrate, register_calib_algorithm
from .capture import capture_inputs, fused_groups, quant_linears, write_kernel
from .smoothquant import compute_smooth_scale


def low_rank(w: torch.Tensor, r: int):
    """The top-r part of ``w`` [in, out], as U[:, :r] * S[:r] and Vh[:r] of
    its thin SVD: (L1 [in, r], L2 [r, out]) in f32. The top-r singular
    vectors come from an f64 eigensolve of the smaller Gram matrix (W W^T,
    or W^T W for a tall W); on the card this is both faster and closer to
    an f64 SVD than ``torch.linalg.svd`` in f32 (``svd_timing.py``). L1 @
    L2 is the projection of W on those vectors; a triplet whose singular
    value is 0 (W of rank below r) gets zero factors."""
    wd = w.double()
    if w.shape[0] <= w.shape[1]:
        u = torch.linalg.eigh(wd @ wd.T)[1][:, -r:].flip(-1)  # eigh: ascending
        p = u.T @ wd  # S_r Vh_r
        s = p.norm(dim=1)
        return (u * s).float(), (p / torch.where(s > 0, s, 1.0)[:, None]).float()
    v = torch.linalg.eigh(wd.T @ wd)[1][:, -r:].flip(-1)
    return (wd @ v).float(), v.T.float().contiguous()


@register_calib_algorithm("svdquant")
def svdquant(bundle, forward_loop=None, rank: int = 32, alpha: float = 0.5,
             max_tokens: int = 1024):
    captured = capture_inputs(bundle, forward_loop, max_tokens=max_tokens)
    infos = [i for i in quant_linears(bundle, captured) if i.moe_shape is None]
    for group in fused_groups(infos):
        act_amax = group[0].x.abs().amax(dim=0)  # the shared input
        w_amax = torch.stack([i.kernel.abs().amax(dim=1) for i in group]).amax(dim=0)
        s = compute_smooth_scale(act_amax, w_amax, alpha)
        for info in group:
            w_s = info.kernel * s[:, None]
            r = min(rank, min(w_s.shape) // 2)
            if r < 1:
                continue
            L1, L2 = low_rank(w_s, r)
            write_kernel(info, w_s - L1 @ L2)
            mod = info.module
            mod.input_quantizer.pre_quant_scale = (1.0 / s).float()
            mod.svd_lora_a = (L1 / s[:, None]).float()
            mod.svd_lora_b = L2
            del w_s, L1, L2
    del captured, infos
    return max_calibrate(bundle, forward_loop)
