"""AWQ: activation-aware weight quantization.

Port of ``modelopt_tpu/quant/algorithms/awq.py``:
awq_lite, a grid over the smoothing exponent a (steps of 0.1) for each
fused group, the one of least layer-output MSE on the captured inputs (f32
losses, the first minimum); awq_clip, per (block, out-channel) the amax
shrink ratio of least output error, applied by clipping the weights
(exactly equivalent under dynamic block scales: clip(w, r*amax) has block
amax r*amax); awq_full, awq_lite then awq_clip.

The chosen exponents and their losses are kept in
``bundle.metadata["awq_lite"]`` ({group: {"alpha", "losses"}}, a group
named by its first member's path) and the clip ratios' histogram in
``bundle.metadata["awq_clip"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import max_calibrate, register_calib_algorithm
from ..fake_quant import _blocked, fake_quantize
from .capture import (capture_inputs, fq_with_amax, fused_groups, quant_linears,
                      weight_amax_map, write_kernel)
from .smoothquant import apply_group_scale

_EPS = 1e-8
# elements of one [nb, K, columns] product awq_clip holds at a time (512 MB
# of f32): its loss is per (block, column), so column chunks are exact
_CLIP_CHUNK = 2 ** 27


def _group_loss(x, kernels, specs, aspecs, y_refs, s):
    """Output MSE of a fused group under smoothing scale s (shared input x),
    summed over the members, in f32."""
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    xs = x / s[None, :]
    for kernel, wspec, aspec, y_ref in zip(kernels, specs, aspecs, y_refs):
        w_s = kernel * s[:, None]
        wq = fq_with_amax(w_s, weight_amax_map(w_s, wspec), wspec)
        xin = fake_quantize(xs, aspec) if aspec is not None and aspec.enable else xs
        loss = loss + ((y_ref - xin @ wq) ** 2).mean()
    return loss


@register_calib_algorithm("awq_lite")
def awq_lite(bundle, forward_loop=None, alpha_step: float = 0.1, max_tokens: int = 1024):
    captured = capture_inputs(bundle, forward_loop, max_tokens=max_tokens)
    infos = quant_linears(bundle, captured)
    alphas = np.arange(0.0, 1.0 + 1e-6, alpha_step)
    chosen = bundle.metadata.setdefault("awq_lite", {})
    for group in fused_groups(infos):
        x = group[0].x
        kernels = [i.kernel for i in group]
        specs = [i.wspec for i in group]
        aspecs = [i.aspec for i in group]
        act_amax = x.abs().amax(dim=0).clamp_min(_EPS)
        w_amax = torch.stack([k.abs().amax(dim=1) for k in kernels]).amax(dim=0) \
            .clamp_min(_EPS)
        y_refs = [x @ k for k in kernels]
        losses = []
        for a in alphas:
            at = torch.tensor(a, dtype=torch.float32, device=x.device)
            s = (act_amax ** at / w_amax ** (1.0 - at)).clamp(1e-4, 1e4)
            losses.append(float(_group_loss(x, kernels, specs, aspecs, y_refs, s)))
        best = float(alphas[int(np.argmin(losses))])
        chosen[group[0].dense_path] = {"alpha": best, "losses": losses}
        del kernels, y_refs
        apply_group_scale(bundle, group,
                          (act_amax ** best / w_amax ** (1.0 - best)).clamp(1e-4, 1e4))
    del captured, infos
    return max_calibrate(bundle, forward_loop)


@register_calib_algorithm("awq_clip")
def awq_clip(bundle, forward_loop=None, max_tokens: int = 1024,
             shrink=(1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6, 0.55, 0.5)):
    captured = capture_inputs(bundle, forward_loop, max_tokens=max_tokens)
    infos = quant_linears(bundle, captured)
    hist = bundle.metadata.setdefault("awq_clip", {})
    for info in infos:
        wspec = info.wspec
        if wspec.block is None:
            continue  # the search targets block-quantized weights
        w = info.kernel
        if {a % w.dim() for a, _ in wspec.block.sizes} != {0}:
            continue  # only in-dim weight blocks
        wb, unblock, _ = _blocked(w, wspec)  # [nb, B, out]
        if wb.dim() != 3:
            continue
        ratios = torch.tensor(shrink, dtype=torch.float32, device=w.device)
        bamax = wb.abs().amax(dim=1, keepdim=True)  # [nb, 1, out]
        # x grouped along the in-dim as the weight blocks: [nb, K, B]
        x = info.x
        K, IN = x.shape
        nb, B, N = wb.shape
        xg = torch.nn.functional.pad(x, (0, nb * B - IN)).reshape(K, nb, B).transpose(0, 1)
        best = torch.empty(nb, N, dtype=torch.long, device=w.device)
        step = max(1, _CLIP_CHUNK // (nb * K))
        for lo in range(0, N, step):
            wc, bc = wb[..., lo:lo + step], bamax[..., lo:lo + step]
            y_ref = torch.bmm(xg, wc)
            losses = []
            for r in ratios:
                lim = r * bc
                clipped = torch.minimum(torch.maximum(wc, -lim), lim)
                wq = fq_with_amax(clipped, lim.expand(wc.shape), wspec)
                losses.append(((torch.bmm(xg, wq) - y_ref) ** 2).sum(dim=1))  # [nb, cols]
            best[:, lo:lo + step] = torch.stack(losses).argmin(dim=0)
            del y_ref, losses
        lim = ratios[best][:, None, :] * bamax
        write_kernel(info, unblock(torch.minimum(torch.maximum(wb, -lim), lim)))
        counts = torch.bincount(best.flatten(), minlength=len(shrink)).tolist()
        hist[info.dense_path] = dict(zip(shrink, counts))
    del captured, infos
    return max_calibrate(bundle, forward_loop)


@register_calib_algorithm("awq_full")
def awq_full(bundle, forward_loop=None, max_tokens: int = 1024, **kw):
    bundle = awq_lite(bundle, forward_loop, max_tokens=max_tokens)
    return awq_clip(bundle, forward_loop, max_tokens=max_tokens)
