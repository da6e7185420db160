"""Shared pieces of the layer-wise calibration algorithms: input capture,
per-linear metadata and fused-group discovery.

Port of ``modelopt_tpu/quant/algorithms/capture.py``. The captured inputs
are what each dense layer's input quantizer records in CAPTURE phase
(``nn.quantizer.capture_records``, after any pre-quant scale), the
kernels are read from the layers' ``kernel`` parameters and written back
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ...core.bundle import PHASE_CAPTURE, ModelBundle
from ..config import QuantizeConfig, get_config
from ..fake_quant import _blocked, fake_quant_fp, fake_quant_int, reduce_amax
from ..qspec import QuantizerSpec
from ..qtensor import fold_experts, spec_folds, unfold_experts

# Sibling projections that deployment fuses into one GEMM share their
# pre-quant scales.
FUSION_GROUPS = (("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj"))


def active_config(bundle: ModelBundle) -> QuantizeConfig:
    for rec in reversed(bundle.records):
        if rec.mode == "quantize":
            return get_config(rec.config)
    raise ValueError("bundle has no quantize mode applied")


def capture_inputs(bundle: ModelBundle, forward_loop=None, max_tokens: int = 2048,
                   path_filter: Optional[str] = None) -> dict:
    """Run ``forward_loop``'s batches in CAPTURE phase; return
    ``{dense_path: x [K, in_features] f32}`` with K <= max_tokens: a layer's
    rows of every batch in call order, then every ``n // max_tokens``-th row
    and the first ``max_tokens`` of those. ``path_filter`` (fnmatch on
    quantizer paths) restricts the capture to some layers. Layers come in
    the reference's order (its variable tree's: by path, component by
    component)."""
    from ...nn.quantizer import capture_filter

    if forward_loop is None:
        raise ValueError("capture_inputs needs a forward_loop")
    acc: dict = {}

    def model_fn(*args, **kwargs):
        with capture_filter(path_filter):
            out, records = bundle.apply(*args, phase=PHASE_CAPTURE, capture=True, **kwargs)
        for path, vals in records.items():
            # the reference's collection path: <quantizer>/x
            dense_path = (path + "/x").rsplit("/input_quantizer/", 1)[0]
            acc.setdefault(dense_path, []).extend(vals)
        return out

    forward_loop(model_fn)
    out = {}
    for path in sorted(acc, key=lambda p: p.split("/")):  # the reference's tree order
        x = torch.cat(acc.pop(path), dim=0).float()
        n = x.shape[0]
        if n > max_tokens:
            x = x[::n // max_tokens][:max_tokens]
        out[path] = x
    return out


@dataclasses.dataclass
class LinearInfo:
    """A quantized linear layer the algorithms work on. ``kernel`` is read
    from the module each time, in f32: [in, out], or for MoE experts
    [E, in, out] the FOLDED view [in, E*out] (the pre-quant scale lives on
    the shared input, so one in-dim scale serves every expert)."""

    dense_path: str
    module: nn.Module
    wspec: Optional[QuantizerSpec]  # first weight-quantizer spec
    aspec: Optional[QuantizerSpec]  # input-quantizer spec (or None)
    x: Optional[torch.Tensor] = None  # captured input [K, in]
    moe_shape: Optional[tuple] = None  # (E, in, out) when folded

    @property
    def kernel(self) -> torch.Tensor:
        k = self.module.kernel.float()
        return fold_experts(k) if self.moe_shape is not None else k


def kernel_for_write(info: LinearInfo, new_w: torch.Tensor) -> torch.Tensor:
    """Unfold a (possibly MoE-folded) kernel back to its stored shape."""
    if info.moe_shape is None:
        return new_w
    return unfold_experts(new_w, info.moe_shape[0])


def write_kernel(info: LinearInfo, new_w: torch.Tensor) -> None:
    """Store ``new_w`` (the layout of ``info.kernel``) in the module's
    kernel, in its dtype, in place."""
    k = info.module.kernel
    k.data.copy_(kernel_for_write(info, new_w).to(k.dtype))


def quant_linears(bundle: ModelBundle, captured: dict) -> list:
    """A LinearInfo for every captured layer with a 2-D or 3-D kernel whose
    weight quantizer is enabled; 3-D expert kernels through the folded view
    (positive-axis specs, which do not fold, are skipped)."""
    cfg = active_config(bundle)
    modules = {m.path: m for m in bundle.module.modules()}
    infos = []
    for dense_path, x in captured.items():
        mod = modules.get(dense_path)
        kernel = getattr(mod, "kernel", None) if mod is not None else None
        if kernel is None or kernel.dim() not in (2, 3):
            continue
        wspecs = cfg.resolve(dense_path + "/weight_quantizer")
        aspecs = cfg.resolve(dense_path + "/input_quantizer")
        wspec = wspecs[0] if wspecs else None
        aspec = aspecs[0] if aspecs else None
        if wspec is None or not wspec.enable:
            continue
        moe_shape = None
        if kernel.dim() == 3:
            if not spec_folds(wspec):
                continue
            moe_shape = tuple(kernel.shape)
            if x is not None and x.shape[-1] != moe_shape[1]:
                continue  # the captured input does not feed this kernel
        infos.append(LinearInfo(dense_path=dense_path, module=mod, wspec=wspec,
                                aspec=aspec, x=x, moe_shape=moe_shape))
    return infos


def fused_groups(infos: list) -> list:
    """Group the linears whose inputs are shared and fused at deployment."""
    groups: dict = {}
    for info in infos:
        parent, _, leaf = info.dense_path.rpartition("/")
        key = (parent, leaf)
        for g in FUSION_GROUPS:
            if leaf in g:
                key = (parent, g)
                break
        groups.setdefault(key, []).append(info)
    return list(groups.values())


def weight_amax_map(w: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Elementwise amax (broadcast to w's shape) implied by ``spec``: the
    static grid every element of w falls into."""
    if spec.block is not None:
        xb, unblock, baxes = _blocked(w, spec)
        amax = xb.abs().amax(dim=baxes, keepdim=True)
        return unblock(amax.expand(xb.shape))
    if spec.axis is None:
        return w.abs().amax().expand(w.shape)
    return reduce_amax(w, spec.axis, keepdims=True).expand(w.shape)


def fq_with_amax(w: torch.Tensor, amax: torch.Tensor, spec: QuantizerSpec) -> torch.Tensor:
    """Fake-quantize with an explicit elementwise amax grid (the search
    algorithms perturb scales through it)."""
    if spec.is_fp:
        return fake_quant_fp(w, amax, spec.fp_format)
    return fake_quant_int(w, amax, spec.num_bits, spec.unsigned, spec.narrow_range)
