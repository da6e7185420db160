"""TensorQuantizer and the active-config context.

Port of ``modelopt_tpu/nn/quantizer.py`` for the serving slice. Each
quantizer knows its path (``layers_0/attn/k_quantizer``, the reference's
naming, set by ``assign_paths``) and resolves its specs from the active
QuantizeConfig at call time; its calibrated ``amax`` and the pre-quant
scale a calibration algorithm sets (SmoothQuant, AWQ) are buffers (None
until set). Behaviour follows the phase (core.bundle): OFF is identity;
otherwise x is first multiplied by ``pre_quant_scale`` (also when the
quantizer's own spec is disabled: weight-only AWQ rescales the activation
path), then CALIB passes x through and max-updates amax, QUANT quantizes
and CAPTURE records x (``capture_records``) and passes it through, as the
reference does.

Ported specs: per-tensor static int8 and e4m3 (calibrated amax, also the
real-codes path for the KV cache), per-channel static integer amax
(``axis=(-1,)``: the INT8 presets' weights), per-token dynamic int8, the
FP8 presets' static e4m3 activations and NVFP4's two-level blocks (a
calibrated per-tensor amax over dynamic block scales), each also in a
Hadamard-rotated basis (``rotate``: x is rotated before the spec
calibrates or quantizes it and rotated back after, as the reference
does). Sequential chains and affine specs raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
import contextvars
from fnmatch import fnmatch
from typing import Optional

import torch
from torch import nn

from ..core.bundle import PHASE_CALIB, PHASE_CAPTURE, PHASE_OFF, PHASE_QUANT, current_phase
from ..quant.config import QuantizeConfig
from ..quant.fake_quant import fake_quantize
from ..quant.formats import cast_to_fp, true_divide
from ..quant.qspec import QuantizerSpec
from ..quant.rotation import hadamard_rotate

_ACTIVE_CFG: contextvars.ContextVar = contextvars.ContextVar("quant_cfg", default=None)
# {path: [recorded inputs]} while ``capture_records`` is active
_CAPTURED: contextvars.ContextVar = contextvars.ContextVar("quant_captured", default=None)
# fnmatch pattern limiting which quantizers record in CAPTURE phase; q / k / v
# quantizers record only under one that matches them (skip-softmax threshold
# calibration sets "*attn/[qk]_quantizer")
_CAPTURE_FILTER: contextvars.ContextVar = contextvars.ContextVar(
    "quant_capture_filter", default=None)


@contextlib.contextmanager
def quantization_active(cfg: QuantizeConfig):
    """Bind the active QuantizeConfig while a bundle's module runs."""
    token = _ACTIVE_CFG.set(cfg)
    try:
        yield
    finally:
        _ACTIVE_CFG.reset(token)


def active_quant_config() -> Optional[QuantizeConfig]:
    return _ACTIVE_CFG.get()


@contextlib.contextmanager
def capture_records():
    """Collect what the quantizers record in CAPTURE phase, as a dict
    ``{path: [x.reshape(-1, x.shape[-1]), ...]}`` filled while active."""
    records: dict = {}
    token = _CAPTURED.set(records)
    try:
        yield records
    finally:
        _CAPTURED.reset(token)


@contextlib.contextmanager
def capture_filter(pattern: Optional[str]):
    """Bind the CAPTURE-phase filter pattern (see ``_CAPTURE_FILTER``)."""
    token = _CAPTURE_FILTER.set(pattern)
    try:
        yield
    finally:
        _CAPTURE_FILTER.reset(token)


def _needs_static_amax(spec: QuantizerSpec) -> bool:
    if spec.dynamic:
        return False
    if spec.block is None:
        return True
    if not spec.block.dynamic:
        return True
    return spec.block.two_level


def _calib_stat(x: torch.Tensor, spec: QuantizerSpec, two_level: bool) -> torch.Tensor:
    """One batch's amax statistic (f32): a scalar for per-tensor specs and
    NVFP4's per-tensor amax, max |x| over every axis but the kept trailing
    ones for per-channel integer specs (``axis=(-1,)``: [out] of an [in,
    out] or [E, in, out] kernel)."""
    if spec.block is not None and not two_level:
        raise NotImplementedError("calibration of static-block amax is not ported")
    if spec.axis is None or two_level:
        return x.abs().amax().float()
    if spec.is_fp:
        raise NotImplementedError("calibration of per-channel fp amax is not ported")
    keep = sorted(a % x.dim() for a in spec.axis)
    if keep != list(range(x.dim() - len(keep), x.dim())):
        raise NotImplementedError("calibration of a non-trailing per-channel amax "
                                  "is not ported")
    return x.abs().float().amax(dim=tuple(range(x.dim() - len(keep))))


def assign_paths(root: nn.Module) -> None:
    """Give every module its reference path: ``layers_0.attn.k_quantizer``
    becomes ``layers_0/attn/k_quantizer``."""
    for name, mod in root.named_modules():
        mod.path = name.replace(".", "/")


class TensorQuantizer(nn.Module):
    """A quantization point (input/weight/output/k/v/q quantizer)."""

    def __init__(self):
        super().__init__()
        self.path = ""
        self.register_buffer("amax", None)
        self.register_buffer("pre_quant_scale", None)

    def specs(self):
        cfg = active_quant_config()
        return cfg.resolve(self.path) if cfg is not None else None

    def forward(self, x: torch.Tensor, with_scale: bool = False,
                skip_fake: bool = False):
        """``with_scale=True``: for a calibrated per-tensor static int8 or
        e4m3 spec in QUANT phase return ``(codes, f32 scale)`` — the KV
        cache's real codes: int8 scale = max(amax, 1e-12)/127, codes =
        clip(round(x/scale), -127, 127); e4m3 scale = max(amax, 1e-12)/448,
        codes = clip(x/scale, -448, 448) rounded to e4m3 (half to even);
        otherwise ``(x', None)``. ``skip_fake=True``: the caller's
        GEMM quantizes the activations itself (per-token int8)."""

        def ret(y, scale=None):
            return (y, scale) if with_scale else y

        phase = current_phase()
        if phase == PHASE_OFF:
            return ret(x)
        if self.pre_quant_scale is not None and (
                phase == PHASE_CAPTURE or active_quant_config() is not None):
            x = (x * self.pre_quant_scale).to(x.dtype)
        if phase == PHASE_CAPTURE:
            self._record(x)
            return ret(x)
        specs = self.specs()
        if not specs:
            return ret(x)
        if skip_fake and phase == PHASE_QUANT:
            return ret(x)
        sp = specs[0]
        if (with_scale and phase == PHASE_QUANT and len(specs) == 1
                and sp.enable and sp.block is None and sp.axis is None
                and not sp.dynamic and not sp.rotate and self.amax is not None):
            amax = self.amax.float().clamp_min(1e-12)
            if sp.is_fp and (sp.fp_format.exp_bits, sp.fp_format.man_bits) == (4, 3):
                scale = true_divide(amax, 448.0)
                codes = cast_to_fp(torch.clamp(x.float() / scale, -448.0, 448.0),
                                   sp.fp_format)
                return codes.to(torch.float8_e4m3fn), scale
            if not sp.is_fp and sp.num_bits == 8:
                scale = true_divide(amax, 127.0)
                codes = torch.clamp(torch.round(x.float() / scale), -127.0, 127.0)
                return codes.to(torch.int8), scale
        if len(specs) > 1:
            raise NotImplementedError("sequential quantizer chains are not ported")
        if sp.enable:
            # a rotated spec quantizes (and calibrates) in the Hadamard basis,
            # then rotates back: the matrix is its own inverse
            if sp.rotate:
                x = hadamard_rotate(x)
            x = self._apply_one(x, sp, phase)
            if sp.rotate:
                x = hadamard_rotate(x)
        return ret(x)

    def _record(self, x: torch.Tensor) -> None:
        """Record x for CAPTURE phase: an input quantizer under no filter or
        a matching one, a q / k / v quantizer only under a matching one."""
        records = _CAPTURED.get()
        if records is None:
            return
        last = self.path.rsplit("/", 1)[-1]
        filt = _CAPTURE_FILTER.get()
        if last == "input_quantizer":
            keep = filt is None or fnmatch(self.path, filt)
        else:
            keep = (last in ("q_quantizer", "k_quantizer", "v_quantizer")
                    and filt is not None and fnmatch(self.path, filt))
        if keep:
            records.setdefault(self.path, []).append(x.detach().reshape(-1, x.shape[-1]))

    def _apply_one(self, x: torch.Tensor, spec: QuantizerSpec, phase: str):
        if spec.bias_mode is not None:
            raise NotImplementedError("affine quantizers are not ported")
        needs_amax = _needs_static_amax(spec)
        # NVFP4's dynamic two-level blocks calibrate one per-tensor amax
        two_level = spec.block is not None and spec.block.dynamic and spec.block.two_level
        if phase == PHASE_CALIB:
            if needs_amax:
                stat = _calib_stat(x.detach(), spec, two_level)
                self.amax = stat if self.amax is None else torch.maximum(self.amax, stat)
            return x
        amax = None
        if needs_amax:
            if self.amax is None:
                raise ValueError(
                    f"Quantizer {self.path} has no calibrated 'amax'. Run "
                    "calibrate() first (or use a dynamic spec).")
            amax = self.amax
            if 0 < amax.dim() < x.dim():  # a per-channel amax over the trailing axes
                amax = amax.reshape((1,) * (x.dim() - amax.dim()) + tuple(amax.shape))
        if two_level:
            return fake_quantize(x, spec, tensor_amax=amax)
        return fake_quantize(x, spec, amax=amax)
