"""ModelBundle: the unit every optimization mode transforms.

Port of ``modelopt_tpu/core/bundle.py`` without save/restore (a later
slice). The bundle holds the ``nn.Module`` and its ordered ``ModeRecord``s;
``contexts(phase)`` binds the phase and every applied mode's runtime context
(the active QuantizeConfig) while the module runs. Unlike the reference,
whose variables are an immutable pytree, quantizer state (amax, packed
weights) lives in the module's buffers and calibration updates it in place.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

from .mode import get_mode

# Phases a converted model runs in: quantizers collect amax in CALIB,
# quantize in QUANT, pass through in OFF; CAPTURE passes through too and
# records quantizer inputs for calibration algorithms.
PHASE_QUANT = "quant"
PHASE_CALIB = "calib"
PHASE_CAPTURE = "capture"
PHASE_OFF = "off"

_PHASE_VAR = contextvars.ContextVar("opt_phase", default=PHASE_QUANT)


def current_phase() -> str:
    return _PHASE_VAR.get()


@contextlib.contextmanager
def _set_phase(phase: str):
    token = _PHASE_VAR.set(phase)
    try:
        yield
    finally:
        _PHASE_VAR.reset(token)


@dataclasses.dataclass(frozen=True)
class ModeRecord:
    mode: str
    config: Any
    metadata: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """A model plus its optimization state: ``module`` (the nn.Module, with
    its quantizer buffers), ``records`` (the applied modes, in order) and
    free-form ``metadata``."""

    module: Any
    records: tuple = ()
    metadata: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def contexts(self, phase: str = PHASE_QUANT):
        """Enter every applied mode's runtime context."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(_set_phase(phase))
            for rec in self.records:
                ctx = get_mode(rec.mode).runtime_context(rec.config, phase)
                if ctx is not None:
                    stack.enter_context(ctx)
            yield

    def apply(self, *args, phase: str = PHASE_QUANT, capture: bool = False, **kwargs):
        """Run the module with the mode contexts bound, without autograd.
        ``capture=True`` returns ``(output, records)``: what the quantizers
        recorded in CAPTURE phase, ``{path: [x.reshape(-1, x.shape[-1]), ...]}``
        in call order (the reference's ``quant_capture`` collection)."""
        import torch

        from ..nn.quantizer import capture_records

        with self.contexts(phase), torch.no_grad():
            if not capture:
                return self.module(*args, **kwargs)
            with capture_records() as records:
                out = self.module(*args, **kwargs)
            return out, records

    def make_fn(self, phase: str = PHASE_QUANT):
        """``fn(*args, **kwargs)`` running the module in ``phase``."""
        return lambda *args, **kwargs: self.apply(*args, phase=phase, **kwargs)

    def replace(self, **kw) -> "ModelBundle":
        return dataclasses.replace(self, **kw)


def apply_mode(bundle: ModelBundle, mode: str, config=None) -> ModelBundle:
    """Apply one mode, appending its record."""
    desc = get_mode(mode)
    if hasattr(desc, "canonicalize_config"):
        config = desc.canonicalize_config(config)
    new_bundle, metadata = desc.convert(bundle, config)
    rec = ModeRecord(mode=mode, config=config, metadata=metadata or {})
    return new_bundle.replace(records=(*new_bundle.records, rec))
