"""Core: the ModelBundle every optimization mode transforms, mode registry,
nested-dict path helpers."""

from .bundle import (
    PHASE_CALIB,
    PHASE_CAPTURE,
    PHASE_OFF,
    PHASE_QUANT,
    ModelBundle,
    ModeRecord,
    apply_mode,
    current_phase,
)

__all__ = ["PHASE_CALIB", "PHASE_CAPTURE", "PHASE_OFF", "PHASE_QUANT", "ModelBundle",
           "ModeRecord", "apply_mode", "current_phase"]
