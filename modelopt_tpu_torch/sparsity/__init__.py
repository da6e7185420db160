"""Sparsity (port of ``modelopt_tpu/sparsity``, as far as it is ported):
calibrated skip-softmax decode attention."""

from . import skip_softmax  # noqa: F401
from .skip_softmax import (
    SkipSoftmaxConfig,
    calibrate_skip_softmax,
    ruler_needle_batches,
    sparsify_attention_dynamic,
)

__all__ = [
    "SkipSoftmaxConfig",
    "calibrate_skip_softmax",
    "ruler_needle_batches",
    "skip_softmax",
    "sparsify_attention_dynamic",
]
