"""Public quantization API (port of ``modelopt_tpu/quant/api.py``):
``quantize``, ``calibrate`` with the ``max`` algorithm, and
``validate_calibration``.

``forward_loop`` receives ``model_fn(*args, **kwargs)``, which runs the
bundle's module in the calibration phase; call it once per calibration
batch. Quantizer amax lives in module buffers, so calibration updates the
bundle's module IN PLACE and returns the same bundle. Of the algorithms the
reference registers only ``max`` is ported: the presets' ``awq_lite`` and
``smoothquant`` raise NotImplementedError (calibrate with ``"max"`` to
collect the KV-cache and activation amax without them).
"""

from __future__ import annotations

import warnings
from typing import Optional

from ..core.bundle import PHASE_CALIB, ModelBundle, apply_mode
from ..nn.quantizer import TensorQuantizer
from . import mode as _mode  # noqa: F401  (registers the quantize mode)
from .config import QuantizeConfig


def quantize(bundle: ModelBundle, config, forward_loop=None) -> ModelBundle:
    """Apply the quantize mode, then calibrate with the config's algorithm."""
    bundle = apply_mode(bundle, "quantize", config)
    cfg: QuantizeConfig = bundle.records[-1].config
    bundle = calibrate(bundle, cfg.algorithm_name, forward_loop, **cfg.algorithm_kwargs)
    if cfg.algorithm_name is not None:
        validate_calibration(bundle, raise_on_error=False)
    return bundle


def calibrate(bundle: ModelBundle, algorithm: Optional[str] = "max",
              forward_loop=None, **kwargs) -> ModelBundle:
    if algorithm is None:
        return bundle
    if algorithm != "max":
        raise NotImplementedError(
            f"calibration algorithm {algorithm!r} is not ported; ported: ['max']")
    return max_calibrate(bundle, forward_loop, **kwargs)


def max_calibrate(bundle: ModelBundle, forward_loop=None) -> ModelBundle:
    """Max calibration: every static quantizer keeps the running max of |x|
    over the batches ``forward_loop`` feeds (the int8 KV cache's k/v amax,
    per layer)."""
    if forward_loop is None:
        raise ValueError("max_calibrate needs a forward_loop")
    forward_loop(bundle.make_fn(phase=PHASE_CALIB))
    return bundle


def validate_calibration(bundle: ModelBundle, raise_on_error: bool = True) -> list:
    """Paths of quantizers whose amax is not finite and positive."""
    bad = []
    for mod in bundle.module.modules():
        if isinstance(mod, TensorQuantizer) and mod.amax is not None:
            a = mod.amax.float()
            if not (bool((a > 0).all()) and bool(a.isfinite().all())):
                bad.append(mod.path)
    if bad:
        msg = "calibration incomplete: zero/non-finite amax at " + ", ".join(bad[:8])
        if raise_on_error:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    return bad


