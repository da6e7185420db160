"""Public quantization API (port of ``modelopt_tpu/quant/api.py``):
``quantize``, ``calibrate`` through the ``CALIB_ALGORITHMS`` registry
(``max`` here; SmoothQuant and AWQ lite / clip / full from
``quant/algorithms/``, which register themselves on import),
``validate_calibration``, ``quantizer_specs``, ``disable_quantizer`` /
``enable_quantizer``, ``fold_weight`` and ``compute_quantization_mse``.

``forward_loop`` receives ``model_fn(*args, **kwargs)``, which runs the
bundle's module in the algorithm's phase; call it once per calibration
batch. Quantizer state (amax, pre-quant scales) lives in module buffers and
the algorithms rescale kernels in place, so calibration updates the
bundle's module IN PLACE and returns the same bundle (with the algorithms'
choices in ``bundle.metadata``). Every step runs where the module's
tensors are: on the card for a bundle built there.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

from ..core.bundle import PHASE_CALIB, ModelBundle, apply_mode
from ..nn.quantizer import TensorQuantizer
from . import mode as _mode  # noqa: F401  (registers the quantize mode)
from .config import QuantizeConfig, get_config

# name -> fn(bundle, forward_loop, **kw)
CALIB_ALGORITHMS: dict[str, Callable] = {}


def register_calib_algorithm(name: str):
    def deco(fn):
        CALIB_ALGORITHMS[name] = fn
        return fn

    return deco


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
    """Run a registered calibration algorithm; an unknown name raises
    KeyError."""
    if algorithm is None:
        return bundle
    try:
        fn = CALIB_ALGORITHMS[algorithm]
    except KeyError:
        raise KeyError(f"Unknown calibration algorithm {algorithm!r}; "
                       f"registered: {sorted(CALIB_ALGORITHMS)}") from None
    return fn(bundle, forward_loop, **kwargs)


@register_calib_algorithm("max")
def max_calibrate(bundle: ModelBundle, forward_loop=None) -> ModelBundle:
    """Max calibration: every static quantizer keeps the running max of |x|
    over the batches ``forward_loop`` feeds (per channel for per-channel
    weight specs), on top of any amax it already holds."""
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


# --------------------------------------------------------------------------
# introspection and toggling
# --------------------------------------------------------------------------
def quantizer_specs(bundle: ModelBundle) -> list:
    """(path, resolved specs or None) of every quantization point of the
    bundle's module under its quantize config."""
    from .algorithms.capture import active_config

    cfg = active_config(bundle)
    return [(m.path, cfg.resolve(m.path)) for m in bundle.module.modules()
            if isinstance(m, TensorQuantizer)]


def disable_quantizer(bundle: ModelBundle, pattern: str) -> ModelBundle:
    """Disable the quantizers matching ``pattern``."""
    return _update_rules(bundle, {pattern: {"enable": False}})


def enable_quantizer(bundle: ModelBundle, pattern: str) -> ModelBundle:
    return _update_rules(bundle, {pattern: {"enable": True}})


def _update_rules(bundle: ModelBundle, rules: dict) -> ModelBundle:
    records = list(bundle.records)
    for i in range(len(records) - 1, -1, -1):
        if records[i].mode == "quantize":
            cfg = get_config(records[i].config).updated(rules)
            records[i] = dataclasses.replace(records[i], config=cfg)
            return bundle.replace(records=tuple(records))
    raise ValueError("model has no quantize mode applied")


def fold_weight(bundle: ModelBundle) -> ModelBundle:
    """Bake the weights' fake quantization into the stored kernels (in
    place) and disable the weight quantizers: the model then runs with
    quantized-valued weights and no per-forward weight rounding."""
    from .fake_quant import fake_quantize

    modules = {m.path: m for m in bundle.module.modules()}
    folded = []
    for path, specs in quantizer_specs(bundle):
        if not path.endswith("/weight_quantizer") or not specs or not specs[0].enable:
            continue
        spec = specs[0]
        dense_path = path.rsplit("/weight_quantizer", 1)[0]
        w = getattr(modules[dense_path], "kernel", None)
        if w is None:
            continue
        amax = modules[path].amax
        kw = {}
        if amax is not None:
            if spec.block is not None and spec.block.dynamic:
                kw["tensor_amax"] = amax
            elif spec.block is not None:
                raise NotImplementedError("folding static-block amax is not ported")
            else:
                kw["amax"] = amax.reshape((1,) * (w.dim() - amax.dim()) + tuple(amax.shape))
        w.data.copy_(fake_quantize(w.float(), spec, **kw).to(w.dtype))
        folded.append(dense_path)
    return _update_rules(bundle, {p + "/weight_quantizer": {"enable": False} for p in folded})


def compute_quantization_mse(bundle: ModelBundle, batch) -> dict:
    """Per quantized linear layer, on the inputs one forward of ``batch``
    feeds it: the weight's quantization MSE and the output's relative
    error ||x (wq - w)|| / ||x w||."""
    from .algorithms.capture import (capture_inputs, fq_with_amax, quant_linears,
                                     weight_amax_map)

    captured = capture_inputs(bundle, lambda f: f(batch))
    out = {}
    for info in quant_linears(bundle, captured):
        w = info.kernel
        wq = fq_with_amax(w, weight_amax_map(w, info.wspec), info.wspec)
        ref = info.x @ w
        out[info.dense_path] = {
            "weight_mse": float(((wq - w) ** 2).mean()),
            "output_rel_err": float((info.x @ (wq - w)).norm()
                                    / ref.norm().clamp_min(1e-12)),
        }
    return out


from . import algorithms as _algorithms  # noqa: E402,F401  (registers the algorithms)
