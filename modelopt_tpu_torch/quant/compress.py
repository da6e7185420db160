"""Real quantization: replace full-precision kernels by packed weights.

Port of ``modelopt_tpu/quant/compress.py``. ``compress(bundle)`` packs
every eligible kernel (its weight quantizer enabled and a packed format
of ``quant/qtensor.py`` fitting its shape) with ``quantize_qtensor`` and
hands it to its layer with ``set_qweight``, which drops the kernel
parameter so its memory is freed; a 3-D expert kernel [E, in, out] packs
through the folded [in, E*out] view (a spec with a positive axis does not
fold and stays dense). The layers then multiply through
``quant.backends``. What calibration set beside the kernel stays: the
input quantizers' ``pre_quant_scale`` and amax, and SVDQuant's
``svd_lora_a`` / ``svd_lora_b`` beside the packed residual (the reference
deletes only ``kernel``). The mode record lists the packed layers:
``{"compressed": [paths]}``.
"""

from __future__ import annotations

from ..core.bundle import ModelBundle, apply_mode
from .qtensor import compressible_format, fold_experts, quantize_qtensor, spec_folds


def _compress_variables(bundle: ModelBundle) -> list:
    """Pack the bundle's eligible kernels in place; returns their layers'
    paths."""
    from .api import quantizer_specs

    modules = {m.path: m for m in bundle.module.modules()}
    compressed = []
    for path, specs in quantizer_specs(bundle):
        if not path.endswith("/weight_quantizer") or not specs or not specs[0].enable:
            continue
        spec = specs[0]
        dense_path = path.rsplit("/weight_quantizer", 1)[0]
        mod = modules[dense_path]
        kernel = getattr(mod, "kernel", None)
        if kernel is None or kernel.dim() not in (2, 3):
            continue
        if kernel.dim() == 3:
            if not spec_folds(spec):
                continue
            kernel = fold_experts(kernel)
        if compressible_format(spec, tuple(kernel.shape)) is None:
            continue
        qt, _ = quantize_qtensor(kernel, spec)
        del kernel
        mod.set_qweight(qt)
        compressed.append(dense_path)
    return compressed


def compress(bundle: ModelBundle) -> ModelBundle:
    """Pack all eligible quantized weights (in place; returns the bundle
    with a ``compress`` record)."""
    if not any(r.mode == "quantize" for r in bundle.records):
        raise ValueError("compress() requires a quantized model")
    return apply_mode(bundle, "compress", {})
