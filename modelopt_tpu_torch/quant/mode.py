"""Quantization mode descriptors (port of ``modelopt_tpu/quant/mode.py``):
``quantize`` binds its QuantizeConfig while the model runs; ``compress``
packs the weights (``quant/compress.py``) and binds nothing."""

from __future__ import annotations

from ..core.mode import ModeDescriptor, ModeRegistry
from .config import QuantizeConfig, get_config

QuantizeModeRegistry = ModeRegistry("quantization")


@QuantizeModeRegistry.register
class QuantizeModeDescriptor(ModeDescriptor):
    name = "quantize"

    def canonicalize_config(self, config) -> QuantizeConfig:
        return get_config(config)

    def convert(self, bundle, config):
        return bundle, {}

    def runtime_context(self, config, phase):
        from ..nn.quantizer import quantization_active

        return quantization_active(get_config(config))


@QuantizeModeRegistry.register
class CompressModeDescriptor(ModeDescriptor):
    name = "compress"

    def convert(self, bundle, config):
        from .compress import _compress_variables

        return bundle, {"compressed": _compress_variables(bundle)}
