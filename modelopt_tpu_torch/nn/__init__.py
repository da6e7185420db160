"""Quantization-aware layers and the TensorQuantizer."""

from .layers import QuantDense, QuantEmbed, RMSNorm
from .quantizer import TensorQuantizer, active_quant_config, assign_paths, quantization_active

__all__ = ["QuantDense", "QuantEmbed", "RMSNorm", "TensorQuantizer",
           "active_quant_config", "assign_paths", "quantization_active"]
