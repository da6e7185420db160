"""Quantization: specs, presets, packed formats, GEMM dispatch, calibration."""
