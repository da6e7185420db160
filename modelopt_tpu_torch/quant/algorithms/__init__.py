"""Calibration algorithms beyond max: SmoothQuant and AWQ (lite, clip,
full). Each registers itself with the ``calibrate()`` dispatch on import.

Port of ``modelopt_tpu/quant/algorithms/``; gptq, svdquant, mse,
histogram, local_hessian, nvfp4_headroom and autoquant are not ported.
"""

from . import awq, smoothquant  # noqa: F401
from .capture import capture_inputs, fused_groups, quant_linears  # noqa: F401
