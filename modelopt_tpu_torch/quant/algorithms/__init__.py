"""Calibration algorithms beyond max: SmoothQuant, AWQ (lite, clip,
full), SVDQuant and NVFP4 activation headroom. Each registers itself with
the ``calibrate()`` dispatch on import.

Port of ``modelopt_tpu/quant/algorithms/``; gptq, mse, histogram,
local_hessian and autoquant are not ported.
"""

from . import awq, nvfp4_headroom, smoothquant, svdquant  # noqa: F401
from .capture import capture_inputs, fused_groups, quant_linears  # noqa: F401
