"""Compressed-GEMM dispatch (port of ``modelopt_tpu/quant/backends.py::qgemm``).

int4 weights with int8 activations go to ``kernels.quant_gemm.w4a8_gemm``
(the CUDA kernel on the card, its plain version on the CPU) with the
reference's per-token activation quantization. Every other packed format
is dequantized and multiplied with ``torch.matmul`` on the CPU only: on the
card those formats belong to kernels not yet ported (``w4a16_gemm``,
``w8a16_gemm``, ...), so a CUDA tensor raises there. (The reference routes
its CPU calls to the dequantize path too; this port keeps the integer path
on both devices, so a CPU run checks the card's arithmetic.)
"""

from __future__ import annotations

import torch

from ..kernels.quant_gemm import PREFILL_MIN_M, w4a8_gemm
from .qspec import QuantizerSpec
from .qtensor import block_of, compressible_format, dequantize_qtensor


def act_backend_quantizes(aspecs) -> bool:
    """True when the input-quantizer spec is exactly the per-token dynamic
    int8 quantization the W4A8 path performs itself — the layer then skips
    its fake-quant pass (one rounding, not two)."""
    if not aspecs or len(aspecs) != 1:
        return False
    sp = aspecs[0]
    return bool(
        sp.enable and not sp.is_fp and sp.num_bits == 8 and not sp.rotate
        and sp.block is not None and sp.block.dynamic
        and tuple(sp.block.sizes) == ((-1, 0),)
    )


def _fq_int8_per_token(x2d: torch.Tensor) -> torch.Tensor:
    """Per-token dynamic int8 fake-quant for paths that multiply in 16 bits."""
    xf = x2d.float()
    s = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    return (torch.clamp(torch.round(xf / s), -127, 127) * s).to(x2d.dtype)


def qgemm(x2d: torch.Tensor, qt: dict, spec: QuantizerSpec, kn, out_dtype=None,
          act_int8: bool = False, act_raw: bool = False) -> torch.Tensor:
    """x2d [M, K] @ packed weight -> [M, N]. ``act_int8`` with int4 weights
    selects W4A8: per-row scale xs = max(|x|, 1e-12)/127 in f32,
    xq = round-half-even(x/xs) clipped to +-127, the kernel's product, then
    ``* xs`` in f32 for M <= 256 and in ``out_dtype`` above.
    ``act_raw``: the layer skipped its input fake-quant, so a 16-bit path
    must fake-quantize x first to keep the A8 semantics."""
    fmt = compressible_format(spec, tuple(kn))
    out_dtype = out_dtype or x2d.dtype
    if fmt is None:
        raise ValueError(f"no compressed format for spec {spec}")
    if fmt == "int4" and act_int8:
        xf = x2d.float()
        xs = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        acc_dtype = out_dtype if xq.shape[0] > PREFILL_MIN_M else torch.float32
        out = w4a8_gemm(xq, qt["data"], qt["scale"], block=block_of(spec),
                        out_dtype=acc_dtype)
        return (out * xs.to(acc_dtype)).to(out_dtype)
    if x2d.device.type != "cpu":
        raise NotImplementedError(
            f"qgemm: {fmt} weights{' with int8 activations' if act_int8 else ''} "
            "have no CUDA kernel yet (only int4 weights with int8 activations)")
    if act_int8 and act_raw:
        x2d = _fq_int8_per_token(x2d)
    w = dequantize_qtensor(qt, spec, kn).to(out_dtype)
    return torch.matmul(x2d.to(out_dtype), w)
