"""Compressed-GEMM dispatch (port of ``modelopt_tpu/quant/backends.py``:
``qgemm``, ``grouped_qgemm``, ``moe_down_qgemm``).

int4 weights go to the int4 kernels of ``kernels.quant_gemm`` (the CUDA
kernel on the card, its plain twin on the CPU): with int8 activations to
``w4a8_gemm`` with the reference's per-token activation quantization,
weight-only to ``w4a16_gemm`` at every M. MoE down-projections of at most
256 rows take the grouped kernels: with int8 activations and gates the fused
``grouped_w4a8_combine_gemm``, weight-only ``grouped_w4a16_gemm``. Above 256
rows the reference has no grouped kernel and leaves dequantize + einsum to
XLA; the port runs those same steps with ``torch.einsum``, on both devices.
Every other packed format or shape is dequantized and multiplied on the CPU
only: on the card it belongs to a kernel not yet ported (``w8a16_gemm``,
``grouped_w4a8_gemm``, ...), so a CUDA tensor raises there. (The reference
routes its CPU calls to the dequantize path; this port keeps the kernels'
arithmetic on both devices, so a CPU run checks the card's.)
"""

from __future__ import annotations

import torch

from ..kernels.quant_gemm import (PREFILL_MIN_M, grouped_w4a8_combine_gemm,
                                  grouped_w4a16_gemm, w4a8_gemm, w4a16_gemm)
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


def _int8_rows(xf: torch.Tensor):
    """Per-row dynamic int8 codes: scale = max(|x|, 1e-12)/127 in f32, codes
    round-half-even(x/scale) clipped to +-127. Returns (codes, scale [..., 1])."""
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def _fq_int8_per_token(x: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic int8 fake-quant (rows along the last dim) for paths
    that multiply in 16 bits."""
    codes, xs = _int8_rows(x.float())
    return (codes.float() * xs).to(x.dtype)


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
        xq, xs = _int8_rows(x2d.float())
        acc_dtype = out_dtype if xq.shape[0] > PREFILL_MIN_M else torch.float32
        out = w4a8_gemm(xq, qt["data"], qt["scale"], block=block_of(spec),
                        out_dtype=acc_dtype)
        return (out * xs.to(acc_dtype)).to(out_dtype)
    if fmt == "int4":
        # W4A16 at every M: the reference leaves small products (K*N < 2^22)
        # and CPU calls to a dequantize + matmul; the port's kernel serves all
        return w4a16_gemm(x2d, qt["data"], qt["scale"], block=block_of(spec),
                          out_dtype=out_dtype)
    if x2d.device.type != "cpu":
        raise NotImplementedError(
            f"qgemm: {fmt} weights{' with int8 activations' if act_int8 else ''} "
            "have no CUDA kernel yet (only int4 weights)")
    if act_int8 and act_raw:
        x2d = _fq_int8_per_token(x2d)
    w = dequantize_qtensor(qt, spec, kn).to(out_dtype)
    return torch.matmul(x2d.to(out_dtype), w)


def grouped_qgemm(x3: torch.Tensor, qt: dict, spec: QuantizerSpec, efn, out_dtype=None,
                  act_int8: bool = False, act_raw: bool = False) -> torch.Tensor:
    """Per-expert GEMMs for MoE down-projections: x3 [M, E, K] (token-major)
    against the FOLDED packed weight [K, E*N] -> [M, E, N]. int4 weight-only
    at M <= 256 rides ``grouped_w4a16_gemm``; int4 above 256 rows runs the
    reference's XLA steps (per-(token, expert) int8 fake-quant when the
    layer skipped its own, dequantized weight in ``out_dtype``, one batched
    product) with ``torch.einsum`` on either device. int4 with int8
    activations at M <= 256 belongs to the unported ``grouped_w4a8_gemm``
    and other formats to unported kernels: CPU only."""
    E, K, N = efn
    M = x3.shape[0]
    out_dtype = out_dtype or x3.dtype
    fmt = compressible_format(spec, (K, E * N))
    if fmt is None:
        raise ValueError(f"no compressed format for spec {spec}")
    small = M <= PREFILL_MIN_M
    if fmt == "int4" and small and not act_int8:
        xe = x3.to(out_dtype).transpose(0, 1)  # [E, M, K]
        y = grouped_w4a16_gemm(xe, qt["data"], qt["scale"], N, block=block_of(spec),
                               out_dtype=out_dtype)
        return y.transpose(0, 1)
    if x3.device.type != "cpu" and not (fmt == "int4" and not small):
        raise NotImplementedError(
            f"grouped_qgemm: {fmt} experts{' with int8 activations' if act_int8 else ''} "
            f"at M={M} have no CUDA kernel yet (grouped_w4a8_gemm and the "
            "grouped fp formats are not ported)")
    if act_int8 and act_raw:
        # the 16-bit product still serves A8: one per-(token, expert) rounding
        x3 = _fq_int8_per_token(x3)
    w3 = dequantize_qtensor(qt, spec, (K, E * N)).to(out_dtype).reshape(K, E, N)
    return torch.einsum("meo,oed->med", x3.to(out_dtype), w3)


def moe_down_qgemm(x3: torch.Tensor, qt: dict, spec: QuantizerSpec, efn, gates,
                   out_dtype=None, act_int8: bool = False,
                   act_raw: bool = False) -> torch.Tensor:
    """MoE down-projection and routed combine,
    ``out[m] = sum_e gates[m, e] * (x3[m, e] @ W_e)`` -> [M, N]. int4 with
    int8 activations at M <= 256 is one fused ``grouped_w4a8_combine_gemm``:
    per-(token, expert) int8 rows over K (scale max(|x|, 1e-12)/127 in f32,
    round half to even), the gate folded into the row scale
    (``gscale = xs * gates.T`` in f32), the f32 result cast to
    ``out_dtype``. Otherwise ``grouped_qgemm`` then the combine einsum."""
    E, K, N = efn
    M = x3.shape[0]
    out_dtype = out_dtype or x3.dtype
    fmt = compressible_format(spec, (K, E * N))
    if act_int8 and fmt == "int4" and M <= PREFILL_MIN_M:
        xq, xs = _int8_rows(x3.transpose(0, 1).float())  # [E, M, K], [E, M, 1]
        gsc = xs[..., 0] * gates.float().T
        y = grouped_w4a8_combine_gemm(xq.contiguous(), gsc.contiguous(), qt["data"],
                                      qt["scale"], N, block=block_of(spec))
        return y.to(out_dtype)
    y3 = grouped_qgemm(x3, qt, spec, efn, out_dtype=out_dtype, act_int8=act_int8,
                       act_raw=act_raw)
    return torch.einsum("men,me->mn", y3, gates.to(out_dtype))
