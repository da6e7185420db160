"""Compressed-GEMM dispatch (port of ``modelopt_tpu/quant/backends.py``:
``qgemm``, ``grouped_qgemm``, ``moe_down_qgemm``).

One static rule beside the kernels of ``kernels.quant_gemm`` (each the CUDA
kernel on the card, its plain twin on the CPU):
  * int4 weights with int8 activations: ``w4a8_gemm`` with the reference's
    per-token activation quantization; int4 weight-only: ``w4a16_gemm`` at
    every M;
  * int8, e4m3 and NVFP4 weights at M <= 256 rows: ``w8a16_gemm``,
    ``wfp8_gemm``, ``nvfp4_gemm``, where K is a whole number of 128-row
    blocks and N of 64-column tiles (``byte_gemm_ok``, ``nvfp4_gemm_ok``);
    other K (the reference's ``_pallas_ok`` refuses K % 128 != 0 too:
    DeepSeek-V2-Lite's dense down projection, K = 10944) take the
    dequantize path below;
  * MoE down-projections at M <= 256: int4 with int8 activations and gates
    the fused ``grouped_w4a8_combine_gemm`` (straddle widths such as
    DeepSeek's K=1408 included), without gates ``grouped_w4a8_gemm`` (the
    same widths), int4 weight-only ``grouped_w4a16_gemm`` (the same
    widths), NVFP4 ``grouped_nvfp4_gemm`` where ``nvfp4_gemm_ok`` holds
    (the reference's grouped rule admits any K/2 that is a whole number of
    16-row scale blocks; the CUDA kernel takes K/2 % 64 == 0, so other
    widths take the einsum below on both devices);
  * int8 weights with int8 activations above 256 rows:
    ``int8_dynamic_gemm`` (dynamic per-row int8 activations, an s8 x s8 ->
    s32 product: ``torch._int_mm`` on the card, an exact int32 product on
    the CPU), which the JAX package also computes outside any Pallas
    kernel;
  * everything else, above 256 rows in particular, the reference's
    dequantize + ``torch.matmul`` / ``torch.einsum``, which the JAX package
    also computes outside any Pallas kernel, on both devices.
(The reference routes its CPU calls to the dequantize path; this port
keeps the kernels' arithmetic on both devices, so a CPU run checks the
card's.)
"""

from __future__ import annotations

import torch

from ..kernels.quant_gemm import (PREFILL_MIN_M, byte_gemm_ok, grouped_nvfp4_gemm,
                                  grouped_w4a8_combine_gemm, grouped_w4a8_gemm,
                                  grouped_w4a16_gemm, nvfp4_gemm, nvfp4_gemm_ok, w4a8_gemm,
                                  w4a16_gemm, w8a16_gemm, wfp8_gemm)
from .formats import true_divide
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
    """Per-row dynamic int8 codes: scale = max(|x|, 1e-12)/127 in f32 (the
    same quotient on both devices), codes round-half-even(x/scale) clipped
    to +-127. Returns (codes, scale [..., 1])."""
    xs = true_divide(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12), 127.0)
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def _fq_int8_per_token(x: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic int8 fake-quant (rows along the last dim) for paths
    that multiply in 16 bits."""
    codes, xs = _int8_rows(x.float())
    return (codes.float() * xs).to(x.dtype)


def int8_dynamic_gemm(x2d: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """W8A8 with dynamic per-row int8 activations: x2d [M, K] quantized per
    row (scale max(|x|, 1e-12)/127 in f32, codes round-half-even(x/scale)
    clipped to +-127), an s8 x s8 -> s32 product with the int8 weight
    ``data`` [K, N], then ``acc * xscale * scale`` in f32 (``scale`` [1, N],
    the weight's per-channel scale), cast to ``out_dtype``. The product is
    ``torch._int_mm`` on the card (cuBLAS; the reference's is XLA's
    ``dot_general``, no Pallas kernel) and an exact int32 product on the
    CPU. cuBLAS's fast int8 GEMMs take both operands K-major: the [K, N]
    weight goes in as a K-major copy made for the call (on an H100 the
    row-major weight takes a slower sm80 WMMA kernel; ``chip_smoke.py``'s
    int8_dynamic_gemm rows time both; a hand-written tile that reads
    [K, N] would need neither)."""
    xq, xs = _int8_rows(x2d.float())
    if xq.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), data.to(torch.int32))
    else:
        acc = torch._int_mm(xq, data.t().contiguous().t())
    return (acc.float() * xs * scale).to(out_dtype)


def qgemm(x2d: torch.Tensor, qt: dict, spec: QuantizerSpec, kn, out_dtype=None,
          act_int8: bool = False, act_raw: bool = False) -> torch.Tensor:
    """x2d [M, K] @ packed weight -> [M, N]. ``act_int8`` with int4 weights
    selects W4A8: per-row scale xs = max(|x|, 1e-12)/127 in f32,
    xq = round-half-even(x/xs) clipped to +-127, the kernel's product, then
    ``* xs`` in f32 for M <= 256 and in ``out_dtype`` above.
    int8 weights with ``act_int8`` above 256 rows take ``int8_dynamic_gemm``.
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
    if fmt == "int8" and act_int8 and x2d.shape[0] > PREFILL_MIN_M:
        return int8_dynamic_gemm(x2d, qt["data"], qt["scale"], out_dtype)
    if act_int8 and act_raw:
        # a 16-bit product still serves A8: one per-token rounding
        x2d = _fq_int8_per_token(x2d)
    if x2d.shape[0] <= PREFILL_MIN_M and (nvfp4_gemm_ok(*kn) if fmt == "nvfp4"
                                          else byte_gemm_ok(*kn)):
        if fmt == "int8":
            return w8a16_gemm(x2d, qt["data"], qt["scale"], out_dtype=out_dtype)
        if fmt == "fp8":
            return wfp8_gemm(x2d, qt["data"], qt["scale"], out_dtype=out_dtype)
        if fmt == "nvfp4":
            return nvfp4_gemm(x2d, qt["data"], qt["scale"], qt["scale2"],
                              block=block_of(spec, 16), out_dtype=out_dtype)
    w = dequantize_qtensor(qt, spec, kn).to(out_dtype)
    return torch.matmul(x2d.to(out_dtype), w)


def grouped_qgemm(x3: torch.Tensor, qt: dict, spec: QuantizerSpec, efn, out_dtype=None,
                  act_int8: bool = False, act_raw: bool = False) -> torch.Tensor:
    """Per-expert GEMMs for MoE down-projections: x3 [M, E, K] (token-major)
    against the FOLDED packed weight [K, E*N] -> [M, E, N]. At M <= 256,
    int4 with int8 activations rides ``grouped_w4a8_gemm`` (per-(expert,
    row) scale xs = max(|x|, 1e-12)/127 in f32, xq = round-half-even(x/xs)
    clipped to +-127, the kernel's f32 product times xs, then ``out_dtype``),
    int4 weight-only ``grouped_w4a16_gemm`` and NVFP4 ``grouped_nvfp4_gemm``
    (where ``nvfp4_gemm_ok(K, N)``).
    Every other case runs the reference's XLA steps (per-(token, expert)
    int8 fake-quant when the layer skipped its own, dequantized weight in
    ``out_dtype``, one batched product) with ``torch.einsum`` on either
    device."""
    E, K, N = efn
    M = x3.shape[0]
    out_dtype = out_dtype or x3.dtype
    fmt = compressible_format(spec, (K, E * N))
    if fmt is None:
        raise ValueError(f"no compressed format for spec {spec}")
    small = M <= PREFILL_MIN_M
    if fmt == "int4" and small and act_int8:
        xq, xs = _int8_rows(x3.transpose(0, 1).float())  # [E, M, K], [E, M, 1]
        y = grouped_w4a8_gemm(xq.contiguous(), qt["data"], qt["scale"], N,
                              block=block_of(spec))
        return (y * xs).to(out_dtype).transpose(0, 1)
    if act_int8 and act_raw:
        # the 16-bit product still serves A8: one per-(token, expert) rounding
        x3 = _fq_int8_per_token(x3)
    if small and (nvfp4_gemm_ok(K, N) if fmt == "nvfp4" else fmt == "int4" and not act_int8):
        xe = x3.to(out_dtype).transpose(0, 1)  # [E, M, K]
        if fmt == "int4":
            y = grouped_w4a16_gemm(xe, qt["data"], qt["scale"], N, block=block_of(spec),
                                   out_dtype=out_dtype)
        else:
            y = grouped_nvfp4_gemm(xe, qt["data"], qt["scale"], qt["scale2"], N,
                                   block=block_of(spec, 16), out_dtype=out_dtype)
        return y.transpose(0, 1)
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
