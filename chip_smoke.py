#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), versions, kernel build time
     (one nvcc per source, all started together); TF32 is switched off for
     matmuls and cuDNN, so the MoE router's f32 product runs in full f32;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the serving paths' shapes — max abs error against a stated
     tolerance, kernel / plain / library-call times (CUDA events, median of
     25 launches, L2 flushed before each) and the least time the card could
     take for the same work: the MoE kernels (K6 w4a16_gemm at the four
     projection shapes, K10 grouped_w4a16_gemm, K12
     grouped_w4a8_combine_gemm with routed and dense gate scales), then
     K1-K4 with K2 and K4 at both GQA groups the paths run (G = 4 and 8);
  3. parity: small models built from the same numpy weights on the CPU
     (plain versions) and on the card (kernels), prefill and 4 decode steps
     compared: a 2-layer Qwen3-MoE at the real per-expert geometry (hidden
     2048, expert width 768, 32/4 heads, 8 experts, top-2) under
     W4A8_INT8KV_CFG and under INT4_BLOCKWISE_WEIGHT_ONLY_CFG, and a
     2-layer llama;
  4. serving paths, one after the other (each model freed before the next
     is built), each on random weights from a seed, served by ServingEngine
     (max_batch 8, max_seq_len 2176, prefill buckets (32, 544), multi_step
     16, max_admit 1): one warm-up request, then 8 requests x 1024 random
     prompt tokens -> 64 new tokens each, greedy. Launch counters are zeroed
     just before each measured run and read just after: every kernel of the
     path must have launched, and no kernel of another path;
       B: Qwen3-30B-A3B (full width and depth) under W4A8_INT8KV_CFG, KV
          scales calibrated by one 64-token forward;
       C: Qwen3-30B-A3B (full width and depth) under
          INT4_BLOCKWISE_WEIGHT_ONLY_CFG (W4A16), bf16 KV cache;
       A: Llama-3-8B (full width and depth) under W4A8_INT8KV_CFG;
     after each measured run, a torch.profiler window over decode ticks
     (device time by kernel, idle share) and one checked request.
Then one JSON line of per-kernel numbers, and last the device line.
To iterate on one phase, import this module and call its phase function
(``kernel_phase``, ``parity_phase``, ``serve_path``) directly after
``_build.build_all()``; they print no contract line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s, bf16 flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
REPEATS = 25
# the shape each kernel's summary row reports (all shapes ride along)
PRIMARY = ("M=8 K=4096 N=28672",
           "B=8 S=2176 KH=8 G=4 D=128 int8 ragged pos",
           "M=8 K=2048 N=98304 bf16 out",
           "E=128 M=8 K=768 N=2048")  # K12 reports its first row (routed gscale)

SOURCES = {
    "w4a8_gemm": ("modelopt_tpu_torch/csrc/w4a8_gemm.cu",
                  "modelopt_tpu/kernels/quant_gemm.py:425"),
    "dense_kv_write": ("modelopt_tpu_torch/csrc/kv_write.cu",
                       "modelopt_tpu/kernels/attention.py:342"),
    "fused_decode_attention": ("modelopt_tpu_torch/csrc/fused_decode_attention.cu",
                               "modelopt_tpu/kernels/attention.py:544"),
    "flash_prefill_attention": ("modelopt_tpu_torch/csrc/flash_prefill_attention.cu",
                                "modelopt_tpu/kernels/flash_attention.py:175"),
    "w4a16_gemm": ("modelopt_tpu_torch/csrc/w4a16_gemm.cu",
                   "modelopt_tpu/kernels/quant_gemm.py:181"),
    "grouped_w4a16_gemm": ("modelopt_tpu_torch/csrc/w4a16_gemm.cu",
                           "modelopt_tpu/kernels/quant_gemm.py:653"),
    "grouped_w4a8_combine_gemm": ("modelopt_tpu_torch/csrc/grouped_w4a8_gemm.cu",
                                  "modelopt_tpu/kernels/quant_gemm.py:773"),
}
# kernels each serving path must launch
PATH_KERNELS = {
    "A": ("w4a8_gemm", "dense_kv_write", "fused_decode_attention",
          "flash_prefill_attention"),
    "B": ("w4a8_gemm", "dense_kv_write", "fused_decode_attention",
          "flash_prefill_attention", "grouped_w4a8_combine_gemm"),
    "C": ("w4a16_gemm", "grouped_w4a16_gemm", "dense_kv_write",
          "fused_decode_attention", "flash_prefill_attention"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median device time of single launches, with the 50 MB L2 flushed
    before each (the main path meets its weights and caches cold). After the
    flush the stream spins for SPIN_CYCLES, so the card is still busy while
    the host enqueues the start event, the wrapper's launch and the end
    event: the wrapper's host time falls outside the measured interval. A
    plain version that synchronises inside (``.tolist()``, ``int(t)``) still
    counts its host time after the spin."""

    SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, repeats: int = REPEATS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def kernel_phase(torch, results: dict) -> None:
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import attention as ka
    from modelopt_tpu_torch.kernels import flash_attention as kf
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant.qtensor import dequantize_int4, quantize_int4

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def record(name, shape, err, tol, ms, plain_ms, lib_ms, nbytes, ops, rate):
        """One kernel row; ``nbytes`` counts each input read once and each
        output written once."""
        bound_b = nbytes / HBM_BPS * 1e3
        bound_o = ops / rate * 1e3
        row = {"shape": shape, "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(bound_b, bound_o),
               "bound_by": "bytes" if bound_b >= bound_o else "operations"}
        results.setdefault(name, []).append(row)
        log(f"  {name} {shape}: max_abs_err {err:.3g} (tol {tol:g}) | kernel "
            f"{ms:.4f} ms | plain {plain_ms:.4f} ms | library {lib_ms:.4f} ms | "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: error {err} above {tol}")

    moe_kernels(torch, gen, timer, record)

    # K1 — exact integer dots; the f32 block update repeats the plain
    # version's rounding, so the tolerance only absorbs the bf16 output
    log("K1 w4a8_gemm")
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        qt = quantize_int4(w)
        wdq = dequantize_int4(qt).to(torch.bfloat16)
        del w
        for M in (8, 544):
            xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                               dtype=torch.int8)
            out_dtype = torch.float32 if M <= 256 else torch.bfloat16
            y = kq.w4a8_gemm(xq, qt["data"], qt["scale"], out_dtype=out_dtype)
            ref = kq.w4a8_gemm_plain(xq, qt["data"], qt["scale"], 128,
                                     out_dtype)
            err = (y.float() - ref.float()).abs().max().item()
            tol = 0.0 if out_dtype == torch.float32 else \
                ref.float().abs().max().item() * 2**-8
            xb = xq.to(torch.bfloat16)
            ms = timer(lambda: kq.w4a8_gemm(xq, qt["data"], qt["scale"],
                                            out_dtype=out_dtype))
            plain_ms = timer(lambda: kq.w4a8_gemm_plain(
                xq, qt["data"], qt["scale"], 128, out_dtype), 5)
            lib_ms = timer(lambda: torch.matmul(xb, wdq))
            nbytes = M * K + K * N // 2 + (K // 128) * N * 4 + \
                M * N * (4 if out_dtype == torch.float32 else 2)
            record("w4a8_gemm", f"M={M} K={K} N={N}", err, tol, ms, plain_ms,
                   lib_ms, nbytes, 2 * M * K * N, INT8_OPS)
        del qt, wdq

    # K3 — a copy: bit-exact
    log("K3 dense_kv_write")
    B, S, T, KHD, st = 1, 2176, 544, 1024, 544
    cache = torch.randint(-127, 128, (B, S, KHD), generator=gen, device=dev,
                          dtype=torch.int8)
    vals = torch.randint(-127, 128, (B, T, KHD), generator=gen, device=dev,
                         dtype=torch.int8)
    start = torch.full((B,), st, dtype=torch.int32, device=dev)
    got = ka.dense_kv_write(cache.clone(), vals, start)
    ref = ka.dense_kv_write_plain(cache.clone(), vals, start)
    err = (got.float() - ref.float()).abs().max().item()
    c2 = cache.clone()
    ms = timer(lambda: ka.dense_kv_write(c2, vals, start))
    plain_ms = timer(lambda: ka.dense_kv_write_plain(c2, vals, start))
    lib_ms = timer(lambda: c2[:, st:st + T].copy_(vals))
    record("dense_kv_write", f"B={B} T={T} S={S} row={KHD} int8 start={st}",
           err, 0.0, ms, plain_ms, lib_ms, 2 * B * T * KHD, 0, INT8_OPS)

    # K2 — int8: integer dots are exact, so kernel and plain version differ
    # only where exp() rounds a probability code e8 across .5. One flipped
    # code moves an output by <= 254 * vs / sum(e8), and sum(e8) >= 127 on
    # every live row; on these inputs the flips land on rows with large
    # sums (0.0156 measured on an H100), so the bar is vs = 0.03, half the
    # one-flip bound of the smallest sum. bf16: f32 sums in another order and
    # a few probabilities whose bf16 rounding goes the other way after a
    # different exp() move an output by ~1e-4; then the output rounds to
    # bf16, one ulp = 2^-9 below |out| 0.25. The bar 0.003 allows both
    # (0.000488 measured on an H100); larger outputs must round alike.
    log("K2 fused_decode_attention")
    B, S, D = 8, 2176, 128
    pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0],
                       dtype=torch.int32, device=dev)
    for KH, G in ((8, 4), (4, 8)):  # Llama-3-8B, Qwen3-30B-A3B
        q = torch.randn(B, KH, G, D, generator=gen, device=dev).to(torch.bfloat16)
        for kind in ("int8", "bf16"):
            if kind == "int8":
                kc = torch.randint(-127, 128, (B, S, KH * D), generator=gen,
                                   device=dev, dtype=torch.int8)
                vc = torch.randint(-127, 128, (B, S, KH * D), generator=gen,
                                   device=dev, dtype=torch.int8)
                kn = torch.randint(-127, 128, (B, 1, KH * D), generator=gen,
                                   device=dev, dtype=torch.int8)
                vn = torch.randint(-127, 128, (B, 1, KH * D), generator=gen,
                                   device=dev, dtype=torch.int8)
                ks = torch.tensor(0.02, device=dev)
                vs = torch.tensor(0.03, device=dev)
                tol = 0.03
                kd = (kc.float() * ks).to(torch.bfloat16)
                vd = (vc.float() * vs).to(torch.bfloat16)
                rate = INT8_OPS
            else:
                kc = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
                vc = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
                kn = torch.randn(B, 1, KH * D, generator=gen, device=dev).to(torch.bfloat16)
                vn = torch.randn(B, 1, KH * D, generator=gen, device=dev).to(torch.bfloat16)
                ks = vs = None
                tol = 0.003
                kd, vd = kc, vc
                rate = BF16_FLOPS
            out, kc1, vc1 = ka.fused_decode_attention(q, kn, vn, kc.clone(), vc.clone(),
                                                      pos, ks, vs)
            ref, kc2, vc2 = ka.fused_decode_attention_plain(q, kn, vn, kc.clone(),
                                                            vc.clone(), pos, ks, vs)
            err = (out.float() - ref.float()).abs().max().item()
            if not (torch.equal(kc1, kc2) and torch.equal(vc1, vc2)):
                raise AssertionError(f"fused_decode_attention {kind}: caches differ")
            kt, vt = kc.clone(), vc.clone()
            ms = timer(lambda: ka.fused_decode_attention(q, kn, vn, kt, vt, pos, ks, vs))
            plain_ms = timer(lambda: ka.fused_decode_attention_plain(
                q, kn, vn, kt, vt, pos, ks, vs), 5)
            qs = q.reshape(B, KH * G, 1, D)
            k4 = kd.reshape(B, S, KH, D).transpose(1, 2)
            v4 = vd.reshape(B, S, KH, D).transpose(1, 2)
            mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())
            mask = mask[:, None, None, :]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, k4, v4, attn_mask=mask, enable_gqa=True))
            live = int((pos.long() + 1).sum())
            item = kc.element_size()
            nbytes = 2 * live * KH * D * item + q.numel() * 2 + B * KH * G * D * 2
            record("fused_decode_attention",
                   f"B={B} S={S} KH={KH} G={G} D={D} {kind} ragged pos",
                   err, tol, ms, plain_ms, lib_ms, nbytes, 4 * live * KH * G * D, rate)
            del kc, vc, kd, vd, kt, vt

    # K4 — online softmax vs one pass: the kernel rounds unnormalised
    # probabilities to bf16, the plain version normalised ones, each within
    # 2^-8 relative. Were every rounding maximal and of one sign on both
    # sides, the f32 outputs would differ by 2 * 2^-8 * max|v| (max|v| =
    # 127 * vs for int8 codes, the largest value of a bf16 cache); hundreds
    # of independent roundings per row leave far less, so the bar takes half
    # of that, 2^-8 * max|v|. Rounding the outputs to bf16 adds one ulp,
    # <= 2^-7 * max|ref| (0.0078 measured on an H100).
    log("K4 flash_prefill_attention")
    B, T, S, D, st = 1, 544, 2176, 128, 544
    for KH, G, kind in ((8, 4, "int8"), (4, 8, "int8"), (4, 8, "bf16")):
        q = torch.randn(B, T, KH, G, D, generator=gen, device=dev).to(torch.bfloat16)
        if kind == "int8":
            ck = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                               dtype=torch.int8)
            cv = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                               dtype=torch.int8)
            ks = torch.tensor(0.02, device=dev)
            vs = torch.tensor(0.03, device=dev)
            vmax = 127 * 0.03
            kd = (ck.float() * ks).to(torch.bfloat16)
            vd = (cv.float() * vs).to(torch.bfloat16)
        else:
            ck = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
            cv = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
            ks = vs = None
            vmax = cv.float().abs().max().item()
            kd, vd = ck, cv
        start = torch.full((B,), st, dtype=torch.int32, device=dev)
        out = kf.flash_prefill_attention(q, ck, cv, start, ks, vs)
        ref = kf.flash_prefill_attention_plain(q, ck, cv, start, ks, vs)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2**-8 * vmax + 2**-7 * ref.float().abs().max().item()
        ms = timer(lambda: kf.flash_prefill_attention(q, ck, cv, start, ks, vs))
        plain_ms = timer(lambda: kf.flash_prefill_attention_plain(
            q, ck, cv, start, ks, vs), 5)
        qs = q.reshape(B, T, KH * G, D).transpose(1, 2)
        k4 = kd.reshape(B, S, KH, D).transpose(1, 2)
        v4 = vd.reshape(B, S, KH, D).transpose(1, 2)
        mask = torch.arange(S, device=dev)[None, :] <= (st + torch.arange(T, device=dev))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, k4, v4, attn_mask=mask, enable_gqa=True))
        keys = sum(st + t + 1 for t in range(T))
        nbytes = q.numel() * 2 * 2 + 2 * B * (st + T) * KH * D * ck.element_size()
        record("flash_prefill_attention",
               f"B={B} T={T} S={S} KH={KH} G={G} D={D} {kind} start={st}",
               err, tol, ms, plain_ms, lib_ms, nbytes,
               4 * B * keys * KH * G * D, BF16_FLOPS)


def w4a16_bar(torch, ref, x, wdq) -> float:
    """How far a W4A16 kernel may sit from its plain version: both multiply
    the same bf16 x by the same exact weights in f32 and differ only in the
    order of the f32 sums inside a block (tensor-core MMA against the plain
    matmul), at most K * 2^-24 * max(|x| @ |w|); a sum that differs in its
    last f32 bits may then round to the neighbouring bf16, one bf16 ulp of
    the largest output."""
    K = x.shape[-1]
    order = K * 2.0**-24 * torch.matmul(x.abs().float(), wdq.abs().float()).max().item()
    top = ref.float().abs().max().item()
    return order + 2.0 ** (math.floor(math.log2(top)) - 7)


def moe_kernels(torch, gen, timer, record) -> None:
    """K6, K10 and K12 at the Qwen3-30B-A3B paths' shapes."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant.qtensor import dequantize_int4, quantize_int4

    dev = "cuda"
    log("K6 w4a16_gemm")
    # q_proj, k_proj / v_proj, o_proj, the folded gate / up experts
    for K, N in ((2048, 4096), (2048, 512), (4096, 2048), (2048, 98304)):
        w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        qt = quantize_int4(w)
        wdq = dequantize_int4(qt).to(torch.bfloat16)
        del w
        for M in (8, 544):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            y = kq.w4a16_gemm(x, qt["data"], qt["scale"])
            ref = kq.w4a16_gemm_plain(x, qt["data"], qt["scale"])
            err = (y.float() - ref.float()).abs().max().item()
            tol = w4a16_bar(torch, ref, x, wdq)
            ms = timer(lambda: kq.w4a16_gemm(x, qt["data"], qt["scale"]))
            plain_ms = timer(lambda: kq.w4a16_gemm_plain(x, qt["data"], qt["scale"]), 5)
            lib_ms = timer(lambda: torch.matmul(x, wdq))
            nbytes = M * K * 2 + K * N // 2 + (K // 128) * N * 4 + M * N * 2
            record("w4a16_gemm", f"M={M} K={K} N={N} bf16 out", err, tol, ms, plain_ms,
                   lib_ms, nbytes, 2 * M * K * N, BF16_FLOPS)
        del qt, wdq

    # K10 and K12 at the decode down-projection: E=128 experts of
    # [768, 2048] in the folded layout
    E, K, N = 128, 768, 2048
    w = torch.randn(K, E * N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    qt = quantize_int4(w)
    del w
    wdq = dequantize_int4(qt).to(torch.bfloat16).reshape(K, E, N).transpose(0, 1).contiguous()
    per_expert = K * N // 2 + (K // 128) * N * 4  # packed bytes + scale bytes
    log("K10 grouped_w4a16_gemm")
    for M in (1, 8):  # K6's arithmetic per expert: the same bar, expert by expert
        x = torch.randn(E, M, K, generator=gen, device=dev).to(torch.bfloat16)
        y = kq.grouped_w4a16_gemm(x, qt["data"], qt["scale"], N)
        ref = kq.grouped_w4a16_gemm_plain(x, qt["data"], qt["scale"], N)
        errs = [(y[e].float() - ref[e].float()).abs().max().item() for e in range(E)]
        bars = [w4a16_bar(torch, ref[e], x[e], wdq[e]) for e in range(E)]
        if any(a > b for a, b in zip(errs, bars)):
            raise AssertionError(f"grouped_w4a16_gemm M={M}: an expert exceeds its bar")
        err = max(errs)
        tol = bars[errs.index(err)]
        ms = timer(lambda: kq.grouped_w4a16_gemm(x, qt["data"], qt["scale"], N))
        plain_ms = timer(lambda: kq.grouped_w4a16_gemm_plain(x, qt["data"], qt["scale"], N), 5)
        lib_ms = timer(lambda: torch.bmm(x, wdq))
        record("grouped_w4a16_gemm", f"E={E} M={M} K={K} N={N}", err, tol, ms, plain_ms,
               lib_ms, E * M * K * 2 + E * per_expert + E * M * N * 2, 2 * E * M * K * N,
               BF16_FLOPS)

    log("K12 grouped_w4a8_combine_gemm")
    # K12 — exact integer dots, each expert's f32 block update and gated term
    # rounded as the plain version rounds them, the terms summed in expert
    # order: bit-exact (tolerance 0), and the same bits on a second launch.
    # gscale as the W4A8 decode makes it (8 routed experts per row, gate x
    # the row's activation scale), then dense random. The bound counts the
    # work this gscale needs: the weights of experts some row is routed to,
    # the products of non-zero (expert, row) pairs.
    M = 8
    xs = torch.rand(E, M, 1, generator=gen, device=dev) * 0.05
    xq = torch.randint(-127, 128, (E, M, K), generator=gen, device=dev, dtype=torch.int8)
    routed = torch.zeros(E, M, device=dev)
    top = torch.rand(M, E, generator=gen, device=dev).topk(8, dim=-1).indices
    routed.T.scatter_(1, top, torch.rand(M, 8, generator=gen, device=dev) / 4)
    dense = torch.rand(E, M, generator=gen, device=dev)
    xfq = (xq.float() * xs).to(torch.bfloat16)
    for kind, gates in (("routed", routed), ("dense", dense)):
        gsc = (xs[..., 0] * gates).contiguous()
        y = kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"], N)
        ref = kq.grouped_w4a8_combine_gemm_plain(xq, gsc, qt["data"], qt["scale"], N)
        err = (y - ref).abs().max().item()
        if not torch.equal(y, kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"],
                                                           N)):
            raise AssertionError("grouped_w4a8_combine_gemm: two launches differ")
        ms = timer(lambda: kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"], N))
        plain_ms = timer(lambda: kq.grouped_w4a8_combine_gemm_plain(
            xq, gsc, qt["data"], qt["scale"], N), 5)
        gb = gates.to(torch.bfloat16)
        lib_ms = timer(lambda: torch.einsum("emn,em->mn", torch.bmm(xfq, wdq), gb))
        used = int((gsc != 0).any(dim=1).sum())
        pairs = int((gsc != 0).sum())
        record("grouped_w4a8_combine_gemm", f"E={E} M={M} K={K} N={N} {kind} gscale "
               f"({used} experts used)", err, 0.0, ms, plain_ms, lib_ms,
               used * (M * K + per_expert) + E * M * 4 + M * N * 4, 2 * pairs * K * N,
               INT8_OPS)
    del qt, wdq


# --------------------------------------------------------------------------
# phase 3: small models on the card against the same models on the CPU
# --------------------------------------------------------------------------
def _numpy_variables(cfg, preset, seed=0, router_scale=0.1):
    """Reference-layout variables (nested dict of numpy arrays) drawn from a
    numpy seed: packed int4 weights for the quantized projections (expert
    kernels packed in their folded [in, E*out] view), f32 embedding /
    lm_head / router / norm scales."""
    import numpy as np
    import torch

    from modelopt_tpu_torch.models.transformer import Decoder, Router
    from modelopt_tpu_torch.nn.layers import QuantDense, QuantEinsum, QuantEmbed, RMSNorm
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.qtensor import fold_experts, quantize_qtensor

    rng = np.random.default_rng(seed)
    qcfg = get_config(preset)
    params: dict = {}
    quant: dict = {}

    def put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    for mod in Decoder(cfg, device="meta").modules():
        path = mod.path.split("/")
        if isinstance(mod, (QuantDense, QuantEinsum)):
            shape = ((mod.in_features, mod.features) if isinstance(mod, QuantDense)
                     else mod.kernel_shape)
            w = rng.standard_normal(shape).astype(np.float32)
            w /= np.sqrt(shape[-2])
            specs = qcfg.resolve(mod.path + "/weight_quantizer")
            if specs:
                wt = torch.from_numpy(w)
                qt, _ = quantize_qtensor(wt if wt.dim() == 2 else fold_experts(wt), specs[0])
                put(quant, path + ["qweight", "data"], qt["data"].numpy())
                put(quant, path + ["qweight", "scale"], qt["scale"].numpy())
            else:
                put(params, path + ["kernel"], w)
        elif isinstance(mod, Router):
            put(params, path + ["kernel"], (router_scale * rng.standard_normal(
                tuple(mod.kernel.shape))).astype(np.float32))
        elif isinstance(mod, QuantEmbed):
            put(params, path + ["embedding"],
                rng.standard_normal(tuple(mod.embedding.shape)).astype(np.float32))
        elif isinstance(mod, RMSNorm):
            put(params, path + ["scale"],
                (1.0 + 0.1 * rng.standard_normal(tuple(mod.scale.shape))).astype(np.float32))
    return {"params": params, "quant": quant}


def _router_trace(bundle) -> list:
    """Hook every MoE block of ``bundle`` to record each routing's router
    logits and selected experts (on the CPU)."""
    from modelopt_tpu_torch.models.transformer import MoEBlock

    trace = []
    for blk in (m for m in bundle.module.modules() if isinstance(m, MoEBlock)):
        def route(x, blk=blk, orig=blk.route):
            gates, sel, scores = orig(x)
            trace.append((blk.router(x).float().cpu(), sel.sort(-1).values.cpu()))
            return gates, sel, scores
        blk.route = route
    return trace


def _forward_rows(torch, bundle, cfg, ids, T, steps, kv_dtype, dev):
    """Prefill ids[:, :T] into a fresh cache, then ``steps`` cached decode
    steps; the last position's logits of each forward, [steps + 1, B, V],
    on the CPU."""
    from modelopt_tpu_torch.models import make_cache

    cache = make_cache(cfg, ids.shape[0], 256, dtype=kv_dtype, device=dev)
    out, cache = bundle.apply(ids[:, :T].to(dev), cache)
    rows = [out[:, -1].float().cpu()]
    for t in range(steps):
        out, cache = bundle.apply(ids[:, T + t:T + t + 1].to(dev), cache)
        rows.append(out[:, -1].float().cpu())
    return torch.stack(rows)


def cpu_reference(torch, cfg, preset, kv_dtype, ids_seed, B, T, steps):
    """The CPU half of a parity check: variables drawn from numpy seed 0,
    the model built on the CPU and calibrated there (its k/v amax written
    into the variables, so the card runs with the same scales), the ids
    (torch seed ``ids_seed``), the CPU's logits and its routing trace."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.convert import from_jax_variables
    from modelopt_tpu_torch.quant.api import calibrate

    variables = _numpy_variables(cfg, preset)
    ids = torch.randint(1, cfg.vocab_size, (B, T + steps), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(ids_seed))
    cpu = from_jax_variables(variables, cfg, preset, device="cpu")
    calibrate(cpu, "max", lambda f: f(ids[:, :T], make_cache(cfg, B, 256, device="cpu")))
    for mod in cpu.module.modules():
        if getattr(mod, "amax", None) is not None:
            node = variables["quant"]
            for k in mod.path.split("/"):
                node = node.setdefault(k, {})
            node["amax"] = mod.amax.numpy()
    trace = _router_trace(cpu)
    logits = _forward_rows(torch, cpu, cfg, ids, T, steps, kv_dtype, "cpu")
    return variables, ids, logits, trace


def _parity(torch, name, cfg, preset, kv_dtype, ids_seed, B, T, steps=4):
    """Prefill of B x T tokens then ``steps`` decode steps, the same numpy
    weights on the CPU (plain versions) and on the card (kernels); holds the
    card's logits to 3% of the largest CPU logit. The int8 GEMMs (K1, K12)
    are exact on both devices; bf16 rounding of activations, of attention
    probabilities (online vs one-pass softmax), of K6/K10's f32 sums (MMA vs
    plain order) and of the lm_head product differ. For a routed model the
    log gives how many routings chose the same experts on both devices, the
    largest router-logit difference and the smallest top-k gap of the CPU
    run (the ids are chosen so that gap is well above the difference)."""
    from modelopt_tpu_torch.models.convert import from_jax_variables

    variables, ids, ref, cpu_trace = cpu_reference(torch, cfg, preset, kv_dtype, ids_seed,
                                                   B, T, steps)
    gpu = from_jax_variables(variables, cfg, preset, device="cuda")
    gpu_trace = _router_trace(gpu)
    got = _forward_rows(torch, gpu, cfg, ids, T, steps, kv_dtype, "cuda")
    if not (torch.isfinite(got).all() and got.shape == (steps + 1, B, cfg.vocab_size)):
        raise AssertionError(f"parity {name}: card logits not finite or misshaped")
    err = (got - ref).abs().max().item()
    tol = 3e-2 * ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    routed = ""
    if cpu_trace:
        k = cfg.experts_per_token
        if len(cpu_trace) != len(gpu_trace):
            raise AssertionError(f"parity {name}: {len(cpu_trace)} CPU routings, "
                                 f"{len(gpu_trace)} on the card")
        dlog = max((a[0] - b[0]).abs().max().item() for a, b in zip(cpu_trace, gpu_trace))
        same = sum(int((a[1] == b[1]).all(-1).sum()) for a, b in zip(cpu_trace, gpu_trace))
        total = sum(a[1][..., 0].numel() for a in cpu_trace)
        gap_c, gap_o = router_gaps(cpu_trace, k)
        routed = (f", routings with the same top-{k} experts {same}/{total}, router logits "
                  f"differ by <= {dlog:.3g}; smallest CPU top-{k} gap {gap_c:.3g} at the "
                  f"compared positions, {gap_o:.3g} elsewhere")
    log(f"  {name}: prefill {B} x {T} + {steps} decode steps: max |logit diff| {err:.4g} "
        f"(tol {tol:.4g}), argmax agreement {agree:.3f}{routed}")
    if not err <= tol:
        raise AssertionError(f"parity {name}: card logits off by {err} > {tol}")


def router_gaps(trace, k: int):
    """Smallest gap between the k-th and (k+1)-th router logit of a trace:
    (at the positions whose logits are compared, the prefill's last token
    and every decode step; at the other prefill positions)."""
    compared, other = [], []
    for lg, _ in trace:
        top = lg.topk(k + 1, -1).values
        gap = top[..., k - 1] - top[..., k]  # [B, T]
        compared.append(gap[:, -1].min().item())
        if gap.shape[1] > 1:
            other.append(gap[:, :-1].min().item())
    return min(compared), min(other)


def small_moe_config():
    """A 2-layer Qwen3-MoE at the real per-expert geometry: hidden 2048,
    expert width 768, 32 heads and 4 KV heads of D=128 (G=8), 8 experts,
    top-2, qk-norm, vocab 4096."""
    from modelopt_tpu_torch.models import qwen3_moe_config

    return qwen3_moe_config(num_layers=2, num_experts=8, experts_per_token=2,
                            vocab_size=4096, max_position_embeddings=256)


# torch seed of the small MoE's ids (2 x 16 prefill tokens, 4 decode steps,
# 2 layers): on the CPU, under both presets, every top-2 choice at a compared
# position is at least 0.21 in router logits from a tie, every other at
# least 0.03 (a flip there reaches the compared logits only through
# attention). A choice flipped at a compared position would move the
# logits by a whole expert's output.
MOE_IDS_SEED = 44


def parity_phase(torch) -> None:
    from modelopt_tpu_torch.models import llama_config

    moe = small_moe_config()
    _parity(torch, "Qwen3-MoE W4A8 + int8 KV", moe, "W4A8_INT8KV_CFG", torch.int8,
            MOE_IDS_SEED, 2, 16)
    _parity(torch, "Qwen3-MoE W4A16 + bf16 KV", moe, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG",
            torch.bfloat16, MOE_IDS_SEED, 2, 16)
    llama = llama_config(vocab_size=4096, hidden_size=1024, num_layers=2, num_heads=8,
                         num_kv_heads=2, intermediate_size=2048,
                         max_position_embeddings=256, rope_theta=500000.0,
                         fused_qkv=True, fused_gate_up=True)
    _parity(torch, "llama W4A8 + int8 KV", llama, "W4A8_INT8KV_CFG", torch.int8, 1, 2, 64)


# --------------------------------------------------------------------------
# phase 4: the serving paths on the card
# --------------------------------------------------------------------------
PATHS = {  # name: (title, model, preset, KV cache dtype)
    "B": ("Qwen3-30B-A3B W4A8 + int8 KV", "qwen3_moe", "W4A8_INT8KV_CFG", "int8"),
    "C": ("Qwen3-30B-A3B W4A16 + bf16 KV", "qwen3_moe", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG",
          "bfloat16"),
    "A": ("Llama-3-8B W4A8 + int8 KV", "llama3_8b", "W4A8_INT8KV_CFG", "int8"),
}
TRAFFIC = (8, 1024, 64)  # requests x prompt tokens -> new tokens, every path


def path_config(torch, model: str):
    from modelopt_tpu_torch.models import llama3_8b_config, qwen3_moe_config

    if model == "qwen3_moe":  # full width and depth: 48 layers, 128 experts
        return qwen3_moe_config(max_position_embeddings=2176, param_dtype=torch.bfloat16)
    return llama3_8b_config(max_position_embeddings=2176, param_dtype=torch.bfloat16,
                            fused_qkv=True, fused_gate_up=True)


def serve_path(torch, name) -> dict:
    """Build path ``name``'s compressed model on the card (random weights,
    seed 0); under an int8 KV cache calibrate its scales with one 64-token
    forward; warm the engine up with one request, serve TRAFFIC
    (``measured_run``), profile a window of decode ticks, check one more
    request, and free the model. Returns the measured run's launches."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.quant.api import calibrate, validate_calibration
    from modelopt_tpu_torch.serve import ServingEngine, run_serving_benchmark

    title, model, preset, kv = PATHS[name]
    cfg = path_config(torch, model)
    kv_dtype = getattr(torch, kv)
    t0 = time.time()
    bundle = build_compressed_bundle(cfg, preset, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  built compressed model ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts) in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if kv_dtype == torch.int8:
        ids = torch.randint(1, cfg.vocab_size, (1, 64), dtype=torch.int32, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        calibrate(bundle, "max", lambda f: f(ids, make_cache(cfg, 1, 64, device="cuda")))
        bad = validate_calibration(bundle)
        n_amax = sum(getattr(m, "amax", None) is not None for m in bundle.module.modules())
        log(f"  calibrated: {n_amax} quantizers hold an amax, {len(bad)} invalid")
    eng = ServingEngine(bundle, max_batch=8, max_seq_len=2176, prefill_buckets=(32, 544),
                        kv_dtype=kv_dtype, multi_step=16, max_admit=1, device="cuda")
    t0 = time.time()
    run_serving_benchmark(eng, n_requests=1, input_len=TRAFFIC[1], output_len=8,
                          vocab=cfg.vocab_size)
    log(f"  warm-up request {time.time() - t0:.1f} s")
    launches = measured_run(torch, eng, name)
    profile_window(torch, eng, 8, 32, 24, cfg.vocab_size)
    check_output(torch, eng, cfg.vocab_size)
    del eng, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def measured_run(torch, eng, name) -> dict:
    """Serve TRAFFIC with the launch counters zeroed just before and read
    just after; check that every request got its tokens, that every kernel
    of the path launched and that the other preset's kernels did not.
    Returns the counts."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.serve import run_serving_benchmark

    n_req, in_len, out_len = TRAFFIC
    torch.cuda.reset_peak_memory_stats()
    eng.stats = dict.fromkeys(eng.stats, 0)  # count the measured run only
    kernels.reset_launch_counts()
    rep = run_serving_benchmark(eng, n_requests=n_req, input_len=in_len,
                                output_len=out_len, vocab=eng.cfg.vocab_size, seed=1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  {n_req} requests x {in_len} prompt -> {out_len} new tokens: output "
        f"{rep['output_tok_s']:.1f} tok/s, TTFT first {rep['ttft_first_s']:.3f} s "
        f"mean {rep['ttft_mean_s']:.3f} s, decode {rep['decode_tok_s']:.1f} tok/s, "
        f"total {rep['total_s']:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  engine stats {rep['engine_stats']}")
    log(f"  launches on path {name}: {launches}")
    if rep["output_tokens"] != n_req * out_len:
        raise AssertionError(f"path {name}: {rep['output_tokens']} tokens, "
                             f"expected {n_req} x {out_len}")
    missing = [k for k in PATH_KERNELS[name] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"path {name} never launched {missing}")
    strays = [k for k in launches if k not in PATH_KERNELS[name] and launches[k]]
    if strays:
        raise AssertionError(f"path {name} launched {strays}, kernels of another path")
    return launches


def check_output(torch, eng, vocab_size) -> None:
    """One more request: 16 tokens in the vocabulary, finite log-probs <= 0."""
    req = eng.submit(list(range(1, 200)), max_new_tokens=16)
    eng.run()
    lps = torch.tensor(req.out_logprobs)
    if not (len(req.out_tokens) == 16 and all(0 <= t < vocab_size for t in req.out_tokens)
            and torch.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError(f"bad output {req.out_tokens} {req.out_logprobs}")


def profile_window(torch, eng, n_req: int, in_len: int, out_len: int, vocab: int) -> None:
    """torch.profiler over a short window of decode ticks (n_req fresh
    prompts of in_len tokens, prefilled before the window opens, out_len new
    tokens each): device time by kernel, kernel launches, device busy time
    against the wall clock. The profiler's own host cost lengthens the wall
    time, so the idle share read here is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(7)
    reqs = [eng.submit(torch.randint(1, vocab, (in_len,), generator=rng).tolist(),
                       max_new_tokens=out_len) for _ in range(n_req)]
    while not all(r.out_tokens for r in reqs):  # prefills first
        eng.step()
    torch.cuda.synchronize()
    forwards = eng.stats["decode_forwards"], eng.stats["prefill_chunks"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    n_launch = 0
    for ev in prof.key_averages():
        # device-side events only: a host op's self device time repeats the
        # time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
            n_launch += ev.count
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(v for n, v in by_name.items() if k in n) for k in (
        "w4a8_kernel", "w4a16_kernel", "grouped_w4a8_combine_kernel", "fused_decode_kernel",
        "flash_prefill_kernel", "kv_write_kernel")}
    log(f"  profile window ({n_req} requests x {in_len} -> {out_len} tokens, decode ticks "
        f"only; "
        f"{eng.stats['decode_forwards'] - forwards[0]} decode forwards, "
        f"{eng.stats['prefill_chunks'] - forwards[1]} prefill chunks): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms in {n_launch} kernels"
        + (f", idle share <= {1 - busy / (wall * 1e3):.3f}" if busy else
           " (no device time recorded: not measured)"))
    for name, ms in top:
        log(f"    {ms:9.2f} ms  {name[:90]}")
    log(f"    port kernels (ms): {json.dumps({k: round(v, 3) for k, v in ours.items()})}")


# --------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from modelopt_tpu_torch.kernels import _build

    t_start = time.time()
    # full-f32 products: a TF32 router product could flip a top-8 expert
    # choice and change tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off (matmul and cuDNN)")
    t0 = time.time()
    _build.build_all()
    log(f"kernel build {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results: dict = {}
    kernel_phase(torch, results)
    log(f"parity: small models, card against CPU ({time.time() - t_start:.0f} s)")
    parity_phase(torch)
    by_path = {}
    for name in PATHS:
        log(f"path {name}: {PATHS[name][0]}, ServingEngine ({time.time() - t_start:.0f} s)")
        by_path[name] = serve_path(torch, name)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        shapes = results[name]
        head = next((r for r in shapes if r["shape"] in PRIMARY), shapes[0])
        per_path = {p: c[name] for p, c in by_path.items() if c[name]}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": sum(per_path.values()),
                     **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")},
                     "launches_by_path": per_path, "shapes": shapes})
    log(f"total {time.time() - t_start:.0f} s")
    log(card_line())  # again, beside the numbers at the end of the log
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
