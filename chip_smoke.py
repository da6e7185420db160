#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), versions, kernel build time;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the main path's shapes — max abs error against a stated
     tolerance, kernel / plain / library-call times (CUDA events, median of
     25 launches, L2 flushed before each) and the least time the card could
     take for the same work;
  3. parity: a 2-layer llama model at the main path's head geometry, built
     from the same numpy weights on the CPU (plain versions) and on the card
     (kernels), prefill and 4 decode steps compared;
  4. main path: Llama-3-8B (full width and depth, random weights from a
     seed) under W4A8_INT8KV_CFG, KV scales calibrated by one forward,
     served by ServingEngine at max_seq_len 2176 with prefill buckets
     (32, 544): 8 requests of 1024 prompt tokens, each streamed in two
     chunks (rows 0-543, then 544-1023 padded to 544), 64 new tokens each,
     greedy. Launch counters are zeroed just before the run
     and read just after: every kernel must have launched. Then two
     torch.profiler windows (prefill only; decode-dominated) give device
     time by kernel and the device's idle share.
Then one JSON line of per-kernel numbers, and last the device line.
To iterate on one phase, import this module and call its phase function
(``kernel_phase``, ``parity_phase``, ``main_phase``) directly.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
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
           "B=8 S=2176 KH=8 G=4 D=128 int8 ragged pos")

SOURCES = {
    "w4a8_gemm": ("modelopt_tpu_torch/csrc/w4a8_gemm.cu",
                  "modelopt_tpu/kernels/quant_gemm.py:425"),
    "dense_kv_write": ("modelopt_tpu_torch/csrc/kv_write.cu",
                       "modelopt_tpu/kernels/attention.py:342"),
    "fused_decode_attention": ("modelopt_tpu_torch/csrc/fused_decode_attention.cu",
                               "modelopt_tpu/kernels/attention.py:544"),
    "flash_prefill_attention": ("modelopt_tpu_torch/csrc/flash_prefill_attention.cu",
                                "modelopt_tpu/kernels/flash_attention.py:175"),
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
    B, S, KH, G, D = 8, 2176, 8, 4, 128
    pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0],
                       dtype=torch.int32, device=dev)
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
        record("fused_decode_attention", f"B={B} S={S} KH={KH} G={G} D={D} {kind} ragged pos",
               err, tol, ms, plain_ms, lib_ms, nbytes, 4 * live * KH * G * D, rate)

    # K4 — online softmax vs one pass: the kernel rounds unnormalised
    # probabilities to bf16, the plain version normalised ones, each within
    # 2^-8 relative. Were every rounding maximal and of one sign on both
    # sides, the f32 outputs would differ by 2 * 2^-8 * max|v| (max|v| =
    # 127 * vs); hundreds of independent roundings per row leave far less,
    # so the bar takes half of that, 2^-8 * max|v|. Rounding the outputs to
    # bf16 adds one ulp, <= 2^-7 * max|ref| (0.0078 measured on an H100).
    log("K4 flash_prefill_attention")
    B, T, S, KH, G, D, st = 1, 544, 2176, 8, 4, 128, 544
    q = torch.randn(B, T, KH, G, D, generator=gen, device=dev).to(torch.bfloat16)
    ck = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                       dtype=torch.int8)
    cv = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.tensor(0.02, device=dev)
    vs = torch.tensor(0.03, device=dev)
    start = torch.full((B,), st, dtype=torch.int32, device=dev)
    out = kf.flash_prefill_attention(q, ck, cv, start, ks, vs)
    ref = kf.flash_prefill_attention_plain(q, ck, cv, start, ks, vs)
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2**-8 * 127 * 0.03 + 2**-7 * ref.float().abs().max().item()
    ms = timer(lambda: kf.flash_prefill_attention(q, ck, cv, start, ks, vs))
    plain_ms = timer(lambda: kf.flash_prefill_attention_plain(
        q, ck, cv, start, ks, vs), 5)
    qs = q.reshape(B, T, KH * G, D).transpose(1, 2)
    kd = (ck.float() * ks).to(torch.bfloat16).reshape(B, S, KH, D).transpose(1, 2)
    vd = (cv.float() * vs).to(torch.bfloat16).reshape(B, S, KH, D).transpose(1, 2)
    mask = torch.arange(S, device=dev)[None, :] <= (st + torch.arange(T, device=dev))[:, None]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask, enable_gqa=True))
    keys = sum(st + t + 1 for t in range(T))
    nbytes = q.numel() * 2 * 2 + 2 * B * (st + T) * KH * D
    record("flash_prefill_attention", f"B={B} T={T} S={S} KH={KH} G={G} D={D} int8 start={st}",
           err, tol, ms, plain_ms, lib_ms, nbytes,
           4 * B * keys * KH * G * D, BF16_FLOPS)


# --------------------------------------------------------------------------
# phase 3: a small model on the card against the same model on the CPU
# --------------------------------------------------------------------------
def _numpy_variables(cfg, preset, seed=0):
    """Reference-layout variables (nested dict of numpy arrays) drawn from a
    numpy seed: packed int4 weights for the quantized projections, f32
    embedding / lm_head / norm scales."""
    import numpy as np
    import torch

    from modelopt_tpu_torch.models.transformer import Decoder
    from modelopt_tpu_torch.nn.layers import QuantDense, QuantEmbed, RMSNorm
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.qtensor import quantize_qtensor

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
        if isinstance(mod, QuantDense):
            w = rng.standard_normal((mod.in_features, mod.features)).astype(np.float32)
            w /= np.sqrt(mod.in_features)
            specs = qcfg.resolve(mod.path + "/weight_quantizer")
            if specs:
                qt, _ = quantize_qtensor(torch.from_numpy(w), specs[0])
                put(quant, path + ["qweight", "data"], qt["data"].numpy())
                put(quant, path + ["qweight", "scale"], qt["scale"].numpy())
            else:
                put(params, path + ["kernel"], w)
        elif isinstance(mod, QuantEmbed):
            put(params, path + ["embedding"],
                rng.standard_normal(tuple(mod.embedding.shape)).astype(np.float32))
        elif isinstance(mod, RMSNorm):
            put(params, path + ["scale"],
                (1.0 + 0.1 * rng.standard_normal(tuple(mod.scale.shape))).astype(np.float32))
    return {"params": params, "quant": quant}


def parity_phase(torch) -> None:
    from modelopt_tpu_torch.models import llama_config, make_cache
    from modelopt_tpu_torch.models.convert import from_jax_variables
    from modelopt_tpu_torch.quant.api import calibrate

    preset = "W4A8_INT8KV_CFG"
    cfg = llama_config(vocab_size=4096, hidden_size=1024, num_layers=2, num_heads=8,
                       num_kv_heads=2, intermediate_size=2048,
                       max_position_embeddings=256, rope_theta=500000.0,
                       fused_qkv=True, fused_gate_up=True)
    variables = _numpy_variables(cfg, preset)
    B, T, S, steps = 2, 64, 256, 4
    ids = torch.randint(1, cfg.vocab_size, (B, T + steps), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    cpu = from_jax_variables(variables, cfg, preset, device="cpu")
    calibrate(cpu, "max", lambda f: f(ids[:, :T], make_cache(cfg, B, S, device="cpu")))
    for mod in cpu.module.modules():  # the card runs with the CPU's scales
        if getattr(mod, "amax", None) is not None:
            node = variables["quant"]
            for k in mod.path.split("/"):
                node = node.setdefault(k, {})
            node["amax"] = mod.amax.numpy()
    gpu = from_jax_variables(variables, cfg, preset, device="cuda")
    logits = {}
    for name, bundle, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        cache = make_cache(cfg, B, S, dtype=torch.int8, device=dev)
        out, cache = bundle.apply(ids[:, :T].to(dev), cache)
        rows = [out[:, -1].float().cpu()]
        for t in range(steps):
            out, cache = bundle.apply(ids[:, T + t:T + t + 1].to(dev), cache)
            rows.append(out[:, -1].float().cpu())
        logits[name] = torch.stack(rows)
    ref, got = logits["cpu"], logits["gpu"]
    if not (torch.isfinite(got).all() and got.shape == (steps + 1, B, cfg.vocab_size)):
        raise AssertionError("parity: card logits not finite or misshaped")
    # int8 GEMMs are exact on both; bf16 rounding of activations, attention
    # probabilities (online vs one-pass softmax) and the lm_head product
    # differ: hold the card to 3% of the largest logit
    err = (got - ref).abs().max().item()
    tol = 3e-2 * ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"  prefill + {steps} decode steps, {B} slots: max |logit diff| {err:.4g} "
        f"(tol {tol:.4g}), argmax agreement {agree:.3f}")
    if not err <= tol:
        raise AssertionError(f"parity: card logits off by {err} > {tol}")


# --------------------------------------------------------------------------
# phase 4: the main path — Llama-3-8B W4A8 + int8 KV served on the card
# --------------------------------------------------------------------------
def main_phase(torch) -> dict:
    """Serve the main path; returns the launch counts of its measured run."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.models import llama3_8b_config, make_cache
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.quant.api import calibrate, validate_calibration
    from modelopt_tpu_torch.serve import ServingEngine, run_serving_benchmark

    n_req, in_len, out_len, seq = 8, 1024, 64, 2176
    cfg = llama3_8b_config(max_position_embeddings=seq, param_dtype=torch.bfloat16,
                           fused_qkv=True, fused_gate_up=True)
    t0 = time.time()
    bundle = build_compressed_bundle(cfg, "W4A8_INT8KV_CFG", seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  built compressed Llama-3-8B ({cfg.num_layers} layers) in "
        f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ids = torch.randint(1, 128000, (1, 64), dtype=torch.int32, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    calib_cache = make_cache(cfg, 1, 64, device="cuda")
    calibrate(bundle, "max", lambda f: f(ids, calib_cache))
    del calib_cache
    validate_calibration(bundle)
    eng = ServingEngine(bundle, max_batch=8, max_seq_len=seq, prefill_buckets=(32, 544),
                        kv_dtype=torch.int8, multi_step=16, max_admit=1, device="cuda")
    t0 = time.time()
    run_serving_benchmark(eng, n_requests=1, input_len=in_len, output_len=8,
                          vocab=128000)
    log(f"  warm-up request {time.time() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    eng.stats = dict.fromkeys(eng.stats, 0)  # count the measured run only
    kernels.reset_launch_counts()
    rep = run_serving_benchmark(eng, n_requests=n_req, input_len=in_len,
                                output_len=out_len, vocab=128000, seed=1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  {n_req} requests x {in_len} prompt -> {out_len} new tokens: output "
        f"{rep['output_tok_s']:.1f} tok/s, TTFT first {rep['ttft_first_s']:.3f} s "
        f"mean {rep['ttft_mean_s']:.3f} s, decode {rep['decode_tok_s']:.1f} tok/s, "
        f"total {rep['total_s']:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  engine stats {rep['engine_stats']}")
    log(f"  launches on the main path: {launches}")
    if rep["output_tokens"] != n_req * out_len:
        raise AssertionError(f"main path: {rep['output_tokens']} tokens, "
                             f"expected {n_req} x {out_len}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # where the time goes: a prefill-only window, then a decode-dominated one
    profile_window(torch, eng, 4, in_len, 1)
    profile_window(torch, eng, 8, 32, 48)
    req = eng.submit(list(range(1, 200)), max_new_tokens=16)
    eng.run()
    lps = torch.tensor(req.out_logprobs)
    if not (len(req.out_tokens) == 16 and all(0 <= t < cfg.vocab_size for t in req.out_tokens)
            and torch.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError(f"main path: bad output {req.out_tokens} {req.out_logprobs}")
    return launches


def profile_window(torch, eng, n_req: int, in_len: int, out_len: int) -> None:
    """torch.profiler over a short serving window (n_req fresh prompts of
    in_len tokens, out_len new tokens each): device time by kernel, kernel
    launches, device busy time against the wall clock. The profiler's own
    host cost lengthens the wall time, so the idle share read here is an
    upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(7)
    for _ in range(n_req):
        eng.submit(torch.randint(1, 128000, (in_len,), generator=rng).tolist(),
                   max_new_tokens=out_len)
    torch.cuda.synchronize()
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
        "w4a8_kernel", "fused_decode_kernel", "flash_prefill_kernel", "kv_write_kernel")}
    log(f"  profile window ({n_req} requests x {in_len} -> {out_len} tokens): wall "
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.build_all()
    log(f"kernel build {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results: dict = {}
    kernel_phase(torch, results)
    log("parity: small llama model, card against CPU")
    parity_phase(torch)
    log("main path: Llama-3-8B W4A8 + int8 KV, ServingEngine")
    launches = main_phase(torch)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        shapes = results[name]
        head = next((r for r in shapes if r["shape"] in PRIMARY), shapes[0])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")},
                     "shapes": shapes})
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
