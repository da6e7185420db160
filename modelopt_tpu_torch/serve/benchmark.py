"""End-to-end serving benchmark harness (port of
``modelopt_tpu/serve/benchmark.py``): full requests flow through chunked
prefill and continuous-batching decode; the report is OUTPUT-token
throughput over the whole lifecycle plus TTFT. The engine's host loop reads
every tick's tokens back from the device, so wall-clock here is end-to-end
time.
"""

from __future__ import annotations

import time

import numpy as np


def run_serving_benchmark(
    engine,
    *,
    n_requests: int,
    input_len: int,
    output_len: int,
    vocab: int = 32000,
    seed: int = 0,
    max_ticks: int = 1_000_000,
) -> dict:
    """Submit ``n_requests`` random prompts of ``input_len`` tokens, run the
    engine to completion, and report protocol throughput.

    Returns a dict with: ``output_tok_s`` (n_requests*output_len / total
    wall), ``ttft_first_s`` / ``ttft_mean_s`` (submit -> first token, all
    requests submitted at t0), ``decode_tok_s`` (emission rate after the
    last prefill completed), ``prefill_s``, ``total_s``, and the engine's
    own stats counters. Run once with a couple of warmup requests first if
    compile time must stay out of the measurement."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, vocab, size=(n_requests, input_len))
    reqs = [
        engine.submit([int(t) for t in p], max_new_tokens=output_len)
        for p in prompts
    ]
    t0 = time.time()
    first_tok = [None] * n_requests
    prefill_done_t = None
    prefill_done_emitted = 0
    ticks = 0
    while not all(r.done for r in reqs):
        if ticks >= max_ticks:
            raise RuntimeError("serving benchmark exceeded max_ticks")
        engine.step()
        ticks += 1
        now = time.time()
        for i, r in enumerate(reqs):
            if first_tok[i] is None and r.out_tokens:
                first_tok[i] = now - t0
        if prefill_done_t is None and all(f is not None for f in first_tok):
            prefill_done_t = now
            prefill_done_emitted = sum(len(r.out_tokens) for r in reqs)
    total_s = time.time() - t0
    out_tokens = sum(len(r.out_tokens) for r in reqs)
    decode_tokens = out_tokens - prefill_done_emitted
    decode_s = max(time.time() - prefill_done_t, 1e-9)
    return {
        "n_requests": n_requests,
        "input_len": input_len,
        "output_len": output_len,
        "total_s": total_s,
        "output_tokens": out_tokens,
        "output_tok_s": out_tokens / total_s,
        "ttft_first_s": first_tok[0],
        "ttft_mean_s": float(np.mean([f for f in first_tok])),
        "prefill_s": (prefill_done_t - t0) if prefill_done_t else total_s,
        "decode_tok_s": decode_tokens / decode_s if decode_tokens else 0.0,
        "ticks": ticks,
        "engine_stats": dict(engine.stats),
    }
