"""Serving engine: the port's ServingEngine against the JAX one, greedy,
token for token, on a tiny W4A8 model (f32 model dtype, f32 KV cache) with
three staggered requests, one of them streamed in chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.serve import ServingEngine
from modelopt_tpu_torch.serve.benchmark import run_serving_benchmark
from tests._test_utils.pallas_interpret import interpreted_kernels  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRESET = "W4A8_INT8_DYNAMIC_CFG"
WIDE = dict(hidden_size=256, intermediate_size=512, fused_qkv=True, fused_gate_up=True)
# Greedy parity needs no near-ties: the port's attention kernels take bf16
# operands where the reference's CPU path runs f32 einsums, which moves a
# logit by up to ~0.1 here. These prompts (numpy seed 5) keep every greedy
# choice of the first 7 tokens at least 0.33 above its runner-up in the
# reference; the second streams in chunks of 16 + 4.
PROMPTS = [[225, 48, 17, 96, 174],
           [32, 222, 87, 58, 139, 229, 226, 223, 79, 5, 199, 181, 197, 1, 10, 129,
            86, 112, 238, 52],
           [44, 204, 204]]


@pytest.fixture(scope="module")
def bundles():
    """JAX bundle with numpy-drawn weights (projections packed by the
    reference), and the port's copy. A wide lm_head (x4) spreads the logits
    so greedy choices are not near-ties at f32 rounding."""
    rng = np.random.default_rng(0)
    cfg = jt.tiny_test_config(dtype=jnp.float32, **WIDE)
    module = jt.Decoder(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    qcfg = jget_config(PRESET)
    params, quant = {}, {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            w = rng.standard_normal(leaf.shape).astype(np.float32) / np.sqrt(leaf.shape[0])
            if qcfg.resolve("/".join(keys[:-1]) + "/weight_quantizer"):
                quant = set_in(quant, keys[:-1] + ("qweight",), jq.quantize_int4(jnp.asarray(w)))
            else:
                params = set_in(params, keys, jnp.asarray(4.0 * w))
        elif keys[-1] == "scale":
            params = set_in(params, keys, jnp.ones(leaf.shape, jnp.float32))
        else:
            params = set_in(params, keys, jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32))
    jb = ModelBundle(module=module, variables={"params": params, "quant": quant},
                     example_inputs=(ids,),
                     records=(ModeRecord("quantize", qcfg, {}), ModeRecord("compress", {}, {})))
    tb = from_jax_variables(jax.tree.map(np.asarray, jb.variables),
                            tt.tiny_test_config(dtype=torch.float32, **WIDE), PRESET,
                            device="cpu")
    return jb, tb


def _serve(engine):
    reqs = [engine.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
    for _ in range(2):
        engine.step()
    reqs.append(engine.submit(PROMPTS[2], max_new_tokens=6))  # late arrival
    engine.run()
    return reqs


def test_greedy_tokens_match_reference_engine(bundles):
    jb, tb = bundles
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)
    want = _serve(JaxEngine(jb, **kw))
    got = _serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        # logprobs of the same tokens: the port's attention kernels take bf16
        # operands (as the reference's kernels do) where the reference's CPU
        # path runs f32 einsums, which moves a logprob by up to ~0.07 here
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.15)


def test_greedy_tokens_match_interpreted_reference_engine(bundles, interpreted_kernels):
    """The same seed-5 prompts against the JAX engine run through its
    interpret-mode decode kernel (K2 on the f32 cache): the same tokens and
    stop reasons; log-probs within 0.15 (the prefill still differs: the
    port's K4 twin against the reference's einsums on these short chunks)."""
    jb, tb = bundles
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)
    want = _serve(JaxEngine(jb, **kw))
    got = _serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.15)


def test_burst_decode_matches_single_steps(bundles):
    """multi_step bursts (one host sync per burst) emit the same tokens."""
    _, tb = bundles
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), device="cpu")
    e1 = ServingEngine(tb, **kw)
    e4 = ServingEngine(tb, multi_step=4, **kw)
    r1 = [e1.submit(p, max_new_tokens=7) for p in PROMPTS[:2]]
    r4 = [e4.submit(p, max_new_tokens=7) for p in PROMPTS[:2]]
    e1.run()
    e4.run()
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in r4]
    assert e4.stats["decode_forwards"] >= 4


def test_eos_and_stop_sequences(bundles):
    _, tb = bundles
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), device="cpu")
    e = ServingEngine(tb, **kw)
    base = e.submit(PROMPTS[0], max_new_tokens=6)
    e.run()
    toks = base.out_tokens
    e = ServingEngine(tb, **kw)
    r_eos = e.submit(PROMPTS[0], max_new_tokens=6, eos_id=toks[2])
    r_stop = e.submit(PROMPTS[0], max_new_tokens=6, stop_sequences=[toks[1:3]])
    e.run()
    assert r_eos.stop_reason == "eos" and r_eos.out_tokens == toks[:toks.index(toks[2]) + 1]
    assert r_stop.stop_reason == "stop" and r_stop.out_tokens == toks[:1]


def test_temperature_runs_and_unported_options_raise(bundles):
    _, tb = bundles
    e = ServingEngine(tb, max_batch=2, max_seq_len=64, prefill_buckets=(8, 16),
                      device="cpu", seed=3)
    r = e.submit(PROMPTS[0], max_new_tokens=5, temperature=0.8)
    e.run()
    assert len(r.out_tokens) == 5 and all(lp <= 0 for lp in r.out_logprobs)
    with pytest.raises(NotImplementedError):
        e.submit(PROMPTS[0], top_k=5)
    with pytest.raises(NotImplementedError):
        e.submit(PROMPTS[0], repetition_penalty=1.2)
    with pytest.raises(NotImplementedError):
        ServingEngine(tb, speculative=1, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ServingEngine(tb, max_seq_len=60, prefill_buckets=(8, 16), device="cpu")


def test_serving_benchmark_counts(bundles):
    _, tb = bundles
    e = ServingEngine(tb, max_batch=2, max_seq_len=64, prefill_buckets=(8, 16),
                      multi_step=4, device="cpu")
    rep = run_serving_benchmark(e, n_requests=3, input_len=20, output_len=5, vocab=256)
    assert rep["output_tokens"] == 15 and rep["engine_stats"]["prefill_chunks"] == 6
