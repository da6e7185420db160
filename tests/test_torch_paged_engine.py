"""Paged KV serving on the CPU: the port's Decoder over page pools and its
paged ServingEngine, each held against the JAX package. MHA with int8 and
bf16 pools (a llama of head_dim 128, so decode runs K15's twin) and MLA
with an int8 latent pool; the reference's paged engine cases (matches an
uncached greedy loop, pages returned, a short pool requeues, a chunked
long prompt, bursts) and a slot served to the cache cap. Reference models
are built from numpy weights, compressed by the reference's ``compress``
and carried into the port by ``from_jax_variables``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu.serve import paged_cache as jpc
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.serve import ServingEngine
from modelopt_tpu_torch.serve import paged_cache as tpc
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


W4A8 = "W4A8_INT8KV_CFG"
B, T, S, STEPS, PS = 2, 8, 32, 4, 8
# a llama with the attention kernels' head_dim, fused projections as path E
LLAMA = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
             head_dim=128, intermediate_size=512, max_position_embeddings=256,
             fused_qkv=True, fused_gate_up=True)


def port_cfg(model, tdtype=torch.bfloat16):
    if model == "mha":
        return tt.llama_config(dtype=tdtype, **LLAMA)
    if model == "mla":
        return tt.small_mla_compressed_config(dtype=tdtype, experts_per_token=4)
    return tt.tiny_mla_test_config(dtype=tdtype)


def jax_cfg(tcfg, jdtype):
    """The reference's DecoderConfig with the port config's fields."""
    names = [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]
    return jt.DecoderConfig(dtype=jdtype, **{n: getattr(tcfg, n) for n in names})


def float_bundle(tcfg, preset, jdtype, seed=0, lm_scale=1.0):
    """A JAX ModelBundle of f32 weights drawn from numpy (kernels N(0, 1/fin),
    the router N(0, 0.01), norm scales 1 + 0.1 N(0, 1), the embedding
    N(0, 1)), with the preset's quantize record when one is given."""
    rng = np.random.default_rng(seed)
    module = jt.Decoder(jax_cfg(tcfg, jdtype))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel" and "router" in keys:
            arr = rng.standard_normal(leaf.shape) * 0.1
        elif keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
            if "lm_head" in keys:
                arr = arr * lm_scale
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    records = (ModeRecord("quantize", jget_config(preset), {}),) if preset else ()
    return ModelBundle(module=module, variables={"params": params}, example_inputs=(ids,),
                       records=records)


def jax_calibrate(jb):
    """One calibration forward of the reference (k/v or latent amax),
    through a model-dtype dense cache as the port calibrates."""
    ids = jnp.asarray(np.random.default_rng(1).integers(1, jb.module.cfg.vocab_size, (B, T)),
                      jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, ids, jt.make_cache(jb.module.cfg, B, S))
    return jb.replace(variables={**jb.variables, "quant": mut["quant"]})


def compressed_pair(model, tdtype, jdtype, seed=0, lm_scale=1.0):
    """The reference bundle under W4A8_INT8KV_CFG, compressed and calibrated
    by the reference, and the port's copy of it."""
    tcfg = port_cfg(model, tdtype)
    jb = jax_calibrate(jcompress(float_bundle(tcfg, W4A8, jdtype, seed, lm_scale)))
    tb = from_jax_variables(jax.tree.map(np.asarray, jb.variables), tcfg, W4A8, device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def bf16_models():
    return {m: compressed_pair(m, torch.bfloat16, jnp.bfloat16) for m in ("mha", "mla")}


def _paged_caches(tcfg, jcfg, kv):
    """Both packages' paged caches with the same page tables: pages handed
    out in turns (slot 0 gets 1, 3, 5, 7; slot 1 gets 2, 4, 6, 8), so each
    slot's pages are scattered over the pool."""
    pmax = S // PS
    jdt, tdt = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16)}[kv]
    jc = jpc.make_paged_cache(jcfg, B, jpc.PagedCacheConfig(PS, B * pmax + 1, pmax), dtype=jdt)
    tc = tpc.make_paged_cache(tcfg, B, tpc.PagedCacheConfig(PS, B * pmax + 1, pmax),
                              dtype=tdt, device="cpu")
    alloc = tpc.PagedAllocator(B * pmax + 1)
    for _ in range(pmax):
        for b in range(B):
            alloc.alloc(b, 1)
    for b in range(B):
        jc = jpc.write_page_table(jc, b, alloc.owned[b])
        tc = tpc.write_page_table(tc, b, alloc.owned[b])
    assert tc["page_table"][0].tolist() == [1, 3, 5, 7]
    return jc, tc


@pytest.mark.parametrize("model,kv", [("mha", "int8"), ("mha", "bf16"), ("mla", "int8")])
def test_paged_cached_logits_match(bf16_models, model, kv):
    """Prefill of B x T then STEPS teacher-forced decode steps over paged
    caches. The reference's CPU path attends every forward with the dense
    gather and einsums; the port prefills the same way and decodes through
    K15's twin (q and probabilities requantized to 8 and 7 bits on an int8
    pool, bf16 PV operands on a bf16 pool). Held at the int8-KV attention
    bar, 4e-2 of the logit range, greedy choices at the prefill's end
    agree, and the lengths and page table come back. MLA prefills through
    the same einsums over a dense latent cache, so there the paged port's
    prefill equals the dense port's bit for bit."""
    jb, tb = bf16_models[model]
    jc, tc = _paged_caches(tb.module.cfg, jb.module.cfg, kv)
    ids = np.random.default_rng(3).integers(1, 512, (B, T + STEPS)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    lj, jc = fn(jb.variables, jnp.asarray(ids[:, :T]), jc)
    want = [np.asarray(lj[:, -1], np.float32)]
    for t in range(STEPS):
        lj, jc = fn(jb.variables, jnp.asarray(ids[:, T + t:T + t + 1]), jc)
        want.append(np.asarray(lj[:, -1], np.float32))
    pt = tc["page_table"]
    lt, tc = tb.apply(torch.from_numpy(ids[:, :T]), tc)
    got = [lt[:, -1].float().numpy()]
    for t in range(STEPS):
        lt, tc = tb.apply(torch.from_numpy(ids[:, T + t:T + t + 1]), tc)
        got.append(lt[:, -1].float().numpy())
    want, got = np.stack(want), np.stack(got)
    assert tc["lengths"].tolist() == [T + STEPS] * B and tc["page_table"] is pt
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))
    if model == "mla":
        dense = tt.make_cache(tb.module.cfg, B, S, dtype=tc["k"][0].dtype, device="cpu")
        ld, _ = tb.apply(torch.from_numpy(ids[:, :T]), dense)
        np.testing.assert_array_equal(ld[:, -1].float().numpy(), got[0])


def test_paged_decode_dispatch(bf16_models, monkeypatch):
    """Every forward writes through K16 once a layer (K and V together for
    MHA, the latent row); a decode step runs K15 on int8 pools of both
    families and on the MHA bf16 pool, never on a bf16 latent pool (the
    reference's rule); prefill never runs it."""
    from modelopt_tpu_torch.models import mla as tm

    seen = []

    def spy(name, real):
        def f(*a, **k):
            seen.append(name)
            return real(*a, **k)
        return f

    for mod in (tt, tm):
        monkeypatch.setattr(mod, "paged_kv_write_rows", spy("write", mod.paged_kv_write_rows))
        monkeypatch.setattr(mod, "paged_decode_attention",
                            spy("attend", mod.paged_decode_attention))
    counts = {}
    for model in ("mha", "mla"):
        jb, tb = bf16_models[model]
        for kv in ("int8", "bf16"):
            _, tc = _paged_caches(tb.module.cfg, jb.module.cfg, kv)
            seen.clear()
            _, tc = tb.apply(torch.ones(B, 4, dtype=torch.int32), tc)
            prefill = list(seen)
            seen.clear()
            tb.apply(torch.ones(B, 1, dtype=torch.int32), tc)
            counts[model, kv] = (prefill.count("write"), prefill.count("attend"),
                                 seen.count("write"), seen.count("attend"))
    assert counts == {("mha", "int8"): (2, 0, 2, 2), ("mha", "bf16"): (2, 0, 2, 2),
                      ("mla", "int8"): (2, 0, 2, 2), ("mla", "bf16"): (2, 0, 2, 0)}


# --------------------------------------------------------------------------
# serving: both engines, f32 model dtype
# --------------------------------------------------------------------------
# The second prompt streams in chunks of 16 + 4, the third arrives after two
# ticks. Numpy seed 24: on these prompts every greedy choice of the port's
# paged engines below is at least 0.06 above its runner-up (0.007 on the
# dense tests' seed 5, where the int8 MLA engine's pages round one choice
# the other way).
PROMPT_LENS = (5, 20, 3)


def _prompts(vocab):
    rng = np.random.default_rng(24)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def f32_models():
    """f32 model dtype (the engines' tests): the llama and the small MLA
    under W4A8_INT8KV_CFG with int8 pools, and the unquantized tiny MLA
    (an f32 latent pool: the einsum path in both)."""
    out = {m: compressed_pair(m, torch.float32, jnp.float32, seed=6, lm_scale=4.0)
           for m in ("mha", "mla")}
    tcfg = port_cfg("tiny_mla", torch.float32)
    jb = float_bundle(tcfg, None, jnp.float32, seed=6, lm_scale=4.0)
    out["tiny_mla"] = jb, from_jax_variables(jax.tree.map(np.asarray, jb.variables), tcfg,
                                             device="cpu")
    return out


KW = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1, paged=True,
          page_size=PS, kv_pages=13)


@pytest.mark.parametrize("model", ["mha", "mla", "tiny_mla"])
def test_greedy_tokens_match_reference_paged_engine(f32_models, model):
    """Three staggered requests through both paged engines (13 pages of 8
    rows for two slots of 64: short of the 17 of the worst case): the same
    tokens and stop reasons, the same page ids owned at every tick,
    log-probs within 0.15 (int8 pools: the port decodes through K15's
    twin, the reference's CPU path through f32 einsums) or 1e-4 (the f32
    latent pool)."""
    jb, tb = f32_models[model]
    kv = {} if model == "tiny_mla" else {"kv_dtype": "int8"}
    lp_tol = 1e-4 if model == "tiny_mla" else 0.15
    prompts = _prompts(tb.module.cfg.vocab_size)

    def serve(engine):
        owned = []
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
            owned.append({k: list(v) for k, v in engine.allocator.owned.items()})
        reqs.append(engine.submit(prompts[2], max_new_tokens=6))
        while engine._queue or engine.num_active:
            engine.step()
            owned.append({k: list(v) for k, v in engine.allocator.owned.items()})
        return reqs, owned

    want, jown = serve(JaxEngine(jb, **KW, **{k: jnp.int8 for k in kv}))
    got, town = serve(ServingEngine(tb, device="cpu", **KW, **{k: torch.int8 for k in kv}))
    assert town == jown
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=lp_tol)


@pytest.mark.parametrize("model", ["mha", "mla"])
def test_greedy_tokens_match_interpreted_reference_paged_engine(f32_models, model,
                                                                interpreted_kernels):
    """Seed-5 prompts (where the int8 MLA pool flips a 0.007-gap choice
    against the reference's XLA path) through both paged engines, the JAX
    one decoding through its interpret-mode K15: the same tokens and stop
    reasons; log-probs within 1e-4 on the llama (both prefill by gather +
    einsum and round the same per-page codes) and 0.15 on the MLA model."""
    jb, tb = f32_models[model]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tb.module.cfg.vocab_size, n).tolist() for n in PROMPT_LENS]

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=6))
        engine.run()
        return reqs

    want = serve(JaxEngine(jb, **KW, kv_dtype=jnp.int8))
    got = serve(ServingEngine(tb, device="cpu", **KW, kv_dtype=torch.int8))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs,
                                   atol=1e-4 if model == "mha" else 0.15)


def test_paged_decode_to_cache_end_matches_reference(f32_models, monkeypatch):
    """A request served until its slot reaches ``max_seq_len`` (bursts of 4)
    and one that reuses its slot after, through both paged engines with
    int8 pools: no raise, the same tokens, stop reasons and ``lengths``.
    The writes the port makes show where the cap is met: the slot's last
    burst tick writes position S - 1, and a later tick writes at position S
    through the table's last column (the reference's gather clamps it)."""
    from modelopt_tpu_torch.kernels import paged_attention as tpa

    jb, tb = f32_models["mha"]
    S_ = 32
    kw = dict(KW, max_seq_len=S_, multi_step=4, kv_pages=None)
    seen = []
    real = tt.paged_kv_write_rows

    def spy(pools, rows, page_table, positions):
        seen.append(int(positions.max()))
        return real(pools, rows, page_table, positions)

    monkeypatch.setattr(tt, "paged_kv_write_rows", spy)
    prompts = _prompts(tb.module.cfg.vocab_size)

    def serve(engine):
        r1 = engine.submit(prompts[1], max_new_tokens=100)
        r0 = engine.submit(prompts[0], max_new_tokens=20)
        engine.run()
        lengths = [np.asarray(engine.cache["lengths"]).tolist()]
        r2 = engine.submit(prompts[2], max_new_tokens=5)
        engine.run()
        lengths.append(np.asarray(engine.cache["lengths"]).tolist())
        return [r1, r0, r2], lengths

    want, want_len = serve(JaxEngine(jb, **kw, kv_dtype=jnp.int8))
    got, got_len = serve(ServingEngine(tb, device="cpu", **kw, kv_dtype=torch.int8))
    for w, g in zip(want, got):
        assert g.stop_reason == w.stop_reason and g.out_tokens == w.out_tokens
    assert got_len == want_len
    assert got[0].stop_reason == "length"
    assert len(prompts[1]) + len(got[0].out_tokens) == S_
    assert max(seen) == S_ and tpa.paged_kv_write.launches == 0  # CPU: twins only


# --------------------------------------------------------------------------
# the reference's paged engine cases (tests/unit/serve/test_engine.py)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    """An unquantized f32 tiny llama (head_dim 16: the gather path), as the
    reference's engine tests use."""
    tcfg = tt.tiny_test_config(dtype=torch.float32)
    jb = float_bundle(tcfg, None, jnp.float32, seed=0, lm_scale=4.0)
    return from_jax_variables(jax.tree.map(np.asarray, jb.variables), tcfg, device="cpu")


def naive_greedy(tb, prompt, n):
    """Re-run the whole sequence every step, no cache."""
    toks = list(prompt)
    for _ in range(n):
        logits, _ = tb.apply(torch.tensor([toks], dtype=torch.int32))
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def test_paged_matches_naive(tiny):
    eng = ServingEngine(tiny, max_batch=2, max_seq_len=64, prefill_buckets=(16,), paged=True,
                        page_size=16, device="cpu")
    prompts = [[5, 17, 42, 7], [9, 9, 1, 30]]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for p, r in zip(prompts, reqs):
        assert r.done and r.out_tokens == naive_greedy(tiny, p, 6), p


def test_paged_memory_scales_with_active_tokens(tiny):
    """A pool of 6 pages where the worst case needs 9: short requests fit,
    and every page comes back."""
    eng = ServingEngine(tiny, max_batch=2, max_seq_len=64, prefill_buckets=(16,), paged=True,
                        page_size=16, kv_pages=6, device="cpu")
    r1 = eng.submit([1, 2, 3], max_new_tokens=4)
    r2 = eng.submit([4, 5], max_new_tokens=4)
    eng.run()
    assert r1.done and r2.done
    assert eng.allocator.free_pages == 5
    assert not eng.cache["page_table"].any()


def test_paged_pool_exhaustion_requeues(tiny):
    """3 usable pages of 16: two 33-token prompts need 3 each, so the second
    waits in the queue until the first finishes."""
    rng = np.random.default_rng(1)
    p1 = list(map(int, rng.integers(0, 255, 33)))
    p2 = list(map(int, rng.integers(0, 255, 33)))
    eng = ServingEngine(tiny, max_batch=2, max_seq_len=64, prefill_buckets=(64,), paged=True,
                        page_size=16, kv_pages=4, device="cpu")
    r1 = eng.submit(p1, max_new_tokens=3)
    r2 = eng.submit(p2, max_new_tokens=3)
    eng.step()
    assert eng.num_active == 1 and list(eng._queue) == [r2]
    eng.run()
    assert r1.done and r2.done
    assert r2.out_tokens == naive_greedy(tiny, p2, 3)


def test_paged_chunked_long_prompt(tiny):
    rng = np.random.default_rng(2)
    prompt = list(map(int, rng.integers(0, 255, 40)))
    eng = ServingEngine(tiny, max_batch=2, max_seq_len=64, prefill_buckets=(16,), paged=True,
                        page_size=16, device="cpu")
    req = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    assert req.done and req.out_tokens == naive_greedy(tiny, prompt, 4)


def test_burst_paged(tiny):
    """Bursts of 4 over a paged cache emit the dense engine's single-step
    tokens; pages grow by the burst's lookahead."""
    def run(**kw):
        eng = ServingEngine(tiny, max_batch=2, max_seq_len=64, prefill_buckets=(16,),
                            device="cpu", **kw)
        r1 = eng.submit([5, 9, 2, 7], max_new_tokens=11)
        r2 = eng.submit([4, 4, 8], max_new_tokens=5)
        eng.run()
        return r1, r2, eng

    a1, a2, _ = run()
    b1, b2, eng = run(multi_step=4, paged=True, page_size=16)
    assert a1.out_tokens == b1.out_tokens and a2.out_tokens == b2.out_tokens
    assert eng.stats["decode_forwards"] > eng.stats["tokens_emitted"] / 2


def test_paged_engine_refusals(tiny):
    with pytest.raises(ValueError, match="page_size multiple"):
        ServingEngine(tiny, max_seq_len=64, prefill_buckets=(16,), paged=True, page_size=24,
                      device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(tiny, paged=True, mesh=object(), device="cpu")
