"""The Qwen3-MoE slice on the CPU: a tiny Qwen3-MoE (qk-norm, 8 experts,
top-2) of the JAX package with weights drawn by numpy, compressed by the
reference's own ``compress`` (expert kernels in the folded layout), carried
into the port by ``from_jax_variables``; routing, the MoE block, cached and
uncached logits under W4A8_INT8KV_CFG and INT4_BLOCKWISE_WEIGHT_ONLY_CFG,
and the serving engine held against JAX."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, get_in, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant import qtensor as tq
from modelopt_tpu_torch.quant.api import calibrate, validate_calibration
from modelopt_tpu_torch.quant.config import get_config
from modelopt_tpu_torch.serve import ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tiny_moe_test_config in the reference's terms
TINY = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
            head_dim=128, intermediate_size=512, moe_intermediate_size=256,
            num_experts=4, experts_per_token=2, max_position_embeddings=256)
W4A8, W4A16 = "W4A8_INT8KV_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"
# numpy seed of the cached test's ids: every top-2 router gap above 0.06 and
# every greedy choice at the prefill's end 0.3 above its runner-up
IDS_SEED = 558
B, T, S, STEPS = 2, 8, 32, 2
ROUTER_SCALE = 0.1  # router logits of std ~1.6 on unit-RMS inputs
# The two packages round differently (bf16-rounded dequantized weights and
# fake-quantized activations in the reference's CPU path, the kernels'
# arithmetic in the port), which moves a router logit by ~0.01 here; in a
# trial a top-2 choice 0.006 from a tie flipped and moved a logit row by 1.
# Inputs of the top-2 comparisons keep every k-th / (k+1)-th logit gap above
# this bar; forwards over many tokens route to all experts (k = E) instead.
MIN_ROUTER_GAP = 0.03
ALL = dict(experts_per_token=4)


def jax_cfg(jdtype=jnp.bfloat16, **kw):
    return jt.qwen3_moe_config(dtype=jdtype, **{**TINY, **kw})


def port_cfg(tdtype=torch.bfloat16, **kw):
    return tt.tiny_moe_test_config(dtype=tdtype, **kw)


def float_bundle(preset, jdtype=jnp.bfloat16, seed=0, lm_scale=1.0, **kw):
    """A JAX ModelBundle of f32 weights drawn from numpy, with the preset's
    quantize record: kernels N(0, 1/fin), the router N(0, ROUTER_SCALE^2),
    norm scales 1 + 0.1 N(0, 1), the embedding N(0, 1)."""
    rng = np.random.default_rng(seed)
    module = jt.Decoder(jax_cfg(jdtype, **kw))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel" and "router" in keys:
            arr = rng.standard_normal(leaf.shape) * ROUTER_SCALE
        elif keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
            if "lm_head" in keys:
                arr = arr * lm_scale
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    return ModelBundle(module=module, variables={"params": params}, example_inputs=(ids,),
                       records=(ModeRecord("quantize", jget_config(preset), {}),))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def router_gaps(tb):
    """Record, over every routing of the port model ``tb`` while active, the
    gap between the k-th and (k+1)-th largest router logits."""
    gaps = []
    blocks = [m for m in tb.module.modules() if isinstance(m, tt.MoEBlock)]
    for blk in blocks:
        def route(x, blk=blk, orig=blk.route):
            k = blk.cfg.experts_per_token
            top = torch.topk(blk.router(x), k + 1, dim=-1).values
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
            return orig(x)
        blk.route = route
    try:
        yield gaps
    finally:
        for blk in blocks:
            del blk.route


def with_all_experts(jb):
    """The same variables under a config that routes every token to all
    experts (no top-k choice to flip)."""
    return jb.replace(module=jt.Decoder(jax_cfg(jb.module.cfg.dtype, **ALL)))


def jax_calibrate(jb):
    ids = jnp.asarray(np.random.default_rng(1).integers(1, 512, (B, T)), jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, ids, jt.make_cache(jb.module.cfg, B, S))
    return jb.replace(variables={**jb.variables, "quant": mut["quant"]}), ids


@pytest.fixture(scope="module")
def compressed():
    """Per preset: the reference bundle compressed by the reference's
    ``compress``, calibrated (W4A8: k/v amax) by one JAX forward."""
    out = {}
    for preset in (W4A8, W4A16):
        jb = jcompress(float_bundle(preset))
        if preset == W4A8:
            jb, _ = jax_calibrate(jb)
        out[preset] = jb
    return out


def test_fold_and_pack_match_reference_compress():
    """The port packs an expert kernel [E, in, out] through the folded view
    [in, E*out] bit-for-bit as the reference's compress does; unfolding the
    dequantized weight gives each expert's [in, out] back. Both presets
    leave the router unquantized."""
    jb = float_bundle(W4A8)
    jc = jcompress(jb)
    spec = get_config(W4A8).resolve("layers_0/moe/gate_proj/weight_quantizer")[0]
    assert tq.spec_folds(spec)
    for preset in (W4A8, W4A16):  # the router stays unquantized (_DEFAULT_DISABLED)
        assert get_config(preset).resolve("layers_0/moe/router/weight_quantizer") is None
    for name in ("gate_proj", "up_proj", "down_proj"):
        w = np.array(get_in(jb.variables["params"], ("layers_1", "moe", name, "kernel")))
        want = get_in(jc.variables["quant"], ("layers_1", "moe", name, "qweight"))
        folded = tq.fold_experts(torch.from_numpy(w))
        got, fmt = tq.quantize_qtensor(folded, spec)
        assert fmt == "int4" and folded.shape == (w.shape[1], w.shape[0] * w.shape[2])
        np.testing.assert_array_equal(got["data"].numpy(), np.asarray(want["data"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
        deq = tq.unfold_experts(tq.dequantize_int4(got), w.shape[0])
        jdeq = np.asarray(jq.dequantize_int4(want)).reshape(w.shape[1], w.shape[0], -1)
        np.testing.assert_array_equal(deq.numpy(), jdeq.transpose(1, 0, 2))
        np.testing.assert_array_equal(tq.unfold_experts(folded, w.shape[0]).numpy(), w)


@pytest.mark.parametrize("E,k", [(4, 2), (16, 8)])
def test_moe_block_routing_matches_reference(E, k):
    """One f32 MoE block from the same numpy weights: the router's logits
    (captured from the reference module), the selected expert sets, the
    dense gate matrix (the reference's softmax / top-k / renormalisation
    applied to its own logits) and the block's output agree. The inputs keep
    the k-th and (k+1)-th affinities more than 1e-4 apart on every token, so
    ``torch.topk`` and ``jax.lax.top_k`` cannot order a tie differently.
    f32 throughout: 1e-5 for logits, 1e-6 for gates, 1e-4 for the output."""
    rng = np.random.default_rng(3)
    jcfg = jax_cfg(jnp.float32, num_experts=E, experts_per_token=k)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    blk = jt.MoEBlock(jcfg)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        scale = ROUTER_SCALE if path.startswith("router") else 1 / np.sqrt(leaf.shape[-2])
        params = set_in(params, tuple(path.split("/")),
                        jnp.asarray(rng.standard_normal(leaf.shape) * scale, jnp.float32))
    want, inter = blk.apply({"params": params}, jnp.asarray(x), capture_intermediates=True,
                            mutable=["intermediates"])
    jlogits = np.asarray(inter["intermediates"]["router"]["__call__"][0])
    jscores = jax.nn.softmax(jnp.asarray(jlogits), axis=-1)
    jw, jsel = jax.lax.top_k(jscores, k)
    jw = jw / (jnp.sum(jw, -1, keepdims=True) + 1e-20)
    jgates = np.asarray(jnp.sum(jnp.where(jsel[..., None] == jnp.arange(E), jw[..., None], 0.0),
                                axis=-2))
    jsel = np.asarray(jsel)

    tblk = tt.MoEBlock(port_cfg(torch.float32, num_experts=E, experts_per_token=k),
                       device="cpu")
    for path, leaf in flatten_with_paths(params):
        mod, name = path.rsplit("/", 1)
        getattr(getattr(tblk, mod), name).data.copy_(torch.from_numpy(np.array(leaf)))
    tx = torch.from_numpy(x)
    gates, sel, scores = tblk.route(tx)
    np.testing.assert_allclose(tblk.router(tx).numpy(), jlogits, rtol=1e-5, atol=1e-5)
    srt = np.sort(scores.numpy(), axis=-1)[..., ::-1]
    assert (srt[..., k - 1] - srt[..., k]).min() > 1e-4
    assert (np.sort(sel.numpy(), -1) == np.sort(jsel, -1)).all()
    np.testing.assert_allclose(gates.numpy(), jgates, rtol=0, atol=1e-6)
    assert torch.allclose(gates.sum(-1), torch.ones(2, 5))
    np.testing.assert_allclose(tblk(tx).numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_calibrated_kv_amax_matches(compressed):
    """Calibration runs through the MoE blocks: the port's k/v amax equal
    the reference's within bf16 rounding of the projections; the
    weight-only preset has nothing to calibrate in either package."""
    jb = compressed[W4A8]
    tb = from_jax_variables(to_numpy({k: v for k, v in jb.variables.items()}), port_cfg(),
                            W4A8, device="cpu")
    for i in range(2):  # drop the reference's amax, calibrate the port's own
        for name in ("k_quantizer", "v_quantizer"):
            getattr(getattr(tb.module, f"layers_{i}").attn, name).amax = None
    ids = np.random.default_rng(1).integers(1, 512, (B, T)).astype(np.int32)
    calibrate(tb, "max", lambda f: f(torch.from_numpy(ids),
                                     tt.make_cache(port_cfg(), B, S, device="cpu")))
    assert validate_calibration(tb) == []
    for i in range(2):
        for name in ("k_quantizer", "v_quantizer"):
            want = float(jb.variables["quant"][f"layers_{i}"]["attn"][name]["amax"])
            got = float(getattr(getattr(tb.module, f"layers_{i}").attn, name).amax)
            assert got == pytest.approx(want, rel=2e-2), (i, name)
    tc = from_jax_variables(to_numpy(compressed[W4A16].variables), port_cfg(), W4A16,
                            device="cpu")
    calibrate(tc, "max", lambda f: f(torch.from_numpy(ids),
                                     tt.make_cache(port_cfg(), B, S, device="cpu")))
    assert validate_calibration(tc) == []
    assert all(getattr(m, "amax", None) is None for m in tc.module.modules())
    assert not any(p.endswith("amax") for p, _ in flatten_with_paths(
        compressed[W4A16].variables["quant"]))


@pytest.mark.parametrize("preset,kv", [(W4A8, "int8"), (W4A8, "bf16"), (W4A16, "bf16")])
def test_cached_logits_match(preset, kv, compressed):
    """Prefill then cached decode, teacher-forced, both packages from the
    same compressed variables. On the CPU the reference multiplies
    dequantized bf16 weights (and fake-quantized activations under W4A8),
    the port runs the kernels' arithmetic through their plain twins (exact
    int8 products for K1/K12, f32 block sums for K6/K10, bf16 attention
    operands). Held at 5% of the logit range (bf16 model), greedy choices
    at the prefill's last position agree; no top-2 choice on these inputs
    is within MIN_ROUTER_GAP of a tie."""
    jb = compressed[preset]
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    ids = np.random.default_rng(IDS_SEED).integers(1, 512, (B, T + STEPS)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    cache = jt.make_cache(jb.module.cfg, B, S, dtype=jdt)
    lj, cache = fn(jb.variables, jnp.asarray(ids[:, :T]), cache)
    want = [np.asarray(lj[:, -1], np.float32)]
    for t in range(STEPS):
        lj, cache = fn(jb.variables, jnp.asarray(ids[:, T + t:T + t + 1]), cache)
        want.append(np.asarray(lj[:, -1], np.float32))
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(), preset, device="cpu")
    tcache = tt.make_cache(port_cfg(), B, S, dtype=tdt, device="cpu")
    with router_gaps(tb) as gaps:
        lt, tcache = tb.apply(torch.from_numpy(ids[:, :T]), tcache)
        got = [lt[:, -1].float().numpy()]
        for t in range(STEPS):
            lt, tcache = tb.apply(torch.from_numpy(ids[:, T + t:T + t + 1]), tcache)
            got.append(lt[:, -1].float().numpy())
    assert min(gaps) > MIN_ROUTER_GAP
    want, got = np.stack(want), np.stack(got)
    assert int(tcache["lengths"][0]) == T + STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


@pytest.mark.parametrize("preset", [W4A8, W4A16])
def test_uncached_forward_matches_above_256_rows(preset, compressed):
    """A 272-token forward (M > 256), every token routed to all 8 experts:
    gate / up take the prefill forms of K1 / K6, the down-projection the
    dequantize + bmm steps the reference leaves to XLA, then the combine
    einsum."""
    jb = with_all_experts(compressed[preset])
    ids = np.random.default_rng(4).integers(1, 512, (1, 272)).astype(np.int32)
    lj, _ = jax.jit(jb.make_fn())(jb.variables, jnp.asarray(ids))
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(**ALL), preset, device="cpu")
    lt, _ = tb.apply(torch.from_numpy(ids))
    want = np.asarray(lj, np.float32)
    np.testing.assert_allclose(lt.float().numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_unported_routing_variants_raise():
    """Routing variants still unported raise; shared experts (DeepSeek) are
    ported now (test_torch_mla.py) and build."""
    assert port_cfg(n_shared_experts=1).n_shared_experts == 1
    for kw in (dict(router_score="sigmoid"), dict(n_group=4),
               dict(moe_activation="swiglu_oai"), dict(moe_bias=True),
               dict(router_correction_bias=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_cfg(**kw)


# --------------------------------------------------------------------------
# serving: the tiny MoE in both engines, f32 model dtype and cache, every
# token routed to all experts (generated tokens are not chosen in advance)
# --------------------------------------------------------------------------
# Greedy parity needs no near-ties: the port's attention kernels take bf16
# operands where the reference's CPU path runs f32 einsums. These prompts
# (drawn from numpy seed 5) keep every greedy choice of the tokens the tests
# generate at least 0.3 above its runner-up under both presets; the second
# streams in chunks of 16 + 4.
PROMPTS = [[313, 431, 471, 249, 52],
           [152, 60, 261, 186, 483, 344, 255, 419, 397, 391, 339, 1, 2, 174, 307, 250,
            328, 417, 367, 289],
           [250, 24, 33]]


@pytest.fixture(scope="module")
def engine_bundles():
    """Per preset, the reference bundle (W4A8: k/v amax calibrated, which
    fake-quantize K/V into the f32 cache) and the port's copy of it."""
    out = {}
    for preset in (W4A8, W4A16):
        jb = jcompress(float_bundle(preset, jnp.float32, seed=6, lm_scale=4.0, **ALL))
        if preset == W4A8:
            jb, _ = jax_calibrate(jb)
        tb = from_jax_variables(to_numpy(jb.variables), port_cfg(torch.float32, **ALL),
                                preset, device="cpu")
        out[preset] = jb, tb
    return out


@pytest.mark.parametrize("preset", [W4A8, W4A16])
def test_greedy_tokens_match_reference_engine(engine_bundles, preset):
    """Three staggered requests (one arrives after two ticks), model-dtype
    KV cache: the same tokens, stop reasons and log-probs within 0.15 (the
    attention operands' bf16 rounding in the port)."""
    jb, tb = engine_bundles[preset]
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(PROMPTS[2], max_new_tokens=6))  # late arrival
        engine.run()
        return reqs

    want = serve(JaxEngine(jb, **kw))
    got = serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.15)


def test_decode_to_cache_end_matches_reference(engine_bundles, monkeypatch):
    """A request served until its slot reaches ``max_seq_len`` (burst decode,
    multi_step 4): both engines stop it for length with the same tokens and
    leave the same per-slot ``lengths``, and a request that reuses the slot
    matches too. The decode writes seen by the cache's writer show where
    the cache end is met: an active slot's last burst tick writes row S-1
    and leaves lengths == S, so the retired slot's next (idle) tick writes at
    pos S, which kernel and twin clamp to S-1 like the reference's
    ``dynamic_update_slice``; that row is dead until a new request
    overwrites it. The writer is K2 where ``fused_decode_ok`` admits the
    step, else K3 (this f32 cache: K2's CUDA kernel takes int8, e4m3 and
    bf16 caches, so the gate sends the step to K3 and the einsum)."""
    jb, tb = engine_bundles[W4A8]
    S_ = 32
    kw = dict(max_batch=2, max_seq_len=S_, prefill_buckets=(8, 16), max_admit=1,
              multi_step=4)
    seen = []
    real, real_write = tt.fused_decode_attention, tt.dense_kv_write_pair

    def spy(q, k, v, kc, vc, pos, *a, **k2):
        seen.append(pos.clone())
        return real(q, k, v, kc, vc, pos, *a, **k2)

    def spy_write(k_cache, v_cache, k_vals, v_vals, start):
        if k_vals.shape[1] == 1:
            seen.append(start.clone())
        return real_write(k_cache, v_cache, k_vals, v_vals, start)

    monkeypatch.setattr(tt, "fused_decode_attention", spy)
    monkeypatch.setattr(tt, "dense_kv_write_pair", spy_write)

    def serve(engine):
        r1 = engine.submit(PROMPTS[1], max_new_tokens=100)
        r0 = engine.submit(PROMPTS[0], max_new_tokens=20)
        engine.run()
        lengths = [np.asarray(engine.cache["lengths"]).tolist()]
        r2 = engine.submit(PROMPTS[2], max_new_tokens=5)
        engine.run()
        lengths.append(np.asarray(engine.cache["lengths"]).tolist())
        return [r1, r0, r2], lengths

    want, want_len = serve(JaxEngine(jb, **kw))
    got, got_len = serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.stop_reason == w.stop_reason and g.out_tokens == w.out_tokens
    assert got_len == want_len
    assert got[0].stop_reason == "length"
    assert len(PROMPTS[1]) + len(got[0].out_tokens) == S_
    pos = torch.stack(seen)
    assert int(pos.max()) == S_  # an idle tick at pos S: clamped to S-1


@pytest.mark.parametrize("form", ["dense", "compressed"])
def test_quant_einsum_other_contractions_match_reference(form):
    """A QuantEinsum contraction other than the two MoE ones
    (``btd,hdk->bthk``, kernel [H, d, k]) in f32: a plain einsum of the
    dense kernel and, compressed under INT4_BLOCKWISE_WEIGHT_ONLY_CFG, the
    folded packed weight dequantized, unfolded and contracted. Both packages
    run the same f32 steps: 1e-5 of the output scale."""
    from modelopt_tpu.nn import layers as jl
    from modelopt_tpu.nn.quantizer import quantization_active as jactive
    from modelopt_tpu_torch.nn.layers import QuantEinsum
    from modelopt_tpu_torch.nn.quantizer import assign_paths, quantization_active

    rng = np.random.default_rng(11)
    spec_str, shape = "btd,hdk->bthk", (2, 256, 128)
    w = (rng.standard_normal(shape) / 16).astype(np.float32)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jmod = jl.QuantEinsum(einsum_str=spec_str, kernel_shape=shape, dtype=jnp.float32)
    tmod = QuantEinsum(spec_str, shape, dtype=torch.float32, device="cpu")
    assign_paths(tmod)  # its quantizers resolve as "weight_quantizer", as in JAX
    cfg = W4A16 if form == "compressed" else None
    if form == "compressed":
        spec = jget_config(W4A16).resolve("/weight_quantizer")[0]
        qt, _ = jq.quantize_qtensor(jnp.asarray(w).transpose(1, 0, 2).reshape(256, 256), spec)
        variables = {"quant": {"qweight": qt}}
        tmod.set_qweight({k: torch.from_numpy(np.array(v)) for k, v in qt.items()})
    else:
        variables = {"params": {"kernel": jnp.asarray(w)}}
        tmod.kernel.data.copy_(torch.from_numpy(w))
    jctx = jactive(jget_config(cfg)) if cfg else contextlib.nullcontext()
    tctx = quantization_active(get_config(cfg)) if cfg else contextlib.nullcontext()
    with jctx:
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with tctx:
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 2, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
