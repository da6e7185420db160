"""The DeepSeek-V2 slice on the CPU: multi-head latent attention with an
int8 latent cache, yarn RoPE, shared experts, the padded int4 fake-quant of
a kernel too ragged to pack, and the serving engine, each held against the
JAX package. Reference models are built from numpy weights, compressed by
the reference's own ``compress`` and carried into the port by
``from_jax_variables``."""

import contextlib
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
from modelopt_tpu.quant.fake_quant import fake_quantize as jfake_quantize
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.models import mla as tm
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant.api import calibrate, validate_calibration
from modelopt_tpu_torch.quant.fake_quant import fake_quantize as tfake_quantize
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec
from modelopt_tpu_torch.serve import ServingEngine
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
B, T, S, STEPS = 2, 8, 32, 3
# numpy seed of the cached test's ids: on these inputs every top-2 router
# choice of the port is at least 0.1 in router logits from a tie
IDS_SEED = 3
# the two packages round differently (see test_torch_moe.py); a top-2
# choice closer than this to a tie could flip between them
MIN_ROUTER_GAP = 0.03


def port_cfg(tdtype=torch.bfloat16, **kw):
    return tt.small_mla_compressed_config(dtype=tdtype, **kw)


def jax_cfg(tcfg, jdtype):
    """The reference's DecoderConfig with the port config's fields."""
    names = [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]
    return jt.DecoderConfig(dtype=jdtype, **{n: getattr(tcfg, n) for n in names})


def float_bundle(tcfg, preset, jdtype=jnp.bfloat16, seed=0, lm_scale=1.0):
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
    """One calibration forward of the reference (k_quantizer amax of every
    latent row), through a model-dtype cache as the port calibrates."""
    ids = jnp.asarray(np.random.default_rng(1).integers(1, jb.module.cfg.vocab_size, (B, T)),
                      jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, ids, jt.make_cache(jb.module.cfg, B, S))
    return jb.replace(variables={**jb.variables, "quant": mut["quant"]})


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def router_gaps(tb):
    """The smallest gap between the k-th and (k+1)-th router logits over
    every routing of the port model ``tb`` while active."""
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


@pytest.fixture(scope="module")
def compressed():
    """The small compressed MLA config under W4A8_INT8KV_CFG: the
    reference bundle compressed by the reference's ``compress`` and
    calibrated by one JAX forward, and the port's copy of it."""
    tcfg = port_cfg()
    jb = jax_calibrate(jcompress(float_bundle(tcfg, W4A8)))
    return jb, from_jax_variables(to_numpy(jb.variables), tcfg, W4A8, device="cpu")


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------
YARN_V2_LITE = tt.deepseek_v2_lite_config().rope_scaling
YARN_FACTOR = (("rope_type", "yarn"), ("factor", 8.0),
               ("original_max_position_embeddings", 256))


@pytest.mark.parametrize("scaling", [None, YARN_V2_LITE, YARN_FACTOR])
@pytest.mark.parametrize("d", [64, 128])
def test_rope_matches_reference(rng, scaling, d):
    """RoPE on the same f32 inputs at positions up to 4000: the inverse
    frequencies are the reference's float64 formula rounded to f32, bit for
    bit; the rotated values agree to the f32 cos/sin of two libraries
    (2e-5 at |angle| <= 4000). YARN_FACTOR has no mscale pair, so its
    cos/sin carry an attention factor of 1.208; V2-Lite's pair cancels to
    1."""
    x = rng.standard_normal((2, 5, 3, d)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [100, 517, 1000, 2500, 4000]], np.int32)
    want = np.asarray(jt._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, scaling))
    got = tt._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    if scaling is not None:
        jinv, jfac = jt._yarn_inv_freq(d, 10000.0, dict(scaling))
        tinv, tfac = tt._yarn_inv_freq(d, 10000.0, dict(scaling))
        np.testing.assert_array_equal(tinv, jinv)
        assert tfac == jfac
        assert (tfac == 1.0) == (scaling is YARN_V2_LITE)


@pytest.mark.parametrize("shape,block", [((320, 256), {-2: 128}), ((10944 // 16, 24), {-2: 128}),
                                         ((200, 96), {-2: 64, -1: 32})])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_padded_int4_fake_quant_bit_exact(rng, shape, block, dtype):
    """Dynamic int4 block fake-quant of a kernel whose blocked dims the block
    does not divide (K=320, 684; 200 by 64): the reference zero-pads the
    block and cuts the padding away after rounding; the same f32 steps give
    the same bits."""
    w = rng.standard_normal(shape).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want = np.asarray(jfake_quantize(jw, JSpec(num_bits=4, block=block)).astype(jnp.float32))
    got = tfake_quantize(tw, TSpec(num_bits=4, block=block)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_shared_experts_match_moe_block(rng):
    """An f32 DeepSeek MoE block (4 experts, top-2 without renormalisation,
    2 shared experts of width 2 x 64) from the same numpy weights: the
    routed combine plus the shared MLP agree with the reference's MoEBlock
    (1e-4, as the routed-only block in test_torch_moe.py)."""
    tcfg = tt.tiny_mla_test_config(dtype=torch.float32, n_shared_experts=2,
                                   norm_topk_prob=False)
    jblk = jt.MoEBlock(jax_cfg(tcfg, jnp.float32))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert "shared_experts" in shapes
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        scale = 0.1 if path.startswith("router") else 1 / np.sqrt(leaf.shape[-2])
        params = set_in(params, tuple(path.split("/")),
                        jnp.asarray(rng.standard_normal(leaf.shape) * scale, jnp.float32))
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    tblk = tt.MoEBlock(tcfg, device="cpu")
    assert tblk.shared_experts.down_proj.in_features == 128
    for path, leaf in flatten_with_paths(params):
        mod = tblk
        *mods, name = path.split("/")
        for m in mods:
            mod = getattr(mod, m)
        getattr(mod, name).data.copy_(torch.from_numpy(np.array(leaf)))
    np.testing.assert_allclose(tblk(torch.from_numpy(x)).numpy(), want, rtol=1e-4, atol=1e-5)


def test_from_jax_variables_takes_every_mla_leaf():
    """tiny_mla_test_config (low-rank q: q_a_proj, q_a_norm, q_b_proj; the
    absorbed kv_b_proj kernel; shared experts; a dense first layer): every
    reference leaf finds its place in the port, and each parameter of the
    port is filled. A leaf the port cannot place raises."""
    tcfg = tt.tiny_mla_test_config(dtype=torch.float32)
    jb = float_bundle(tcfg, None, jnp.float32)
    variables = to_numpy(jb.variables)
    tb = from_jax_variables(variables, tcfg, device="cpu")
    attn = tb.module.layers_1.attn
    np.testing.assert_array_equal(attn.kv_b_proj.kernel.numpy(),
                                  variables["params"]["layers_1"]["attn"]["kv_b_proj"]["kernel"])
    np.testing.assert_array_equal(attn.q_a_norm.scale.numpy(),
                                  variables["params"]["layers_1"]["attn"]["q_a_norm"]["scale"])
    n_leaves = len(list(flatten_with_paths(variables["params"])))
    assert n_leaves == sum(1 for _ in tb.module.parameters())
    extra = {**variables, "params": {**variables["params"], "stray": {"kernel": np.zeros(2)}}}
    with pytest.raises(ValueError, match="cannot place"):
        from_jax_variables(extra, tcfg, device="cpu")


def test_make_cache_latent_rows():
    """MLA caches hold one latent row per token padded to whole 128-lane
    tiles ([B, S, pad128(r + dr)]: 192 -> 256 here, 576 -> 640 for V2-Lite)
    and an empty v placeholder."""
    c = tt.make_cache(port_cfg(), 3, 16, dtype=torch.int8, device="cpu")
    assert c["k"][0].shape == (3, 16, 256) and c["v"][1].shape == (3, 16, 0)
    c = tt.make_cache(tt.deepseek_v2_lite_config(), 1, 4, device="meta")
    assert c["k"][26].shape == (1, 4, 640) and len(c["v"]) == 27


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_calibrated_latent_amax_matches(compressed):
    """One calibration forward sets each layer's latent k_quantizer amax;
    the port's equals the reference's within the bf16 rounding of the
    projections that make the latent row."""
    jb, tb = compressed
    for i in range(2):
        tb.module.get_submodule(f"layers_{i}.attn.k_quantizer").amax = None
    ids = np.random.default_rng(1).integers(1, 512, (B, T)).astype(np.int32)
    calibrate(tb, "max", lambda f: f(torch.from_numpy(ids),
                                     tt.make_cache(port_cfg(), B, S, device="cpu")))
    assert validate_calibration(tb) == []
    for i in range(2):
        want = float(jb.variables["quant"][f"layers_{i}"]["attn"]["k_quantizer"]["amax"])
        got = float(tb.module.get_submodule(f"layers_{i}.attn.k_quantizer").amax)
        assert got == pytest.approx(want, rel=2e-2), i


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_cached_logits_match(compressed, kv):
    """Prefill then teacher-forced decode of the small compressed MLA model
    (straddle experts through K12's twin, the ragged dense down projection
    fake-quantized, shared experts, yarn). The reference's CPU path attends
    with einsums over the dequantized latent cache; the port decodes an
    int8 cache through K5's twin (q and probabilities requantized to 8 and
    7 bits) and a bf16 cache through the same einsums. Held at the int8-KV
    attention bar, 4e-2 of the logit range (ROADMAP Queue 3), greedy choices
    at the prefill's end agree, and no top-2 router choice is within
    MIN_ROUTER_GAP of a tie."""
    jb, tb = compressed
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    ids = np.random.default_rng(IDS_SEED).integers(1, 512, (B, T + STEPS)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    cache = jt.make_cache(jb.module.cfg, B, S, dtype=jdt)
    lj, cache = fn(jb.variables, jnp.asarray(ids[:, :T]), cache)
    want = [np.asarray(lj[:, -1], np.float32)]
    for t in range(STEPS):
        lj, cache = fn(jb.variables, jnp.asarray(ids[:, T + t:T + t + 1]), cache)
        want.append(np.asarray(lj[:, -1], np.float32))
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
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


def test_decode_dispatch(compressed, monkeypatch):
    """A decode step over an int8 latent cache runs K5 (KH=1, G=heads,
    D=256 padded lanes, the latent tensor as K and V, lengths = position
    + 1); prefill and a bf16-cache decode take the einsum path. Every
    forward writes its latent rows through K3, never the zero-width v."""
    jb, tb = compressed
    k5, k3 = [], []
    real5, real3 = tm.decode_attention, tm.dense_kv_write

    def spy5(q, kc, vc, lengths, **kw):
        k5.append((tuple(q.shape), kc is vc, lengths.tolist()))
        return real5(q, kc, vc, lengths, **kw)

    def spy3(cache, vals, start):
        k3.append(tuple(cache.shape))
        return real3(cache, vals, start)

    monkeypatch.setattr(tm, "decode_attention", spy5)
    monkeypatch.setattr(tm, "dense_kv_write", spy3)
    ids = torch.ones(B, 5, dtype=torch.int32)
    for kv in (torch.int8, torch.bfloat16):
        cache = tt.make_cache(port_cfg(), B, S, dtype=kv, device="cpu")
        _, cache = tb.apply(ids[:, :4], cache)
        _, cache = tb.apply(ids[:, 4:], cache)
    assert k5 == [((B, 1, 2, 256), True, [5, 5])] * 2  # two layers, int8 decode only
    assert len(k3) == 8 and all(shape[-1] == 256 for shape in k3)


def test_uncalibrated_int8_latent_cache_raises(compressed):
    _, tb = compressed
    mod = tb.module.get_submodule("layers_0.attn.k_quantizer")
    amax, mod.amax = mod.amax, None
    try:
        cache = tt.make_cache(port_cfg(), 1, S, dtype=torch.int8, device="cpu")
        with pytest.raises(ValueError, match="(?i)calibrated"):
            tb.apply(torch.ones(1, 4, dtype=torch.int32), cache)
    finally:
        mod.amax = amax


# --------------------------------------------------------------------------
# serving: both engines, f32 model dtype
# --------------------------------------------------------------------------
# numpy seed 5; the second prompt streams in chunks of 16 + 4, the third
# arrives after two ticks. Every greedy choice of the port's engine on
# these prompts is at least 0.02 (tiny, f32 cache: the packages agree to
# 1e-5) and 0.06 (compressed, int8 latent cache) above its runner-up.
PROMPT_LENS = (5, 20, 3)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("model", ["tiny_mla", "compressed_int8", "compressed_int8_interpreted"])
def test_greedy_tokens_match_reference_engine(model, request):
    """Three staggered requests on ``tiny_mla_test_config`` (unquantized, an
    f32 latent cache: the einsum path in both) and on the small compressed
    config under W4A8_INT8KV_CFG (every token routed to all 4 experts, so
    no top-k choice can flip; an int8 latent cache: the reference's CPU
    einsum path against the port's K5 twin, and again with the reference
    decoding through its interpret-mode K5, ``interpreted_kernels``): the
    same tokens and stop reasons, log-probs within 1e-4 (f32 paths) and
    0.15 (int8 attention rounding, as in test_torch_moe.py)."""
    if model.endswith("_interpreted"):
        request.getfixturevalue("interpreted_kernels")
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)
    if model == "tiny_mla":
        tcfg = tt.tiny_mla_test_config(dtype=torch.float32)
        jb = float_bundle(tcfg, None, jnp.float32, seed=6, lm_scale=4.0)
        tb = from_jax_variables(to_numpy(jb.variables), tcfg, device="cpu")
        jkw, tkw, lp_tol = {}, {}, 1e-4
    else:
        tcfg = port_cfg(torch.float32, experts_per_token=4)
        jb = jax_calibrate(jcompress(float_bundle(tcfg, W4A8, jnp.float32, seed=6,
                                                  lm_scale=4.0)))
        tb = from_jax_variables(to_numpy(jb.variables), tcfg, W4A8, device="cpu")
        jkw, tkw, lp_tol = {"kv_dtype": jnp.int8}, {"kv_dtype": torch.int8}, 0.15
    prompts = _prompts(tcfg.vocab_size)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=6))
        engine.run()
        return reqs

    want = serve(JaxEngine(jb, **kw, **jkw))
    got = serve(ServingEngine(tb, device="cpu", **kw, **tkw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=lp_tol)
