"""Post-training quantization in the port against the JAX package: input
capture, the presets' own calibration algorithms (SmoothQuant, AWQ lite,
AWQ clip), ``compress`` and serving the result, on tiny llamas (f32 model
dtype) whose numpy-drawn weights reach both packages through
``from_jax_variables``; each reference is computed once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modelopt_tpu.quant as mtq
from modelopt_tpu.core.bundle import ModelBundle, apply_mode
from modelopt_tpu.core.tree import flatten_with_paths, get_in, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.algorithms import capture as jcap
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.core.bundle import ModelBundle as TBundle
from modelopt_tpu_torch.core.bundle import apply_mode as tapply_mode
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant import api as tapi
from modelopt_tpu_torch.quant.algorithms import capture as tcap
from modelopt_tpu_torch.quant.compress import compress as tcompress
from modelopt_tpu_torch.serve import ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: torch's intra-op thread pool costs more than it saves,
    and the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# whole int4 blocks (K % 128 == 0) for the AWQ presets; one layer keeps the
# reference's per-group compiles few
WIDE = dict(hidden_size=128, intermediate_size=128, num_layers=1)
# preset -> fused projections (SmoothQuant unfused: q / k / v and gate / up
# share one scale a group; the AWQ presets fused, as the served paths)
PRESETS = {"INT8_KV_CFG": False, "W4A8_INT8KV_CFG": True, "INT4_AWQ_FULL_CFG": True}
# tiny_moe_test_config in the reference's terms, one layer
TINY_MOE = dict(vocab_size=512, hidden_size=128, num_layers=1, num_heads=2, num_kv_heads=1,
                head_dim=128, intermediate_size=256, moe_intermediate_size=128,
                num_experts=4, experts_per_token=2, max_position_embeddings=256)
CALIB = np.random.default_rng(1).integers(1, 256, (2, 16)).astype(np.int32)
PROBE = np.random.default_rng(2).integers(1, 256, (2, 12)).astype(np.int32)


def jax_bundle(seed=0, heavy=False, cfg_fn=jt.tiny_test_config, **overrides):
    """An unquantized JAX bundle (f32) with numpy-drawn weights: kernels
    N(0, 1/in), norm scales 1 + N(0, 0.01) (``heavy``: channels 0-3 of every
    norm before a projection at 30, the channel outliers SmoothQuant moves),
    a wide lm_head (x4) against near-tie greedy choices, the rest N(0, 1)."""
    rng = np.random.default_rng(seed)
    cfg = cfg_fn(dtype=jnp.float32, **overrides)
    module = jt.Decoder(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
            arr = arr * 4.0 if keys[0] == "lm_head" else arr
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
            if heavy and keys[-2] in ("input_norm", "post_attn_norm"):
                arr[:4] = 30.0
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    return ModelBundle(module=module, variables={"params": params}, example_inputs=(ids,))


def port_bundle(jb, cfg_fn=tt.tiny_test_config, **overrides) -> TBundle:
    """The port's copy of an unquantized JAX bundle (no mode applied)."""
    tb = from_jax_variables(jax.tree.map(np.asarray, jb.variables),
                            cfg_fn(dtype=torch.float32, **overrides), device="cpu")
    return TBundle(module=tb.module)


def jlogits(jb, ids=PROBE):
    return np.asarray(jax.jit(jb.make_fn())(jb.variables, jnp.asarray(ids))[0])


def tlogits(tb, ids=PROBE):
    return tb.apply(torch.from_numpy(ids))[0].numpy()


def port_state(tb, name):
    """{quantizer path: buffer} of every quantizer holding ``name``."""
    return {m.path: getattr(m, name).numpy() for m in tb.module.modules()
            if getattr(m, name, None) is not None and m.path.endswith("quantizer")}


def ref_state(variables, name):
    return {p.rsplit("/", 1)[0]: np.asarray(v) for p, v in
            flatten_with_paths(variables.get("quant", {})) if p.endswith("/" + name)}


@pytest.fixture(scope="module")
def ptq():
    """Per preset, once: the reference quantized (its fake-quant logits;
    INT8_KV_CFG also compressed by the reference, with compressed logits)
    and the port's run of the same preset from the same weights (quantized
    state, fake-quant logits, then compressed, and its compressed logits)."""
    out = {}

    def get(preset):
        if preset in out:
            return out[preset]
        fused = PRESETS[preset]
        kw = dict(WIDE, fused_qkv=fused, fused_gate_up=fused)
        jb = jax_bundle(**kw)
        jqb = mtq.quantize(jb, preset, lambda f: f(jnp.asarray(CALIB)))
        r = {"jq": jqb, "jq_logits": jlogits(jqb)}
        if preset == "INT8_KV_CFG":
            r["jc"] = jcompress(jqb)
            r["jc_logits"] = jlogits(r["jc"])
        tb = tapi.quantize(port_bundle(jb, **kw), preset,
                           lambda f: f(torch.from_numpy(CALIB)))
        r["kw"] = kw
        r["tq_kernels"] = {m.path: m.kernel.clone().numpy() for m in tb.module.modules()
                           if getattr(m, "kernel", None) is not None}
        r["tq_logits"] = tlogits(tb)
        r["tq_meta"] = dict(tb.metadata)
        r["tc"] = tcompress(tb)
        r["tc_logits"] = tlogits(r["tc"])
        out[preset] = r
        return r

    return get


# --------------------------------------------------------------------------
# capture
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_capture_matches_reference(fused):
    """``capture_inputs``, ``quant_linears`` and ``fused_groups`` on
    tiny_test_config under INT8_DEFAULT_CFG (no calibration): the same
    captured layers with the same rows (3 batches of 2 x 16 tokens
    subsampled to 40: stride 2, the first 40; f32, to 1e-5 of each
    tensor's largest value: the layers before sum in another order), the
    same quantized linears, folded kernels and groups."""
    kw = dict(fused_qkv=fused, fused_gate_up=fused)
    batches = [np.random.default_rng(s).integers(1, 256, (2, 16)).astype(np.int32)
               for s in range(3)]
    jb = apply_mode(jax_bundle(**kw), "quantize", "INT8_DEFAULT_CFG")
    jcapd = jcap.capture_inputs(jb, lambda f: [f(jnp.asarray(b)) for b in batches],
                                max_tokens=40)
    tb = tapply_mode(port_bundle(jb, **kw), "quantize", "INT8_DEFAULT_CFG")
    tcapd = tcap.capture_inputs(tb, lambda f: [f(torch.from_numpy(b)) for b in batches],
                                max_tokens=40)
    assert list(tcapd) == list(jcapd)
    for p, x in jcapd.items():
        x = np.asarray(x)
        assert tcapd[p].shape == x.shape == (40, x.shape[1])
        np.testing.assert_allclose(tcapd[p].numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max())
    jinfos, tinfos = jcap.quant_linears(jb, jcapd), tcap.quant_linears(tb, tcapd)
    assert [i.dense_path for i in tinfos] == [i.dense_path for i in jinfos]
    for ji, ti in zip(jinfos, tinfos):
        np.testing.assert_array_equal(ti.kernel.numpy(), np.asarray(ji.kernel))
        for ts, js in ((ti.wspec, ji.wspec), (ti.aspec, ji.aspec)):
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    groups = [[i.dense_path for i in g] for g in tcap.fused_groups(tinfos)]
    assert groups == [[i.dense_path for i in g] for g in jcap.fused_groups(jinfos)]
    assert any(len(g) > 1 for g in groups) != fused


# --------------------------------------------------------------------------
# the presets' algorithms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("preset", list(PRESETS))
def test_calibrated_state_matches_reference(preset, ptq):
    """The port's own algorithm from the reference's weights: the same
    pre-quant scales (rtol 1e-5: the same f32 pow and clip, another pow
    routine), kernels (rtol 1e-5 of each kernel's largest value: the scale
    folded in, AWQ clip's clipped weights) and calibrated amax (per-channel
    weight amax and per-tensor activation / KV amax, rtol 1e-4: the
    layers before sum in another order)."""
    r = ptq(preset)
    jv = r["jq"].variables
    for name in ("pre_quant_scale", "amax"):  # INT4_AWQ_FULL_CFG holds no amax
        want = ref_state(jv, name)
        got = port_state(r["tc"], name)
        assert sorted(got) == sorted(want), name
        for p in want:
            np.testing.assert_allclose(got[p].reshape(want[p].shape), want[p],
                                       rtol=1e-5 if name == "pre_quant_scale" else 1e-4,
                                       err_msg=p)
    # a pre-quant scale on every projection's input (4 fused, 7 unfused)
    assert len(ref_state(jv, "pre_quant_scale")) == (4 if PRESETS[preset] else 7)
    for p, w in r["tq_kernels"].items():
        want = np.asarray(get_in(jv["params"], tuple(p.split("/")) + ("kernel",)))
        np.testing.assert_allclose(w, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=p)
    if preset != "INT8_KV_CFG":  # one exponent and 11 losses a group
        groups = r["tq_meta"]["awq_lite"]
        assert len(groups) == 4 and all(len(g["losses"]) == 11 for g in groups.values())


@pytest.mark.parametrize("preset", list(PRESETS))
def test_compressed_weights_match_reference(preset, ptq):
    """``compress`` packs every projection (the lm_head stays dense) and
    drops its kernel; its codes are the reference's packing of the
    reference's calibrated kernels (at most 0.1% of codes one step off,
    where the f32 kernels differ in their last bits at a rounding tie),
    scales to rtol 1e-5."""
    r = ptq(preset)
    tc, jv = r["tc"], r["jq"].variables
    packed = tc.records[-1].metadata["compressed"]
    assert packed == [p for p in r["tq_kernels"] if not p.startswith("lm_head")]
    mods = {m.path: m for m in tc.module.modules()}
    for p in packed:
        assert mods[p].kernel is None and mods[p].compressed
        kernel = get_in(jv["params"], tuple(p.split("/")) + ("kernel",))
        spec = r["jq"].records[-1].config.resolve(p + "/weight_quantizer")[0]
        want = jax.jit(lambda k: jq.quantize_qtensor(k, spec)[0])(kernel)
        got = mods[p].qweight
        for k in ("data", "scale"):
            g, w = got[k].numpy(), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (p, k)
            if k == "scale":
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=p)
            else:
                gq = jq.unpack_int4(jnp.asarray(g)) if g.dtype == np.uint8 else g
                wq = jq.unpack_int4(jnp.asarray(w)) if w.dtype == np.uint8 else w
                diff = np.abs(np.asarray(gq, np.int32) - np.asarray(wq, np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, p
    if "jc" in r:  # the reference's own compress: the same layers packed
        assert sorted(ref_state(r["jc"].variables, "data")) == sorted(
            p + "/qweight" for p in packed)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_logits_match_reference(preset, ptq):
    """Fake-quant logits (QUANT phase) against the reference's, and the
    compressed model's against the reference's compressed model
    (INT8_KV_CFG) or fake-quant logits (the reference's compressed CPU
    path dequantizes, so its compressed and fake-quant logits agree to
    f32 rounding). Held at 2% of the largest logit: one int8 activation or
    per-token code rounding the other way moves a logit by a code step;
    the argmax agrees at 98% of positions or more."""
    r = ptq(preset)
    want_c = r.get("jc_logits", r["jq_logits"])
    for got, want in ((r["tq_logits"], r["jq_logits"]), (r["tc_logits"], want_c)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_compress_moe_matches_reference():
    """tiny_moe_test_config (one layer, hidden and widths 128) under
    W4A8_INT8KV_CFG (mode applied, no calibration): the port packs the expert kernels [E, in, out] through the
    folded [in, E*out] view as the reference does, bit for bit, and the
    dense projections likewise; the router stays dense."""
    jb = jax_bundle(cfg_fn=lambda **kw: jt.qwen3_moe_config(**{**TINY_MOE, **kw}))
    jc = jcompress(apply_mode(jb, "quantize", "W4A8_INT8KV_CFG"))
    tb = tapply_mode(port_bundle(jb, cfg_fn=tt.tiny_moe_test_config, **TINY_MOE),
                     "quantize", "W4A8_INT8KV_CFG")
    tc = tcompress(tb)
    want = {p: np.asarray(v) for p, v in flatten_with_paths(jc.variables["quant"])}
    got = {f"{m.path}/qweight/{k}": v.numpy() for m in tc.module.modules()
           if getattr(m, "compressed", False) for k, v in m.qweight.items()}
    assert sorted(got) == sorted(want)
    assert any("moe/down_proj" in p for p in got)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert sorted(tc.records[-1].metadata["compressed"]) == sorted(
        {p.rsplit("/qweight/", 1)[0] for p in want})


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------
def test_smoothquant_lowers_int8_error():
    """The reference's TestSmoothQuant check on a heavy-tailed tiny llama
    (channels 0-3 of every pre-projection norm at 30): INT8_SMOOTHQUANT_CFG
    fake-quant logits are closer to the full-precision model's than
    INT8_DEFAULT_CFG's, and set a pre-quant scale on every input quantizer
    of a projection."""
    jb = jax_bundle(heavy=True, **WIDE)
    ids = torch.from_numpy(CALIB)
    base = tlogits(port_bundle(jb, **WIDE), CALIB)
    errs = {}
    for preset in ("INT8_DEFAULT_CFG", "INT8_SMOOTHQUANT_CFG"):
        tb = tapi.quantize(port_bundle(jb, **WIDE), preset, lambda f: f(ids))
        errs[preset] = np.linalg.norm(tlogits(tb, CALIB) - base) / np.linalg.norm(base)
        pqs = port_state(tb, "pre_quant_scale")
        assert len(pqs) == (7 if preset == "INT8_SMOOTHQUANT_CFG" else 0)
    assert errs["INT8_SMOOTHQUANT_CFG"] < errs["INT8_DEFAULT_CFG"], errs


def test_pre_quant_scale_also_on_disabled_quantizer():
    """A pre-quant scale multiplies x before calibration and quantization,
    and also when the quantizer's own spec is disabled (weight-only AWQ);
    OFF phase leaves x alone."""
    from modelopt_tpu_torch.core.bundle import PHASE_CALIB, PHASE_OFF, _set_phase
    from modelopt_tpu_torch.nn.quantizer import TensorQuantizer, quantization_active
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.fake_quant import fake_quant_int

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32))
    pqs = torch.linspace(0.5, 2.0, 8)
    q = TensorQuantizer()
    q.path, q.pre_quant_scale = "fc/input_quantizer", pqs
    with quantization_active(get_config("INT8_DEFAULT_CFG")):
        with _set_phase(PHASE_CALIB):
            assert torch.equal(q(x), x * pqs)
        assert torch.equal(q.amax, (x * pqs).abs().amax())
        assert torch.equal(q(x), fake_quant_int(x * pqs, q.amax))
        with _set_phase(PHASE_OFF):
            assert torch.equal(q(x), x)
    with quantization_active(get_config("INT4_AWQ_CFG")):  # input quantizer disabled
        assert torch.equal(q(x), x * pqs)


def test_compress_and_calibrate_refuse():
    """compress() needs a quantize record; an unknown algorithm is a
    KeyError, as in the reference."""
    tb = port_bundle(jax_bundle(**WIDE), **WIDE)
    with pytest.raises(ValueError, match="quantized"):
        tcompress(tb)
    with pytest.raises(KeyError, match="gptq"):
        tapi.calibrate(tb, "gptq", lambda f: None)


def test_fold_weight_and_disable(ptq):
    """``fold_weight`` bakes the per-channel int8 weights into the kernels
    and disables their quantizers: the same QUANT logits as before folding
    to f32 rounding; ``disable_quantizer`` / ``enable_quantizer`` append
    rules that toggle one path."""
    r = ptq("INT8_KV_CFG")
    jb = jax_bundle(**r["kw"])
    tb = tapi.quantize(port_bundle(jb, **r["kw"]), "INT8_KV_CFG",
                       lambda f: f(torch.from_numpy(CALIB)))
    before = tlogits(tb)
    fb = tapi.fold_weight(tb)
    cfg = fb.records[-1].config
    assert cfg.resolve("layers_0/mlp/down_proj/weight_quantizer") is None
    np.testing.assert_allclose(tlogits(fb), before, rtol=0, atol=1e-4 * np.abs(before).max())
    off = tapi.disable_quantizer(tb, "*down_proj/input_quantizer")
    assert off.records[-1].config.resolve("layers_0/mlp/down_proj/input_quantizer") is None
    on = tapi.enable_quantizer(off, "*down_proj/input_quantizer")
    assert on.records[-1].config.resolve("layers_0/mlp/down_proj/input_quantizer")
    mse = tapi.compute_quantization_mse(tb, torch.from_numpy(PROBE))
    assert set(mse) == {p for p in r["tq_kernels"] if not p.startswith("lm_head")}
    assert all(v["output_rel_err"] < 0.1 for v in mse.values())


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
# Greedy parity needs no near-ties: K7 w8a16_gemm takes bf16 activations
# where the reference's CPU path multiplies in f32, which moves a logit of
# this model by up to 0.18. These prompts (numpy seed 36, lengths 5, 11, 3)
# keep each of the 4 greedy choices at least 0.45 above its runner-up in
# the reference's compressed model.
PROMPTS = [[98, 47, 109, 102, 112], [228, 240, 103, 236, 175, 116, 131, 230, 137, 116, 224],
           [58, 63, 19]]


def _serve(engine):
    reqs = [engine.submit(p, max_new_tokens=4) for p in PROMPTS]
    engine.run()
    return reqs


def test_int8_kv_engines_serve_the_same_tokens(ptq):
    """The tiny llama quantized under INT8_KV_CFG (SmoothQuant) and
    compressed by each package serves the same greedy tokens in both
    engines over an int8 KV cache."""
    r = ptq("INT8_KV_CFG")
    kw = dict(max_batch=2, max_seq_len=32, prefill_buckets=(16,), max_admit=1)
    want = _serve(JaxEngine(r["jc"], kv_dtype=jnp.int8, **kw))
    got = _serve(ServingEngine(r["tc"], kv_dtype=torch.int8, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.out_tokens == w.out_tokens


def test_mla_quantize_and_compress():
    """A DeepSeek-V2-shaped model (small_mla_compressed_config, f32) built by
    ``build_bundle`` on the CPU, quantized under W4A8_INT8KV_CFG by
    awq_lite and compressed: MLA's absorbed ``kv_b_proj`` packs like any
    linear layer, the first dense layer's down projection (K = 320, no
    whole int4 block) and the router stay dense, and the compressed logits
    are within 5% of the largest fake-quant logit (per-token int8 codes
    and the MoE's top-2 choices on the two paths' last bits)."""
    from modelopt_tpu_torch.models.synthetic import build_bundle

    cfg = tt.small_mla_compressed_config(dtype=torch.float32, num_layers=2)
    tb = build_bundle(cfg, seed=0, init_scale=0.05, device="cpu")
    ids = torch.from_numpy(CALIB)
    tb = tapi.quantize(tb, "W4A8_INT8KV_CFG", lambda f: f(ids))
    before = tlogits(tb, CALIB)
    tc = tcompress(tb)
    packed = tc.records[-1].metadata["compressed"]
    assert "layers_0/attn/kv_b_proj" in packed and "layers_1/moe/down_proj" in packed
    assert "layers_0/mlp/down_proj" not in packed
    assert not any("router" in p for p in packed)
    after = tlogits(tc, CALIB)
    np.testing.assert_allclose(after, before, rtol=0, atol=5e-2 * np.abs(before).max())


ALGORITHMS = {"INT8_DEFAULT_CFG": "max", "INT8_SMOOTHQUANT_CFG": "smoothquant",
              "INT8_KV_CFG": "smoothquant", "W4A8_INT8_DYNAMIC_CFG": "awq_lite",
              "W4A8_INT8KV_CFG": "awq_lite", "INT4_AWQ_CFG": "awq_lite",
              "INT4_AWQ_CLIP_CFG": "awq_clip", "INT4_AWQ_FULL_CFG": "awq_full",
              "NVFP4_DEFAULT_CFG": "max", "NVFP4_AWQ_LITE_CFG": "awq_lite",
              "NVFP4_AWQ_CLIP_CFG": "awq_clip", "NVFP4_AWQ_FULL_CFG": "awq_full",
              "NVFP4_SVDQUANT_CFG": "svdquant", "NVFP4_MLP_ONLY_CFG": "max",
              "W4A8_NVFP4_FP8_CFG": "max", "NVFP4_EXPERTS_ONLY_CFG": "max",
              "NVFP4_KV_CFG": "max", "NVFP4_KV_ROTATE_CFG": "max"}
# presets that quantize no projection of the dense llama: the reference's
# merge of a later rule that sets no "enable" into {"enable": False} leaves
# NVFP4_MLP_ONLY_CFG's and NVFP4_EXPERTS_ONLY_CFG's quantizers disabled
NOTHING_PACKED = ("NVFP4_MLP_ONLY_CFG", "NVFP4_EXPERTS_ONLY_CFG")


@pytest.mark.parametrize("preset", list(ALGORITHMS))
def test_every_preset_runs_its_algorithm(preset, monkeypatch):
    """``quantize`` dispatches each preset to its own algorithm through the
    registry (the reference's preset table), which leaves its trace
    (pre-quant scales for SmoothQuant, AWQ lite and SVDQuant, clip ratios
    for AWQ clip); ``compress`` then packs every projection (none under
    NOTHING_PACKED) and the compressed model runs."""
    called = []
    for name, fn in list(tapi.CALIB_ALGORITHMS.items()):
        monkeypatch.setitem(tapi.CALIB_ALGORITHMS, name,
                            lambda *a, _n=name, _f=fn, **k: called.append(_n) or _f(*a, **k))
    tb = tapi.quantize(port_bundle(jax_bundle(**WIDE), **WIDE), preset,
                       lambda f: f(torch.from_numpy(CALIB)))
    assert called == [ALGORITHMS[preset]]
    assert bool(port_state(tb, "pre_quant_scale")) == (
        ALGORITHMS[preset] in ("smoothquant", "awq_lite", "awq_full", "svdquant"))
    assert ("awq_clip" in tb.metadata) == (ALGORITHMS[preset] in ("awq_clip", "awq_full"))
    tc = tcompress(tb)
    assert len(tc.records[-1].metadata["compressed"]) == (0 if preset in NOTHING_PACKED else 7)
    assert np.isfinite(tlogits(tc)).all()
