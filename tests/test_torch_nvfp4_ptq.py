"""The NVFP4 presets that quantize activations, in the port against the JAX
package: each preset's own algorithm (max, awq_lite / awq_clip, SVDQuant)
on a one-layer llama of hidden 128 (fused projections, whole 128-column
tiles), the calibrated state, SVDQuant's low-rank branch, the compressed
NVFP4 bytes, fake-quant and compressed logits; the MoE presets on a tiny
MoE; ``nvfp4_act_headroom``; the Hadamard rotation; NVFP4 activation
fake quantization bit for bit; greedy serving of an SVDQuant model
through both engines. Each reference run is made once per module."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import modelopt_tpu.quant as mtq
from modelopt_tpu.core.tree import flatten_with_paths, get_in, set_in
from modelopt_tpu.kernels.quant_gemm import _nvfp4_chunk
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import backends as jbackends
from modelopt_tpu.quant import fake_quant as jfq
from modelopt_tpu.quant.algorithms import nvfp4_headroom as jhead
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu.quant.rotation import _hadamard_np as ref_hadamard
from modelopt_tpu.quant.rotation import hadamard_rotate as ref_rotate
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant import api as tapi
from modelopt_tpu_torch.quant import config as tconfig
from modelopt_tpu_torch.quant.algorithms import nvfp4_headroom as thead
from modelopt_tpu_torch.quant.compress import compress as tcompress
from modelopt_tpu_torch.quant.fake_quant import fake_quantize
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec
from modelopt_tpu_torch.quant.rotation import _hadamard_np, hadamard_rotate
from modelopt_tpu_torch.serve import ServingEngine
from tests._test_utils.pallas_interpret import pallas_interpreted
from tests.test_torch_ptq import (CALIB, TINY_MOE, jax_bundle, jlogits, port_bundle,
                                  ref_state, tlogits)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: torch's intra-op thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one layer, hidden 128, fused q / k / v and gate / up: every projection a
# whole number of 128-column tiles, so the reference's NVFP4 kernel takes
# each of them (``reference_nvfp4_kernels``)
FUSED = dict(hidden_size=128, intermediate_size=128, num_layers=1, fused_qkv=True,
             fused_gate_up=True)
PRESETS = ("NVFP4_DEFAULT_CFG", "NVFP4_AWQ_LITE_CFG", "NVFP4_AWQ_FULL_CFG",
           "NVFP4_SVDQUANT_CFG", "W4A8_NVFP4_FP8_CFG", "NVFP4_MLP_ONLY_CFG", "NVFP4_KV_CFG",
           "NVFP4_KV_ROTATE_CFG")
# MLP_ONLY_NOTE: NVFP4_MLP_ONLY_CFG and NVFP4_EXPERTS_ONLY_CFG quantize
# nothing in the reference: their "*weight_quantizer" rule {"enable": False}
# is merged attribute by attribute with the later "*mlp*" / "*moe*" NVFP4
# rule, which sets no "enable", so every quantizer stays disabled. The port
# keeps the reference's rule engine, so its presets do the same.
# SVDQuant's products on weights with a planted rank-32 part (the
# algorithm's default rank): the top-32 singular values of W' stand at
# least this far above the 33rd, so the truncation is well posed
SPECTRAL_GAP = 2.0


def _loop(ids):
    return lambda f: f(jnp.asarray(ids)) if isinstance(ids, np.ndarray) else f(ids)


def _pallas_shape_rule(fmt, x, kn, block=128):
    """The reference's ``_pallas_ok`` NVFP4 rule without its TPU and size
    tests: whole 128-row and 128-column tiles and a clean chunking."""
    K, N = kn
    return (fmt == "nvfp4" and x.shape[0] <= jbackends.PALLAS_MAX_M and K % 128 == 0
            and N % 128 == 0 and _nvfp4_chunk(K // 2, block) is not None)


@contextlib.contextmanager
def reference_nvfp4_kernels():
    """The reference's compressed NVFP4 GEMMs through its Pallas kernel in
    interpret mode (its CPU route dequantizes and multiplies in f32): its
    kernel rounds x to bf16, as the port's K9 does on both devices."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackends, "_pallas_ok", _pallas_shape_rule)
        with pltpu.force_tpu_interpret_mode():
            yield


def planted_bundle():
    """The tiny llama of ``FUSED`` whose projection kernels carry a planted
    rank-32 part: W = N(0, 1/in) + U diag(sigma) V^T with orthonormal U, V
    and sigma from 24 down to 12 (the noise's largest singular value is
    ~2.4), channel outliers in the norms."""
    rng = np.random.default_rng(6)

    def planted(w):
        u = np.linalg.qr(rng.standard_normal((w.shape[0], 32)))[0]
        v = np.linalg.qr(rng.standard_normal((w.shape[1], 32)))[0]
        return w + (u * np.linspace(24.0, 12.0, 32)) @ v.T

    return _with_kernels(jax_bundle(seed=5, heavy=True, **FUSED), planted)


def _with_kernels(jb, make):
    """``jb`` with every projection kernel w (lm_head's aside) replaced by
    ``make(w)``, in f32."""
    params = jb.variables["params"]
    for path, leaf in flatten_with_paths(params):
        keys = tuple(path.split("/"))
        if keys[-1] != "kernel" or keys[0] == "lm_head":
            continue
        params = set_in(params, keys, jnp.asarray(make(np.asarray(leaf)), jnp.float32))
    return jb.replace(variables={**jb.variables, "params": params})


def _carried(jq, preset, cfg_fn=tt.tiny_test_config, **kw):
    """The reference's quantized variables in a port bundle (the preset's
    quantize record, no compress)."""
    return from_jax_variables(jax.tree.map(np.asarray, jq.variables),
                              cfg_fn(dtype=torch.float32, **kw), quant_config=preset,
                              device="cpu")


def _branch(mod_or_vars, path=None):
    """(svd_lora_a, svd_lora_b) of a port layer or of the reference's
    variables at ``path``."""
    if path is None:
        return mod_or_vars.svd_lora_a.numpy(), mod_or_vars.svd_lora_b.numpy()
    q = get_in(mod_or_vars["quant"], tuple(path.split("/")))
    return np.asarray(q["svd_lora_a"]), np.asarray(q["svd_lora_b"])


@pytest.fixture(scope="module")
def runs():
    """Per preset, once, from the same weights: the reference quantized
    (fake-quant logits), compressed (logits through its NVFP4 kernel); the
    port's own run (state, kernels, fake-quant logits, then compressed and
    its logits); and the port's compress of the reference's quantized
    variables (bytes, logits)."""
    out = {}
    jb = jax_bundle(**FUSED)

    def get(preset):
        if preset in out:
            return out[preset]
        jq = mtq.quantize(jb, preset, _loop(CALIB))
        r = {"jb": jb, "jq": jq, "jq_logits": jlogits(jq), "jc": jcompress(jq)}
        with reference_nvfp4_kernels():
            r["jc_logits"] = jlogits(r["jc"])
        tb = tapi.quantize(port_bundle(jb, **FUSED), preset, _loop(torch.from_numpy(CALIB)))
        mods = {m.path: m for m in tb.module.modules()}
        r["t_mods"] = mods
        r["tq_kernels"] = {p: m.kernel.clone().numpy() for p, m in mods.items()
                           if getattr(m, "kernel", None) is not None}
        r["tq_logits"] = tlogits(tb)
        r["tc_logits"] = tlogits(tcompress(tb))
        carried = r["carried_bundle"] = tcompress(_carried(jq, preset, **FUSED))
        r["carried"] = {m.path: m for m in carried.module.modules()}
        r["carried_logits"] = tlogits(carried)
        out[preset] = r
        return r

    return get


# --------------------------------------------------------------------------
# the presets against the reference
# --------------------------------------------------------------------------
def test_presets_in_choices():
    """The ten NVFP4 presets of the reference's table are the port's, rule
    for rule, each with the reference's algorithm."""
    import dataclasses

    from modelopt_tpu.quant import config as jconfig

    names = PRESETS + ("NVFP4_AWQ_CLIP_CFG", "NVFP4_EXPERTS_ONLY_CFG")
    paths = ["layers_0/attn/qkv_proj/weight_quantizer", "layers_0/attn/qkv_proj/input_quantizer",
             "layers_0/mlp/down_proj/input_quantizer", "layers_0/moe/down_proj/weight_quantizer",
             "layers_0/moe/down_proj/input_quantizer", "layers_0/attn/q_quantizer",
             "layers_0/attn/k_quantizer", "layers_0/attn/v_quantizer",
             "lm_head/weight_quantizer"]
    for name in names:
        assert name in tconfig.choices, name
        t, j = tconfig.get_config(name), jconfig.get_config(name)
        assert t.algorithm_name == j.algorithm_name, name
        for p in paths:
            ts, js = t.resolve(p), j.resolve(p)
            assert (ts is None) == (js is None), (name, p)
            if ts:
                assert [dataclasses.asdict(s) for s in ts] == \
                    [dataclasses.asdict(s) for s in js], (name, p)


@pytest.mark.parametrize("preset", PRESETS)
def test_calibrated_state_matches_reference(preset, runs):
    """The port's own algorithm from the reference's weights: the same
    calibrated amax (weights' per-tensor NVFP4 amax, activations', q / k /
    v's, rotated under NVFP4_KV_ROTATE_CFG) and pre-quant scales, to rtol
    1e-5 on the first projection (its input is the embedding's norm on
    both) and 1e-4 after it (inputs through f32 GEMMs summed in another
    order); kernels (AWQ's scale folded in and clipped, SVDQuant's
    residual) to 1e-4 of each kernel's largest value."""
    r = runs(preset)
    jv = r["jq"].variables
    for name in ("pre_quant_scale", "amax"):
        want = ref_state(jv, name)
        got = {p: v.numpy() for p, v in port_state_of(r["t_mods"], name).items()}
        assert sorted(got) == sorted(want), name
        for p in want:
            rtol = 1e-5 if p.startswith("layers_0/attn/qkv_proj/") else 1e-4
            np.testing.assert_allclose(got[p].reshape(want[p].shape), want[p], rtol=rtol,
                                       err_msg=f"{name} {p}")
    if preset in ("NVFP4_AWQ_LITE_CFG", "NVFP4_AWQ_FULL_CFG", "NVFP4_SVDQUANT_CFG"):
        assert len(ref_state(jv, "pre_quant_scale")) == 4
    for p, w in r["tq_kernels"].items():
        want = np.asarray(get_in(jv["params"], tuple(p.split("/")) + ("kernel",)))
        np.testing.assert_allclose(w, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=p)


def port_state_of(mods, name):
    """{quantizer path: buffer} of every quantizer module holding ``name``."""
    return {p: getattr(m, name) for p, m in mods.items()
            if p.endswith("quantizer") and getattr(m, name, None) is not None}


def test_svdquant_branch_on_random_weights(runs):
    """On plain random weights the top-32 subspace is not well separated,
    so only what is independent of the solver's choice is held: each
    layer's residual plus its branch is the smoothed kernel W' = diag(s) W
    (s = 1 / pre_quant_scale, the branch's L1 = diag(s) svd_lora_a) to f32
    rounding (1e-5 of W''s largest value), and W' is the reference's to
    1e-4 (the same smoothing scale); the layers' outputs are held by the
    logits (``test_logits_match_reference``). Rank 32 = min(32, 128 // 2)
    on every projection."""
    r = runs("NVFP4_SVDQUANT_CFG")
    jv, mods = r["jq"].variables, r["t_mods"]
    layers = sorted(p for p, m in mods.items() if getattr(m, "svd_lora_a", None) is not None)
    assert layers == sorted(p.rsplit("/input_quantizer", 1)[0]
                            for p in ref_state(jv, "pre_quant_scale"))
    for p in layers:
        w = np.asarray(get_in(r["jb"].variables["params"], tuple(p.split("/")) + ("kernel",)))
        s = 1.0 / mods[p].input_quantizer.pre_quant_scale.numpy()
        a, b = _branch(mods[p])
        assert a.shape == (w.shape[0], 32) and b.shape == (32, w.shape[1])
        w_s = w * s[:, None]
        np.testing.assert_allclose(r["tq_kernels"][p] + (a * s[:, None]) @ b, w_s, rtol=0,
                                   atol=1e-5 * np.abs(w_s).max(), err_msg=p)
        ja, jb_ = _branch(jv, p)
        js = 1.0 / np.asarray(get_in(jv["quant"], tuple(p.split("/"))
                                     + ("input_quantizer", "pre_quant_scale")))
        jw_s = np.asarray(get_in(jv["params"], tuple(p.split("/")) + ("kernel",))) \
            + (ja * js[:, None]) @ jb_
        np.testing.assert_allclose(w_s, jw_s, rtol=0, atol=1e-4 * np.abs(jw_s).max(),
                                   err_msg=p)


def test_svdquant_products_on_planted_weights():
    """Weights with a planted rank-32 part and a spectral gap of at least
    SPECTRAL_GAP in every smoothed kernel: the port's low-rank product
    ``svd_lora_a @ svd_lora_b`` and residual are the reference's (the
    port's f64 Gram eigensolve against the JAX package's f32 SVD), to 1e-4
    of each one's largest value (the smoothing scales agree to 1e-5 on the
    first projection and 1e-4 after); the fake-quant logits agree within 2%
    of the largest."""
    jb = planted_bundle()
    jq = mtq.quantize(jb, "NVFP4_SVDQUANT_CFG", _loop(CALIB))
    tb = tapi.quantize(port_bundle(jb, **FUSED), "NVFP4_SVDQUANT_CFG",
                       _loop(torch.from_numpy(CALIB)))
    jv = jq.variables
    mods = {m.path: m for m in tb.module.modules()}
    layers = [p for p, m in mods.items() if getattr(m, "svd_lora_a", None) is not None]
    assert len(layers) == 4
    for p in layers:
        a, b = _branch(mods[p])
        ja, jb_ = _branch(jv, p)
        keys = tuple(p.split("/"))
        js = 1.0 / np.asarray(get_in(jv["quant"], keys + ("input_quantizer", "pre_quant_scale")))
        w_s = np.asarray(get_in(jb.variables["params"], keys + ("kernel",))) * js[:, None]
        sv = np.linalg.svd(w_s.astype(np.float64), compute_uv=False)
        assert sv[31] / sv[32] >= SPECTRAL_GAP, (p, sv[31] / sv[32])
        want = ja @ jb_
        np.testing.assert_allclose(a @ b, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=p)
        jr = np.asarray(get_in(jv["params"], keys + ("kernel",)))
        np.testing.assert_allclose(mods[p].kernel.numpy(), jr, rtol=0,
                                   atol=1e-4 * np.abs(jr).max(), err_msg=p)
    want = jlogits(jq)
    np.testing.assert_allclose(tlogits(tb), want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("preset", PRESETS)
def test_compressed_bytes_match_reference(preset, runs):
    """The port's ``compress`` of the reference's quantized variables
    (carried by ``from_jax_variables``, SVDQuant's branch and pre-quant
    scales included) packs the same layers as the reference's compress,
    bit for bit: e2m1 codes, e4m3 block scales and the f32 ``scale2``; the
    SVD buffers and pre-quant scales stay beside the packed residual."""
    r = runs(preset)
    want = {p: np.asarray(v) for p, v in
            flatten_with_paths(r["jc"].variables.get("quant", {})) if "/qweight/" in p}
    got = {f"{m.path}/qweight/{k}": v for m in r["carried"].values()
           if getattr(m, "compressed", False) for k, v in m.qweight.items()}
    assert sorted(got) == sorted(want)
    # NVFP4_MLP_ONLY_CFG quantizes nothing in the reference (MLP_ONLY_NOTE)
    assert bool(want) == (preset != "NVFP4_MLP_ONLY_CFG")
    for p, w in want.items():
        g = got[p]
        if w.dtype.name == "float8_e4m3fn":
            w, g = w.view(np.uint8), g.view(torch.uint8)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    for p, m in r["carried"].items():
        if getattr(m, "svd_lora_a", None) is not None:
            assert m.compressed and m.kernel is None
            np.testing.assert_array_equal(m.svd_lora_a.numpy(), _branch(r["jc"].variables, p)[0])
            assert m.input_quantizer.pre_quant_scale is not None
    if preset == "NVFP4_SVDQUANT_CFG":
        assert sum(getattr(m, "svd_lora_a", None) is not None
                   for m in r["carried"].values()) == 4


@pytest.mark.parametrize("preset", PRESETS)
def test_logits_match_reference(preset, runs):
    """Fake-quant logits (QUANT phase) of the port's own run against the
    reference's, within 2% of the largest logit, argmax at 98% of positions
    or more (``test_torch_ptq.py``'s bars). Compressed: the reference's
    variables packed by the port against the reference's compressed model
    through its NVFP4 kernel (both round x to bf16), to 1e-5 of the largest
    logit and the same argmax everywhere; the port's own compressed model
    against the same within 2% of the largest logit (its calibration's last
    bits move NVFP4 codes at rounding ties, which the model amplifies)."""
    r = runs(preset)
    got, want = r["tq_logits"], r["jq_logits"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98
    want_c = r["jc_logits"]
    np.testing.assert_allclose(r["carried_logits"], want_c, rtol=0,
                               atol=1e-5 * np.abs(want_c).max())
    assert (r["carried_logits"].argmax(-1) == want_c.argmax(-1)).all()
    np.testing.assert_allclose(r["tc_logits"], want_c, rtol=0,
                               atol=2e-2 * np.abs(want_c).max())


@pytest.mark.parametrize("preset", ["NVFP4_DEFAULT_CFG", "NVFP4_EXPERTS_ONLY_CFG"])
def test_moe_presets_match_reference(preset):
    """tiny_moe_test_config (one layer, hidden 128): the port's own
    calibration gives the reference's fake-quant logits within 2% of the
    largest and the same calibrated amax (rtol 1e-4). Under
    NVFP4_DEFAULT_CFG every projection, the experts' included, has NVFP4
    weights and activations and ``compress`` packs them all (the router
    stays dense); NVFP4_EXPERTS_ONLY_CFG quantizes nothing, as in the
    reference (MLP_ONLY_NOTE)."""
    jb = jax_bundle(cfg_fn=lambda **kw: jt.qwen3_moe_config(**{**TINY_MOE, **kw}))
    jq = mtq.quantize(jb, preset, _loop(CALIB))
    tb = tapi.quantize(port_bundle(jb, cfg_fn=tt.tiny_moe_test_config, **TINY_MOE), preset,
                       _loop(torch.from_numpy(CALIB)))
    want, got = jlogits(jq), tlogits(tb)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    want_amax = ref_state(jq.variables, "amax")
    got_amax = port_state_of({m.path: m for m in tb.module.modules()}, "amax")
    assert sorted(got_amax) == sorted(want_amax)
    for p, w in want_amax.items():
        np.testing.assert_allclose(got_amax[p].numpy().reshape(w.shape), w, rtol=1e-4,
                                   err_msg=p)
    packed = tcompress(tb).records[-1].metadata["compressed"]
    if preset == "NVFP4_DEFAULT_CFG":
        assert {"layers_0/moe/down_proj", "layers_0/moe/gate_proj",
                "layers_0/attn/q_proj"} <= set(packed), packed
        assert not any("router" in p for p in packed)
    else:
        assert packed == [] and not want_amax


# --------------------------------------------------------------------------
# nvfp4_act_headroom, rotation, NVFP4 activation fake quantization
# --------------------------------------------------------------------------
def test_headroom_amax_matches_reference():
    """``headroom_amax`` on heavy-tailed numpy data (a few outlier blocks, a
    tail of near-zero ones, a ragged last block) against the reference's,
    to 1e-6 relative, at the defaults and at other percentiles; an
    all-zero input gives 1e-12."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 200)).astype(np.float32)
    x[:, :16] *= 40.0
    x[:50] *= 1e-9
    for args in ((16, 1.0, 99.99, 64.0), (16, 5.0, 90.0, 8.0), (32, 0.0, 100.0, 1.0)):
        want = jhead.headroom_amax(x, *args)
        got = thead.headroom_amax(torch.from_numpy(x), *args)
        assert abs(got - want) <= 1e-6 * abs(want), (args, got, want)
    assert thead.headroom_amax(torch.zeros(4, 32), 16, 1.0, 99.99, 64.0) == 1e-12


def test_headroom_calibration_matches_reference(runs):
    """``calibrate(bundle, "nvfp4_act_headroom")`` on the tiny llama under
    NVFP4_DEFAULT_CFG: the same input amax as the reference's on every
    projection (rtol 1e-5 on the first, 1e-4 after), each at least the
    plain max calibration's (rho * anchor or the 99.99th percentile)."""
    r = runs("NVFP4_DEFAULT_CFG")
    jh = mtq.calibrate(r["jq"], "nvfp4_act_headroom", _loop(CALIB))
    ids = torch.from_numpy(CALIB)
    tb = tapi.quantize(port_bundle(r["jb"], **FUSED), "NVFP4_DEFAULT_CFG", _loop(ids))
    before = {p: v.clone() for p, v in port_state_of(
        {m.path: m for m in tb.module.modules()}, "amax").items()}
    tb = tapi.calibrate(tb, "nvfp4_act_headroom", _loop(ids))
    want = {p: v for p, v in ref_state(jh.variables, "amax").items()
            if p.endswith("input_quantizer")}
    got = port_state_of({m.path: m for m in tb.module.modules()}, "amax")
    assert len(want) == 4
    for p, w in want.items():
        rtol = 1e-5 if p.startswith("layers_0/attn/qkv_proj/") else 1e-4
        np.testing.assert_allclose(got[p].numpy(), w, rtol=rtol, err_msg=p)
        assert got[p] > before[p], p


def test_hadamard_rotation_matches_reference():
    """The port's Hadamard matrix is the reference's, bit for bit, at every
    power of two up to 256; a rotation agrees with the reference's to f32
    rounding and is undone by a second one; a dimension that is not a power
    of two raises ValueError, as in the reference."""
    for d in (1, 2, 16, 128, 256):
        np.testing.assert_array_equal(_hadamard_np(d), ref_hadamard(d))
    x = np.random.default_rng(8).standard_normal((3, 5, 128)).astype(np.float32)
    got = hadamard_rotate(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_rotate(jnp.asarray(x))), rtol=0,
                               atol=1e-6 * np.abs(x).max() * 4)
    np.testing.assert_allclose(hadamard_rotate(got).numpy(), x, rtol=0, atol=1e-5)
    assert hadamard_rotate(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16
    for d in (3, 48, 0):
        with pytest.raises(ValueError, match="power-of-2"):
            hadamard_rotate(torch.zeros(2, d))


def test_rotated_quantizer_calibrates_in_the_rotated_basis():
    """A ``rotate`` spec: CALIB records the amax of the rotated tensor and
    returns x (rotated twice, to f32 rounding); QUANT fake-quantizes in
    the rotated basis and rotates back."""
    from modelopt_tpu_torch.core.bundle import PHASE_CALIB, _set_phase
    from modelopt_tpu_torch.nn.quantizer import TensorQuantizer, quantization_active

    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 4, 128))
                         .astype(np.float32))
    x[..., 3] *= 50.0
    q = TensorQuantizer()
    q.path = "layers_0/attn/k_quantizer"
    spec = tconfig.get_config("NVFP4_KV_ROTATE_CFG").resolve(q.path)[0]
    assert spec.rotate
    with quantization_active(tconfig.get_config("NVFP4_KV_ROTATE_CFG")):
        with _set_phase(PHASE_CALIB):
            torch.testing.assert_close(q(x), x, rtol=0, atol=1e-4)
        assert torch.equal(q.amax, hadamard_rotate(x).abs().amax())
        want = hadamard_rotate(fake_quantize(hadamard_rotate(x), spec, tensor_amax=q.amax))
        assert torch.equal(q(x), want)


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_nvfp4_activation_fake_quant_bits(calibrated):
    """NVFP4 activation fake quantization (``_A_NVFP4``: blocks of 16 along
    the features, e4m3 block scales over an f32 per-tensor scale, true
    divisions) is the reference's ``fake_quantize`` bit for bit on the CPU,
    with a calibrated per-tensor amax and with this call's own; inputs over
    many binades, zero blocks and a ragged last block."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((6, 200)) * np.exp2(rng.integers(-20, 12, (6, 200)))) \
        .astype(np.float32)
    x[1, 32:48] = 0.0
    d = {"num_bits": (2, 1), "block_sizes": {-1: 16, "type": "dynamic",
                                             "scale_format": "e4m3", "two_level": True}}
    amax = np.float32(np.abs(x).max() * 0.75) if calibrated else None
    want = np.asarray(jfq.fake_quantize(
        jnp.asarray(x), JSpec.from_dict(d),
        tensor_amax=None if amax is None else jnp.asarray(amax)))
    got = fake_quantize(torch.from_numpy(x), TSpec.from_dict(d),
                        tensor_amax=None if amax is None else torch.tensor(amax)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------
def test_svdquant_lowers_nvfp4_error():
    """The reference's TestSVDQuant check on a heavy-tailed tiny llama
    (channels 0-3 of every pre-projection norm at 30): NVFP4_SVDQUANT_CFG's
    fake-quant logits are closer to the full-precision model's than
    NVFP4_DEFAULT_CFG's, and the SVDQuant model carries a branch on every
    projection."""
    jb = jax_bundle(heavy=True, **FUSED)
    ids = torch.from_numpy(CALIB)
    base = tlogits(port_bundle(jb, **FUSED), CALIB)
    errs = {}
    for preset in ("NVFP4_DEFAULT_CFG", "NVFP4_SVDQUANT_CFG"):
        tb = tapi.quantize(port_bundle(jb, **FUSED), preset, _loop(ids))
        errs[preset] = np.linalg.norm(tlogits(tb, CALIB) - base) / np.linalg.norm(base)
        branches = sum(getattr(m, "svd_lora_a", None) is not None for m in tb.module.modules())
        assert branches == (4 if preset == "NVFP4_SVDQUANT_CFG" else 0)
    assert errs["NVFP4_SVDQUANT_CFG"] < errs["NVFP4_DEFAULT_CFG"], errs


def test_svdquant_branch_on_rank_deficient_weights():
    """Projection kernels of rank 8, below SVDQuant's rank 32: the
    trailing singular triplets are (near) zero, and the branch, the
    residual and the logits stay finite, with R + svd_lora_a @ svd_lora_b
    = diag(s) W (s = 1 / pre_quant_scale) to 1e-5 of its largest value."""
    rng = np.random.default_rng(7)
    jb = _with_kernels(jax_bundle(heavy=True, **FUSED), lambda w: (
        rng.standard_normal((w.shape[0], 8)) @ rng.standard_normal((8, w.shape[1]))
        / w.shape[0]))
    tb = port_bundle(jb, **FUSED)
    w = {m.path: m.kernel.detach().clone() for m in tb.module.modules()
         if getattr(m, "kernel", None) is not None and m.path != "lm_head"}
    tb = tapi.quantize(tb, "NVFP4_SVDQUANT_CFG", _loop(torch.from_numpy(CALIB)))
    mods = {m.path: m for m in tb.module.modules()}
    assert len(w) == 4
    for p, w0 in w.items():
        m = mods[p]
        s = 1.0 / m.input_quantizer.pre_quant_scale
        assert all(torch.isfinite(t).all() for t in (m.kernel, m.svd_lora_a, m.svd_lora_b)), p
        w_s = w0 * s[:, None]
        torch.testing.assert_close(m.kernel + (m.svd_lora_a * s[:, None]) @ m.svd_lora_b, w_s,
                                   rtol=0, atol=1e-5 * w_s.abs().max().item(), msg=p)
    assert np.isfinite(tlogits(tb, CALIB)).all()


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
PROMPTS = [[98, 47, 109, 102, 112], [228, 240, 103, 236, 175, 116, 131, 230, 137, 116, 224],
           [58, 63, 19]]


def test_svdquant_engines_serve_the_same_tokens(runs, monkeypatch):
    """The tiny llama quantized under NVFP4_SVDQUANT_CFG and compressed by
    the reference, carried into the port, serves the same greedy tokens in
    both engines: the reference's through its Pallas kernels in interpret
    mode (its NVFP4 GEMMs too, so both round x to bf16), the port's through
    its kernels' plain twins, with the SVD branch on every projection."""
    r = runs("NVFP4_SVDQUANT_CFG")
    kw = dict(max_batch=2, max_seq_len=32, prefill_buckets=(16,), max_admit=1)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=4) for p in PROMPTS]
        engine.run()
        return reqs

    with pallas_interpreted(monkeypatch, prefill_and_gemms=True):
        monkeypatch.setattr(jbackends, "_pallas_ok", _pallas_shape_rule)
        want = serve(JaxEngine(r["jc"], **kw))
        got = serve(ServingEngine(r["carried_bundle"], device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.out_tokens == w.out_tokens
