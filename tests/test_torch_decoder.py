"""The serving slice as a whole on the CPU: a tiny llama bundle of the JAX
package, compressed under W4A8_INT8KV_CFG / W4A8_INT8_DYNAMIC_CFG with
weights drawn by numpy, carried into the port by ``from_jax_variables``;
calibrated KV amax and cached prefill / decode logits held against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant.api import calibrate


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tiny_test_config widened to whole int4 blocks (K/2 % 128 == 0), fused
# projections as on the main path
WIDE = dict(hidden_size=256, intermediate_size=512, fused_qkv=True, fused_gate_up=True)
B, T, S, STEPS = 2, 12, 32, 3


def reference_bundle(preset, jdtype=jnp.bfloat16, seed=0, lm_scale=1.0, **overrides):
    """A JAX ModelBundle whose weights come from numpy: projections packed by
    the reference's quantize_int4, embedding / norms / lm_head in f32."""
    rng = np.random.default_rng(seed)
    cfg = jt.tiny_test_config(dtype=jdtype, **WIDE, **overrides)
    module = jt.Decoder(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    qcfg = jget_config(preset)
    params, quant = {}, {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            dense = "/".join(keys[:-1])
            w = rng.standard_normal(leaf.shape).astype(np.float32) / np.sqrt(leaf.shape[0])
            specs = qcfg.resolve(dense + "/weight_quantizer")
            if specs:
                qt = jq.quantize_int4(jnp.asarray(w))
                quant = set_in(quant, keys[:-1] + ("qweight",), qt)
            else:
                params = set_in(params, keys, jnp.asarray(w * lm_scale))
        elif keys[-1] == "scale":
            params = set_in(params, keys, jnp.asarray(
                1.0 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32))
        else:
            params = set_in(params, keys, jnp.asarray(
                rng.standard_normal(leaf.shape), jnp.float32))
    records = (ModeRecord("quantize", qcfg, {}), ModeRecord("compress", {}, {}))
    return ModelBundle(module=module, variables={"params": params, "quant": quant},
                       example_inputs=(ids,), records=records)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(tdtype=torch.bfloat16, **overrides):
    return tt.tiny_test_config(dtype=tdtype, **WIDE, **overrides)


def jax_calibrate(jb):
    ids = jnp.asarray(np.random.default_rng(1).integers(1, 256, (B, T)), jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, ids, jt.make_cache(jb.module.cfg, B, S))
    return jb.replace(variables={**jb.variables, "quant": mut["quant"]}), ids


@pytest.fixture(scope="module")
def calibrated():
    """The W4A8_INT8KV_CFG reference bundle before and after calibration, and
    the calibration ids (one jit compile shared by the tests below)."""
    jb = reference_bundle("W4A8_INT8KV_CFG")
    return (jb, *jax_calibrate(jb))


def test_calibrated_kv_amax_matches(calibrated):
    """Same numpy weights, same forward loop: the port's k/v amax equal the
    reference's within bf16 rounding — k and v pass through bf16 projections
    and RoPE whose last bits differ (the reference's CPU GEMM multiplies
    fake-quantized bf16 operands, the port runs the exact int8 product)."""
    jb, jcal, ids = calibrated
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(), "W4A8_INT8KV_CFG",
                            device="cpu")
    calibrate(tb, "max", lambda f: f(torch.from_numpy(np.array(ids)),
                                     tt.make_cache(port_cfg(), B, S, device="cpu")))
    for i in range(2):
        for name in ("k_quantizer", "v_quantizer"):
            want = float(jcal.variables["quant"][f"layers_{i}"]["attn"][name]["amax"])
            got = float(getattr(getattr(tb.module, f"layers_{i}").attn, name).amax)
            assert got == pytest.approx(want, rel=2e-2), (i, name)


@pytest.mark.parametrize("preset,kv", [("W4A8_INT8KV_CFG", "int8"),
                                       ("W4A8_INT8_DYNAMIC_CFG", "model")])
def test_cached_logits_match(preset, kv, calibrated):
    """Prefill then cached decode, teacher-forced, both packages from the
    same calibrated variables. On the CPU the reference takes its XLA einsum
    attention over bf16-dequantized caches, and so does the port: at
    D = 64 neither dense-cache gate admits its kernel. Held at 5% of the logit range
    (bf16 model); greedy choices at the last position agree."""
    jb = calibrated[1] if kv == "int8" else reference_bundle(preset)
    jdt = jnp.int8 if kv == "int8" else None
    tdt = torch.int8 if kv == "int8" else None
    ids = np.random.default_rng(2).integers(1, 256, (B, T + STEPS)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    cache = jt.make_cache(jb.module.cfg, B, S, dtype=jdt)
    lj, cache = fn(jb.variables, jnp.asarray(ids[:, :T]), cache)
    want = [np.asarray(lj[:, -1], np.float32)]
    for t in range(STEPS):
        lj, cache = fn(jb.variables, jnp.asarray(ids[:, T + t:T + t + 1]), cache)
        want.append(np.asarray(lj[:, -1], np.float32))
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(), preset, device="cpu")
    tcache = tt.make_cache(port_cfg(), B, S, dtype=tdt, device="cpu")
    lt, tcache = tb.apply(torch.from_numpy(ids[:, :T]), tcache)
    got = [lt[:, -1].float().numpy()]
    for t in range(STEPS):
        lt, tcache = tb.apply(torch.from_numpy(ids[:, T + t:T + t + 1]), tcache)
        got.append(lt[:, -1].float().numpy())
    want, got = np.stack(want), np.stack(got)
    assert int(tcache["lengths"][0]) == T + STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


def test_uncalibrated_int8_cache_raises():
    jb = reference_bundle("W4A8_INT8KV_CFG")
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(), "W4A8_INT8KV_CFG",
                            device="cpu")
    cache = tt.make_cache(port_cfg(), 1, S, dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="(?i)calibrated"):
        tb.apply(torch.ones(1, 4, dtype=torch.int32), cache)


def test_uncached_forward_matches():
    """The cache-free path (einsum attention with a causal mask) agrees too."""
    jb = reference_bundle("W4A8_INT8_DYNAMIC_CFG")
    ids = np.random.default_rng(3).integers(1, 256, (B, T)).astype(np.int32)
    lj, _ = jax.jit(jb.make_fn())(jb.variables, jnp.asarray(ids))
    tb = from_jax_variables(to_numpy(jb.variables), port_cfg(), "W4A8_INT8_DYNAMIC_CFG",
                            device="cpu")
    lt, _ = tb.apply(torch.from_numpy(ids))
    want = np.asarray(lj, np.float32)
    np.testing.assert_allclose(lt.float().numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_tied_lm_head_matches():
    """``tie_word_embeddings``: no lm_head parameters; the embedding table is
    the LM head (``QuantEmbed.attend``) in both packages, uncached and
    cached (prefill then one decode step), at the bf16 bar above."""
    preset = "W4A8_INT8_DYNAMIC_CFG"
    jb = reference_bundle(preset, tie_word_embeddings=True)
    assert "lm_head" not in jb.variables["params"]
    ids = np.random.default_rng(3).integers(1, 256, (B, T)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    lj, _ = fn(jb.variables, jnp.asarray(ids))
    jcache = jt.make_cache(jb.module.cfg, B, S)
    _, jcache = fn(jb.variables, jnp.asarray(ids[:, :-1]), jcache)
    lj1, _ = fn(jb.variables, jnp.asarray(ids[:, -1:]), jcache)
    cfg = port_cfg(tie_word_embeddings=True)
    tb = from_jax_variables(to_numpy(jb.variables), cfg, preset, device="cpu")
    assert not hasattr(tb.module, "lm_head")
    lt, _ = tb.apply(torch.from_numpy(ids))
    tcache = tt.make_cache(cfg, B, S, device="cpu")
    _, tcache = tb.apply(torch.from_numpy(ids[:, :-1]), tcache)
    lt1, _ = tb.apply(torch.from_numpy(ids[:, -1:]), tcache)
    for got, want in ((lt, lj), (lt1, lj1)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=5e-2 * np.abs(want).max())
