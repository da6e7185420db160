"""The dense MHA cache under the reference's kernel gates: the port takes K2
``fused_decode_attention`` only under ``fused_decode_ok`` and K4
``flash_prefill_attention`` only under ``flash_prefill_ok``, and an uncached
forward K14 ``flash_attention`` only under ``flash_attention_ok`` (the
reference's shape rules plus the CUDA kernels' limits); other forwards
write the cache by K3 and attend by K5 or the einsum over the cache, as
the reference does. The JAX side runs under the reference's shape rules
(``reference_shape_rules``: its gates decide as on a TPU), so both take the
einsum at these shapes; the port's kernels are replaced by functions that
fail, which shows the route."""

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
from modelopt_tpu_torch.kernels.attention import decode_attention, fused_decode_ok
from modelopt_tpu_torch.kernels.flash_attention import flash_attention_ok, flash_prefill_ok
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from tests._test_utils.pallas_interpret import reference_shape_rules


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them, and the suite runs several workers side by
    side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_rules(monkeypatch):
    with reference_shape_rules(monkeypatch):
        yield


@pytest.fixture
def no_dense_kernels(monkeypatch):
    """The port's dense-cache attention kernels fail if called: the forward
    must take the einsum."""
    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"{name} called where the reference takes the einsum")
        return call

    for name in ("fused_decode_attention", "flash_prefill_attention", "decode_attention"):
        monkeypatch.setattr(tt, name, refuse(name))


def reference_bundle(preset, seed=0, **cfg_kw):
    """A JAX ModelBundle of ``tiny_test_config(**cfg_kw)`` whose weights come
    from numpy: projections packed by the reference's quantize_int4 where
    ``preset`` (a name or a config dict) quantizes their weights,
    everything else in f32."""
    rng = np.random.default_rng(seed)
    cfg = jt.tiny_test_config(dtype=jnp.bfloat16, **cfg_kw)
    module = jt.Decoder(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    qcfg = jget_config(preset) if preset else None
    params, quant = {}, {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            w = rng.standard_normal(leaf.shape).astype(np.float32) / np.sqrt(leaf.shape[0])
            if qcfg is not None and qcfg.resolve("/".join(keys[:-1]) + "/weight_quantizer"):
                quant = set_in(quant, keys[:-1] + ("qweight",), jq.quantize_int4(jnp.asarray(w)))
            else:
                params = set_in(params, keys, jnp.asarray(w))
        elif keys[-1] == "scale":
            params = set_in(params, keys, jnp.asarray(
                1.0 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32))
        else:
            params = set_in(params, keys, jnp.asarray(rng.standard_normal(leaf.shape),
                                                      jnp.float32))
    records = ((ModeRecord("quantize", qcfg, {}), ModeRecord("compress", {}, {}))
               if qcfg is not None else ())
    return ModelBundle(module=module, variables={"params": params, "quant": quant},
                       example_inputs=(ids,), records=records)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_tiny_bf16_cache_takes_the_einsum(reference_rules, no_dense_kernels):
    """``tiny_test_config()`` (D = 16) over a bf16 dense cache: a 16-token
    prefill and one decode step. Neither gate admits D = 16, so both
    packages take the einsum over the cache (the parent sent these forwards
    to K4 and K2, whose CUDA kernels take D = 128 only, so the card raised).
    Logits at the engine tests' bar, greedy choices equal."""
    B, T, S = 2, 16, 64
    jb = reference_bundle(None)
    ids = np.random.default_rng(1).integers(1, 256, (B, T + 1)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    jcache = jt.make_cache(jb.module.cfg, B, S)
    lj0, jcache = fn(jb.variables, jnp.asarray(ids[:, :T]), jcache)
    lj1, _ = fn(jb.variables, jnp.asarray(ids[:, T:]), jcache)
    cfg = tt.tiny_test_config(dtype=torch.bfloat16)
    tb = from_jax_variables(to_numpy(jb.variables), cfg, device="cpu")
    tcache = tt.make_cache(cfg, B, S, device="cpu")
    lt0, tcache = tb.apply(torch.from_numpy(ids[:, :T]), tcache)
    lt1, _ = tb.apply(torch.from_numpy(ids[:, T:]), tcache)
    for got, want in ((lt0[:, -1], lj0[:, -1]), (lt1[:, -1], lj1[:, -1])):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.15)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# one Attention layer's geometry at D = 128 (hidden 256, 2 query heads over
# 1 KV head); bf16 weights and activations, calibrated int8 k / v
# quantizers (INT8_KV_CFG's cache codes alone, so that only attention
# separates the two packages)
KV_INT8_ONLY = {"quant_cfg": {"*weight_quantizer": {"enable": False},
                              "*input_quantizer": {"enable": False},
                              "*output_quantizer": {"enable": False},
                              "*k_quantizer": {"num_bits": 8, "axis": None},
                              "*v_quantizer": {"num_bits": 8, "axis": None}},
                "algorithm": "max"}
WIDE = dict(hidden_size=256, intermediate_size=512, num_layers=1, num_heads=2,
            num_kv_heads=1, fused_qkv=True, fused_gate_up=True, max_position_embeddings=16384)


@pytest.fixture(scope="module")
def int8_layer():
    """The KV_INT8_ONLY reference bundle calibrated by one 32-token forward,
    and the port's bundle on the same variables."""
    jb = reference_bundle(KV_INT8_ONLY, **WIDE)
    ids = jnp.asarray(np.random.default_rng(2).integers(1, 256, (1, 32)), jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, ids, jt.make_cache(jb.module.cfg, 1, 32))
    jb = jb.replace(variables={**jb.variables, "quant": mut["quant"]})
    cfg = tt.tiny_test_config(dtype=torch.bfloat16, **WIDE)
    tb = from_jax_variables(to_numpy(jb.variables), cfg, KV_INT8_ONLY, device="cpu")
    return jb, tb, cfg


def _filled_caches(jb, cfg, S, L, seed):
    """Both packages' int8 caches of S rows holding the same random codes in
    rows [0, L) (keys and values at the calibrated scales), lengths L."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros((1, S, 128), np.int8) for _ in range(2)]
    for r in rows:
        r[0, :L] = rng.integers(-127, 128, (L, 128))
    jcache = jt.make_cache(jb.module.cfg, 1, S, dtype=jnp.int8)
    jcache = {**jcache, "k": (jnp.asarray(rows[0]),), "v": (jnp.asarray(rows[1]),),
              "lengths": jnp.full((1,), L, jnp.int32)}
    tcache = tt.make_cache(cfg, 1, S, dtype=torch.int8, device="cpu")
    tcache = {**tcache, "k": (torch.from_numpy(rows[0].copy()),),
              "v": (torch.from_numpy(rows[1].copy()),),
              "lengths": torch.full((1,), L, dtype=torch.int32)}
    return jcache, tcache


def _two_ulps(want):
    """Two bf16 ulps of the largest logit: the einsum's bar (both packages
    take the same einsum over the same dequantized cache; the bf16 logits
    differ by the last-bit rounding of bf16 sums)."""
    return 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def test_long_int8_cache_decode_takes_the_einsum(int8_layer, reference_rules, monkeypatch):
    """One decode step over an int8 cache of S = 16384 rows holding 9000
    keys. The reference's gates refuse S > 8192 for K2 and K5, so it takes
    the einsum over the dequantized cache; the port now does too.

    Before the repair the port ran K2 here (its plain twin on the CPU:
    q and the probabilities requantized to 8 / 7 bits). Measured on this
    test's inputs: K2's twin sat 0.0625 from the reference's logits (max
    |logit| 3.31, four bf16 ulps); the repaired port sits 0.0156 from them
    (one ulp). The repaired port is held to two ulps, and the old route is
    shown to sit farther away than that."""
    jb, tb, cfg = int8_layer
    S, L = 16384, 9000
    tok = np.array([[7]], np.int32)
    jcache, tcache = _filled_caches(jb, cfg, S, L, seed=3)
    want, _ = jax.jit(jb.make_fn())(jb.variables, jnp.asarray(tok), jcache)
    want = np.asarray(want[:, -1], np.float32)
    got, _ = tb.apply(torch.from_numpy(tok), tcache)
    got = got[:, -1].float().numpy()
    bar = _two_ulps(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)
    # the parent's route: K2's twin, whatever the gate says
    _, tcache = _filled_caches(jb, cfg, S, L, seed=3)
    monkeypatch.setattr(tt, "fused_decode_ok", lambda *a, **k: True)
    old, _ = tb.apply(torch.from_numpy(tok), tcache)
    old_err = np.abs(old[:, -1].float().numpy() - want).max()
    assert old_err > bar, (old_err, bar)


def test_32_row_bucket_takes_the_einsum(int8_layer, reference_rules, no_dense_kernels):
    """A 32-row chunk (the engine's small prefill bucket) against an int8
    cache already holding 100 keys, at D = 128: the reference's
    ``flash_prefill_ok`` refuses T < 64, so both packages write the rows
    and take the einsum over the dequantized cache."""
    jb, tb, cfg = int8_layer
    S, L, T = 256, 100, 32
    ids = np.random.default_rng(4).integers(1, 256, (1, T)).astype(np.int32)
    jcache, tcache = _filled_caches(jb, cfg, S, L, seed=5)
    want, jcache = jax.jit(jb.make_fn())(jb.variables, jnp.asarray(ids), jcache)
    got, tcache = tb.apply(torch.from_numpy(ids), tcache)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_two_ulps(want))
    # the chunk's rows went into the cache at [L, L + T), as the reference wrote them
    np.testing.assert_array_equal(tcache["k"][0].numpy(), np.asarray(jcache["k"][0]))


@pytest.mark.parametrize("gate,args,want", [
    # the served paths: K2 at decode, K4 for the 544-row bucket (S = 2176)
    ("fused", ((8, 8, 4, 128), 2176, torch.int8), True),
    ("fused", ((8, 4, 8, 128), 2176, torch.bfloat16), True),
    ("fused", ((8, 8, 4, 128), 2176, torch.float8_e4m3fn), True),
    ("prefill", (544, 2176, 128, torch.int8), True),
    ("prefill", (544, 2176, 128, torch.bfloat16), True),
    # the reference's rule refuses
    ("fused", ((8, 8, 4, 128), 16384, torch.int8), False),
    ("fused", ((2, 2, 2, 16), 64, torch.bfloat16), False),
    ("prefill", (32, 2176, 128, torch.int8), False),
    ("prefill", (544, 16384, 128, torch.int8), False),
    # the reference admits, the card kernel does not (ROADMAP: head geometry)
    ("fused", ((8, 8, 4, 256), 2176, torch.int8), False),
    ("fused", ((8, 2, 16, 128), 2176, torch.int8), False),
    ("prefill", (544, 2176, 64, torch.bfloat16), False),
    # K14 (uncached forwards): the card kernel's widths, and two the
    # reference admits that it does not
    ("flash", (1024, 1024, 64), True),
    ("flash", (1024, 1024, 128), True),
    ("flash", (1024, 1024, 192), False),
    ("flash", (1024, 1024, 256), False),
])
def test_gates_at_served_and_refused_shapes(gate, args, want):
    fn = {"fused": fused_decode_ok, "prefill": flash_prefill_ok,
          "flash": flash_attention_ok}[gate]
    assert fn(*args) is want


def test_uncached_forward_at_d256_takes_the_einsum(reference_rules, monkeypatch):
    """An uncached 256-token forward at D = 256 (hidden 512, 2 query heads
    over 1 KV head, 1 layer). The reference's ``flash_attention_ok`` admits
    it, so the JAX side runs its flash kernel (interpreted); the port's gate
    refuses the width its card kernel lacks, so the port takes the einsum.
    Before the repair the port sent this forward to K14, whose CUDA wrapper
    raises at D = 256. Logits at the einsum's two-ulp bar."""
    wide = dict(hidden_size=512, intermediate_size=256, num_layers=1, num_heads=2,
                num_kv_heads=1, max_position_embeddings=512)

    def refuse(*a, **k):
        raise AssertionError("flash_attention called at a width its card kernel lacks")

    monkeypatch.setattr(tt, "flash_attention", refuse)
    jb = reference_bundle(None, **wide)
    ids = np.random.default_rng(6).integers(1, 256, (1, 256)).astype(np.int32)
    want, _ = jax.jit(jb.make_fn())(jb.variables, jnp.asarray(ids))
    want = np.asarray(want, np.float32)
    cfg = tt.tiny_test_config(dtype=torch.bfloat16, **wide)
    assert cfg.dims_per_head == 256
    tb = from_jax_variables(to_numpy(jb.variables), cfg, device="cpu")
    got, _ = tb.apply(torch.from_numpy(ids))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_two_ulps(want))


@pytest.mark.parametrize("geometry", [
    dict(num_heads=2, num_kv_heads=1),                 # D = 256
    dict(num_heads=16, num_kv_heads=1, head_dim=128),  # G = 16
], ids=["d256", "g16"])
def test_e4m3_decode_that_k2_turns_away_takes_the_einsum(geometry, monkeypatch):
    """An 8-token prefill and one decode step over an e4m3 dense cache (bf16
    weights: the keys and values go in as direct e4m3 casts), at head
    geometries the reference's K2 admits and the port's card kernel lacks.
    The port's ``fused_decode_ok`` refuses the step and its
    ``decode_attention_ok`` is the reference's rule again (K5's e4m3 branch
    is ported), so the step writes by K3 and attends by K5 (its plain
    version here; K2 and K4 are never called): the reference's chain where
    its K2 says no. Held to the reference along that chain (its
    ``fused_decode_ok`` refused, its K5 interpreted) at two bf16 ulps of the
    largest logit (the same rounding points; a probability whose f32 value
    lands on a bf16 midpoint otherwise could move a logit by one ulp), to
    the reference under its shape rules alone (its K2 interpreted) and on
    its CPU route (the einsum over the dequantized cache) at the engine
    tests' logit bar. The name dates from when the port took the einsum
    here."""
    from modelopt_tpu.kernels import attention as jattention

    wide = dict(hidden_size=512, intermediate_size=256, num_layers=1,
                max_position_embeddings=512, **geometry)
    B, T, S = 1, 8, 256
    jb = reference_bundle(None, **wide)
    cfg = tt.tiny_test_config(dtype=torch.bfloat16, **wide)
    G, D = cfg.num_heads // cfg.num_kv_heads, cfg.dims_per_head
    assert not fused_decode_ok((B, cfg.num_kv_heads, G, D), S, torch.float8_e4m3fn)
    ids = np.random.default_rng(7).integers(1, 256, (B, T + 1)).astype(np.int32)

    def reference():
        fn = jax.jit(jb.make_fn())
        cache = jt.make_cache(jb.module.cfg, B, S, dtype=jnp.float8_e4m3fn)
        _, cache = fn(jb.variables, jnp.asarray(ids[:, :T]), cache)
        logits, _ = fn(jb.variables, jnp.asarray(ids[:, T:]), cache)
        return np.asarray(logits[:, -1], np.float32)

    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"{name} called where the reference's K2 says no")
        return call

    calls = []

    def k5(q, kc, vc, lengths, **kw):
        calls.append((tuple(q.shape), kc.dtype))
        return decode_attention(q, kc, vc, lengths, **kw)

    with monkeypatch.context() as m:
        for name in ("fused_decode_attention", "flash_prefill_attention"):
            m.setattr(tt, name, refuse(name))
        m.setattr(tt, "decode_attention", k5)
        tb = from_jax_variables(to_numpy(jb.variables), cfg, device="cpu")
        tcache = tt.make_cache(cfg, B, S, dtype=torch.float8_e4m3fn, device="cpu")
        _, tcache = tb.apply(torch.from_numpy(ids[:, :T]), tcache)
        got, _ = tb.apply(torch.from_numpy(ids[:, T:]), tcache)
    got = got[:, -1].float().numpy()
    assert np.isfinite(got).all()
    assert calls == [((B, cfg.num_kv_heads, G, D), torch.float8_e4m3fn)]
    with reference_shape_rules(monkeypatch):
        want_k2 = reference()
        monkeypatch.setattr(jattention, "fused_decode_ok", lambda *a, **k: False)
        want_k5 = reference()
    np.testing.assert_allclose(got, want_k5, rtol=0, atol=_two_ulps(want_k5))
    np.testing.assert_allclose(got, want_k2, rtol=0, atol=0.15)
    monkeypatch.undo()
    np.testing.assert_allclose(got, reference(), rtol=0, atol=0.15)
