"""FP8_KV_CFG on the CPU: e4m3 KV caches in the port against the JAX
package. The e4m3 decode on every code, the k / v quantizers' e4m3 codes,
the twins of K2 fused_decode_attention, K4 flash_prefill_attention (also at
the served head geometry) and K15 paged_decode_attention on e4m3 caches
against the interpreted Pallas kernels, K3 / K16 writing e4m3 rows, and
both serving engines (dense and paged e4m3 caches) token for token, the
reference decoding through its interpret-mode kernels. The e4m3 branches no path runs yet (K5, K17, the
MLA latent cache) stay refused."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.kernels import attention as ja
from modelopt_tpu.kernels import flash_attention as jf
from modelopt_tpu.kernels import paged_attention as jpa
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.nn.quantizer import TensorQuantizer as JQuantizer
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.kernels import attention as ta
from modelopt_tpu_torch.kernels import flash_attention as tf
from modelopt_tpu_torch.kernels import paged_attention as tpa
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.nn.quantizer import TensorQuantizer, quantization_active
from modelopt_tpu_torch.quant.config import get_config
from modelopt_tpu_torch.serve import ServingEngine
from tests._test_utils.pallas_interpret import pallas_interpreted
from tests.test_torch_flash_attention import PREFILL_SERVED


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


FP8_KV = "FP8_KV_CFG"
E4M3 = ml_dtypes.float8_e4m3fn


def _codes(rng, shape, spread=48.0):
    """e4m3 codes of N(0, spread^2) values (rounded by ml_dtypes, clipped to
    +-448, so no 0x7f / 0xff NaN code), as a (JAX array, torch tensor) pair
    of the same bytes."""
    x = np.clip(rng.standard_normal(shape) * spread, -448, 448).astype(np.float32)
    raw = x.astype(E4M3).view(np.uint8)
    return (jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.float8_e4m3fn),
            torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def test_e4m3_decode_matches_reference_on_every_code():
    """All 256 codes through the twin (and the wrapper on a CPU tensor)
    against the reference's ``_e4m3_to_bf16``, bit for bit: -0 for 0x80,
    subnormals, and +-480 for 0x7f / 0xff where a float8_e4m3fn cast gives
    NaN."""
    raw = np.arange(256, dtype=np.uint8)
    want = np.asarray(ja._e4m3_to_bf16(
        jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.float8_e4m3fn)).astype(jnp.float32))
    codes = torch.from_numpy(raw).view(torch.float8_e4m3fn)
    for got in (ta.e4m3_decode_plain(codes), ta.e4m3_decode(codes)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert got[0x7F] == 480.0 and got[0xFF] == -480.0
    assert torch.isnan(codes.float()[0x7F])  # the cast the twins avoid


@pytest.mark.parametrize("amax", [0.37, 3.0, 700.0])
def test_quantizer_e4m3_codes_match_reference(rng, amax):
    """The k / v quantizer's real codes under FP8_KV_CFG (calibrated amax,
    QUANT phase, ``with_scale``): scale max(amax, 1e-12)/448 and e4m3 codes
    of clip(x/scale, -448, 448), against the reference TensorQuantizer of
    the same spec, bit for bit; values past amax saturate at 448."""
    x = (rng.standard_normal((4, 3, 64)) * amax / 2).astype(np.float32)
    jq = JQuantizer(fixed_spec=JSpec(num_bits=(4, 3), axis=None))
    jcodes, jscale = jq.apply({"quant": {"amax": jnp.float32(amax)}}, jnp.asarray(x),
                              with_scale=True)
    tq = TensorQuantizer()
    tq.path = "layers_0/attn/k_quantizer"
    tq.amax = torch.tensor(amax)
    with quantization_active(get_config(FP8_KV)):
        tcodes, tscale = tq(torch.from_numpy(x), with_scale=True)
    assert tcodes.dtype == torch.float8_e4m3fn and tcodes.shape == x.shape
    np.testing.assert_array_equal(
        _bits(tcodes), np.asarray(jax.lax.bitcast_convert_type(jcodes, jnp.uint8)))
    assert tscale.dtype == torch.float32 and float(tscale) == float(jscale)


@pytest.mark.parametrize("S", [512, 96])   # 256-key chunks / one chunk of S
def test_fused_decode_e4m3_plain_matches_pallas(rng, interp, S):
    """K2 on e4m3 caches: the caches (the new row written as raw e4m3
    bytes) bit-exact; the output within the reference suite's 1e-2
    (test_attention.py:53-70) of the Pallas kernel, which shares every
    rounding point (bf16 q, codes decoded by bit assembly, f32 scores times
    k_scale/sqrt(D), bf16 probabilities into PV, v_scale last)."""
    B, KH, G, D = 2, 2, 4, 64
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    (kj, kt), (vj, vt), (knj, knt), (vnj, vnt) = (
        _codes(rng, sh) for sh in [(B, S, KH * D)] * 2 + [(B, 1, KH * D)] * 2)
    ks, vs = 0.011, 0.017
    pos = np.asarray([S // 3, S - 2], np.int32)
    oj, ckj, cvj = ja.fused_decode_attention(jnp.asarray(q), knj, vnj, kj, vj, jnp.asarray(pos),
                                             k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    ot, ckt, cvt = ta.fused_decode_attention(torch.from_numpy(q), knt, vnt, kt, vt,
                                             torch.from_numpy(pos), k_scale=ks, v_scale=vs,
                                             out_dtype=torch.float32)
    assert ckt.dtype == torch.float8_e4m3fn
    for got, want in ((ckt, ckj), (cvt, cvj)):
        np.testing.assert_array_equal(_bits(got),
                                      np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint8)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-2, atol=1e-2)


def test_flash_prefill_e4m3_plain_matches_pallas(rng, interp):
    """K4 on e4m3 caches: (code * scale in f32) rounded to bf16 once per
    element, then the bf16 path; within the reference suite's 1e-2 of the
    Pallas kernel, chunks starting past 0."""
    B, T, KH, G, D, S = 2, 64, 2, 2, 64, 256
    q = rng.standard_normal((B, T, KH, G, D)).astype(np.float32)
    start = np.asarray([32, 100], np.int32)
    (ckj, ckt), (cvj, cvt) = (_codes(rng, (B, S, KH * D)) for _ in range(2))
    ks, vs = 0.011, 0.017
    want = jf.flash_prefill_attention(jnp.asarray(q), ckj, cvj, jnp.asarray(start),
                                      k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    got = tf.flash_prefill_attention(torch.from_numpy(q), ckt, cvt, torch.from_numpy(start),
                                     k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    assert got.shape == (B, T, KH, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("geom", list(PREFILL_SERVED.values()), ids=list(PREFILL_SERVED))
def test_flash_prefill_e4m3_served_geometry(rng, interp, geom):
    """K4 on e4m3 caches at the served head geometry (D = 128, G = 4 and 8):
    a chunk at start 0, one that ends at the cache's last row, ragged row
    counts; the same 1e-2 of the Pallas kernel."""
    T, KH, G, D, S, starts = geom
    B = 2
    q = rng.standard_normal((B, T, KH, G, D)).astype(np.float32)
    start = np.asarray(starts, np.int32)
    (ckj, ckt), (cvj, cvt) = (_codes(rng, (B, S, KH * D)) for _ in range(2))
    ks, vs = 0.011, 0.017
    want = jf.flash_prefill_attention(jnp.asarray(q), ckj, cvj, jnp.asarray(start),
                                      k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    got = tf.flash_prefill_attention(torch.from_numpy(q), ckt, cvt, torch.from_numpy(start),
                                     k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    assert got.shape == (B, T, KH, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("D", [128, 256])
def test_paged_decode_e4m3_plain_matches_pallas(rng, interp, D):
    """K15 on e4m3 pools (16-row pages scattered over the pool, lengths of
    one key, a ragged middle and the whole table): the same arithmetic as
    K2's e4m3 branch page by page, within 1e-2 of the Pallas kernel."""
    B, KH, G, PS, PMAX, N_PAGES = 3, 2, 4, 16, 4, 16
    lengths = np.asarray([1, 23, PMAX * PS], np.int32)
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    (kj, kt), (vj, vt) = (_codes(rng, (N_PAGES, PS, KH * D)) for _ in range(2))
    pt = np.zeros((B, PMAX), np.int32)
    ids = rng.permutation(np.arange(1, N_PAGES))
    for b, L in enumerate(lengths):
        used = -(-int(L) // PS)
        pt[b, :used] = ids[b * PMAX:b * PMAX + used]
    ks, vs = 0.011, 0.017
    oj = jpa.paged_decode_attention(jnp.asarray(q, jnp.bfloat16), kj, vj, jnp.asarray(pt),
                                    jnp.asarray(lengths), k_scale=ks, v_scale=vs,
                                    out_dtype=jnp.float32)
    ot = tpa.paged_decode_attention(torch.from_numpy(q).bfloat16(), kt, vt,
                                    torch.from_numpy(pt), torch.from_numpy(lengths),
                                    k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    assert ot.shape == (B, KH, G, D) and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-2, atol=1e-2)


def test_kv_writes_copy_e4m3_rows(rng):
    """K3 and K16 on e4m3 rows: the reference's writes, byte for byte."""
    (cj, ct), (vj, vt) = _codes(rng, (2, 64, 128)), _codes(rng, (2, 8, 128))
    st = np.asarray([3, 60], np.int32)  # 60 + 8 > 64: clamped
    want = ja.dense_kv_write(cj, vj, jnp.asarray(st))
    got = ta.dense_kv_write(ct.clone(), vt, torch.from_numpy(st))
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint8)))
    (pj, pt_), (rj, rt) = _codes(rng, (6, 8, 128)), _codes(rng, (2, 3, 128))
    pids = np.asarray([[1, 1, 4], [2, 5, 5]], np.int32)
    offs = np.asarray([[0, 7, 3], [6, 1, 2]], np.int32)
    want = jpa.paged_kv_write(pj, rj, jnp.asarray(pids), jnp.asarray(offs))
    got = tpa.paged_kv_write(pt_.clone(), rt, torch.from_numpy(pids), torch.from_numpy(offs))
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint8)))


def test_unported_e4m3_branches_raise(rng):
    """The reference's e4m3 branches the port once refused now run on the
    CPU and match: K5 (read-only decode attention) and K17 (block-sparse
    decode attention) on e4m3 caches give their plain versions, which
    decode the codes as the reference does (the e4m3 codes' values, scaled,
    through the same function on a bf16 cache of those exact values: e4m3
    is exact in bf16); and an MLA model writes an e4m3 latent cache (a cast,
    scale 1, with no calibrated quantizer) and decodes over it through K5.
    The name dates from when the port refused them;
    tests/test_torch_e4m3_branches.py holds them to the JAX package."""
    from modelopt_tpu_torch.kernels import block_sparse_attention as tb
    from modelopt_tpu_torch.models import mla as tm

    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 128)).astype(np.float32))
    _, c = _codes(rng, (2, 256, 128))
    vals = ta.e4m3_decode_plain(c).to(torch.bfloat16)
    n = torch.tensor([1, 200], dtype=torch.int32)
    sel, nv = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32), torch.tensor([1, 2],
                                                                              dtype=torch.int32)
    for got, want in ((ta.decode_attention(q, c, c, n, 0.5, 0.25, out_dtype=torch.float32),
                       ta.decode_attention(q * 0.5, vals, vals, n, out_dtype=torch.float32)
                       * 0.25),
                      (tb.block_sparse_decode_attention(q, c, c, sel, nv, n, 0.5, 0.25,
                                                        block_size=128, out_dtype=torch.float32),
                       tb.block_sparse_decode_attention(q * 0.5, vals, vals, sel, nv, n,
                                                        block_size=128,
                                                        out_dtype=torch.float32) * 0.25)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    cfg = tt.tiny_mla_test_config(dtype=torch.float32)
    model = tt.Decoder(cfg, device="cpu")
    for p in model.parameters():
        p.data.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
                     * 0.1)
    cache = tt.make_cache(cfg, 1, 16, dtype=torch.float8_e4m3fn, device="cpu")
    calls = []
    real = tm.decode_attention
    tm.decode_attention = lambda *a, **k: calls.append(a[1].dtype) or real(*a, **k)
    try:
        _, cache = model(torch.ones(1, 4, dtype=torch.int32), cache)
        out, cache = model(torch.ones(1, 1, dtype=torch.int32), cache)
    finally:
        tm.decode_attention = real
    assert torch.isfinite(out).all() and cache["k"][0].dtype == torch.float8_e4m3fn
    assert calls == [torch.float8_e4m3fn] * cfg.num_layers


def test_e4m3_caches_go_to_the_kernels_off_cpu():
    """Off the CPU an e4m3 cache reaches the CUDA kernels' own checks
    (here, with no card, they refuse meta tensors): no wrapper dequantizes
    it for the bf16 branch first."""
    meta = dict(device="meta")
    q = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16, **meta)
    c = torch.zeros(1, 256, 128, dtype=torch.float8_e4m3fn, **meta)
    row = torch.zeros(1, 1, 128, dtype=torch.float8_e4m3fn, **meta)
    pos = torch.zeros(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="fused_decode_attention: all tensors must be on"):
        ta.fused_decode_attention(q, row, row, c, c, pos, 0.5, 0.5)
    q5 = torch.zeros(1, 4, 1, 4, 128, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="flash_prefill_attention: all tensors must be on"):
        tf.flash_prefill_attention(q5, c, c, pos, 0.5, 0.5)
    with pytest.raises(ValueError, match="e4m3_decode: all tensors must be on"):
        ta.e4m3_decode(c)


# ---------------------------------------------------------------------------
# end to end: the reference's FP8_KV_CFG model in both engines
# ---------------------------------------------------------------------------
# tiny_test_config at the attention kernels' head_dim, fused projections as
# paths K and L
TINY = dict(vocab_size=512, hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128,
            intermediate_size=512, max_position_embeddings=256, fused_qkv=True,
            fused_gate_up=True)


def reference_pair(seed=6):
    """The reference bundle under FP8_KV_CFG: f32 weights drawn from numpy
    (kernels N(0, 1/fin) with a 4x lm_head, norm scales 1 + 0.1 N(0, 1),
    the embedding N(0, 1)), compressed by the reference's ``compress`` (e4m3
    weights) and calibrated by one JAX forward (the static e4m3 activations'
    and the k / v quantizers' amax); and the port's copy of it."""
    tcfg = tt.tiny_test_config(dtype=torch.float32, **TINY)
    names = [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]
    module = jt.Decoder(jt.DecoderConfig(dtype=jnp.float32,
                                         **{n: getattr(tcfg, n) for n in names}))
    rng = np.random.default_rng(seed)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
            if "lm_head" in keys:
                arr = arr * 4.0
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    jb = jcompress(ModelBundle(module=module, variables={"params": params},
                               example_inputs=(ids,),
                               records=(ModeRecord("quantize", jget_config(FP8_KV), {}),)))
    cal = jnp.asarray(np.random.default_rng(1).integers(1, 512, (2, 8)), jnp.int32)
    calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
    _, mut = calfn(jb.variables, cal, jt.make_cache(jb.module.cfg, 2, 32))
    jb = jb.replace(variables={**jb.variables, "quant": mut["quant"]})
    tb = from_jax_variables(jax.tree.map(np.asarray, jb.variables), tcfg, FP8_KV, device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    return reference_pair()


def test_kv_amax_carried(pair):
    """Every layer's k and v quantizer holds the reference's calibrated
    amax after ``from_jax_variables``."""
    jb, tb = pair
    mods = {m.path: m for m in tb.module.modules()}
    for i in range(tb.module.cfg.num_layers):
        for name in ("k_quantizer", "v_quantizer"):
            path = f"layers_{i}/attn/{name}"
            want = np.asarray(jb.variables["quant"][f"layers_{i}"]["attn"][name]["amax"])
            assert mods[path].amax is not None
            np.testing.assert_array_equal(mods[path].amax.numpy(), want)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_match_reference_engine(pair, monkeypatch, paged):
    """Three staggered requests (numpy seed 5; the second streams in chunks
    of 16 + 4, the third arrives after two ticks) through both engines with
    e4m3 KV caches (dense, or pools of 8-row pages), f32 model dtype, the
    reference through its interpret-mode Pallas kernels (K2 / K4 dense, K15
    paged, K8 for the e4m3 weights): the same tokens and stop reasons,
    log-probs within 0.15, the caches e4m3 on both sides."""
    jb, tb = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 20, 3)]
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)
    if paged:
        kw.update(paged=True, page_size=8, kv_pages=13)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=6))
        engine.run()
        return reqs

    with pallas_interpreted(monkeypatch, prefill_and_gemms=True):
        jeng = JaxEngine(jb, kv_dtype=jnp.float8_e4m3fn, **kw)
        want = serve(jeng)
    teng = ServingEngine(tb, device="cpu", kv_dtype=torch.float8_e4m3fn, **kw)
    got = serve(teng)
    assert jeng.cache["k"][0].dtype == jnp.float8_e4m3fn
    assert all(t.dtype == torch.float8_e4m3fn for t in teng.cache["k"] + teng.cache["v"])
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.15)
    if paged:
        assert teng.allocator.free_pages == 12
