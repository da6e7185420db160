"""The reference's e4m3 branches of K5 decode_attention (MLA's latent
geometry and the MHA geometries K2 turns away), K15 paged_decode_attention
at D = 640 and K17 block_sparse_decode_attention on the CPU: the port's
plain versions against the JAX package's Pallas kernels in interpret mode;
the e4m3 latent cluster kernel's plan and order of f32 sums modelled in
torch; the e4m3 operand decode of the latent cluster kernel modelled in
numpy on every code; a tiny DeepSeek-V2 under FP8_KV_CFG (an e4m3 latent
cache, dense and paged, and an uncalibrated one of scale 1) and a
skip-softmax llama over an e4m3 cache, each against the reference."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import attention as ja
from modelopt_tpu.kernels import block_sparse_attention as jbs
from modelopt_tpu.kernels import paged_attention as jpa
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu.sparsity.skip_softmax import sparsify_attention_dynamic as jsparsify
from modelopt_tpu_torch.kernels import attention as ta
from modelopt_tpu_torch.kernels import block_sparse_attention as tbs
from modelopt_tpu_torch.kernels import paged_attention as tpa
from modelopt_tpu_torch.models import mla as tm
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.serve import ServingEngine
from modelopt_tpu_torch.sparsity.skip_softmax import sparsify_attention_dynamic
from tests._test_utils.pallas_interpret import pallas_interpreted
from tests.test_torch_cluster_decode import LATENT_LENGTHS
from tests.test_torch_mla import float_bundle, jax_calibrate, port_cfg, to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them, and the suite runs several workers side by
    side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


E4M3 = ml_dtypes.float8_e4m3fn
FP8_KV = "FP8_KV_CFG"
# the e4m3 branch against the interpreted Pallas kernel: f32 sums in
# another order and exp rounded otherwise, so a probability may round to
# the neighbouring bf16 (test_torch_fp8_kv.py's bar for K2 and K15)
KERNEL_TOL = 1e-2


def _codes(rng, shape, spread=48.0):
    """e4m3 codes of N(0, spread^2) values (rounded by ml_dtypes, clipped to
    +-448, so no 0x7f / 0xff NaN code), as a (JAX array, torch tensor) pair
    of the same bytes."""
    x = np.clip(rng.standard_normal(shape) * spread, -448, 448).astype(np.float32)
    raw = x.astype(E4M3).view(np.uint8)
    return (jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.float8_e4m3fn),
            torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn))


def test_cache_pair_decode_is_the_reference_decode_on_every_code():
    """csrc/e4m3.cuh's ``e4m3_cache_pair`` modelled in numpy on all 256
    codes: the code in byte 1 of a word, its exponent and mantissa fields
    shifted into a bf16's (2^-120 times its value, subnormal where the
    exponent field is 0), times 2^120. Bit for bit the reference's bit
    assembly (``e4m3_decode_plain``), 0x7f / 0xff -> +-480 included."""
    c = np.arange(256, dtype=np.uint32)
    r = c << 8
    t = ((r >> 4) & 0x07F0) | (r & 0x8000)
    got = (t << 16).view(np.float32) * np.float32(2.0**120)
    want = ta.e4m3_decode_plain(torch.arange(256, dtype=torch.uint8)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0x7F] == 480.0 and got[0xFF] == -480.0 and got[1] == 2.0**-9


# ---------------------------------------------------------------------------
# the kernels' e4m3 branches: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("geometry", ["mla one chunk", "mla 256-key chunks", "mha g16"])
def test_decode_attention_e4m3_matches_reference(rng, geometry):
    """K5 on e4m3 caches. MLA's geometry (KH = 1, G = 16, D = 640, ONE
    tensor as K and V, lengths 0, 1, 33, 64, 65, 300 and S; S = 520 is one
    chunk of S, S = 512 two chunks of 256 with a running max between them)
    and an MHA geometry K2 turns away (KH = 2, G = 16 at D = 128; the
    model-level gate test takes D = 256 through K5 too):
    bf16 q, codes decoded as the reference decodes them, f32 scores times
    k_scale / sqrt(D), PV from e rounded to bf16, times v_scale. Within
    KERNEL_TOL of the Pallas kernel (interpret mode)."""
    if geometry.startswith("mla"):
        KH, G, D = 1, 16, 640
        S = 520 if geometry == "mla one chunk" else 512
        lengths = np.asarray(LATENT_LENGTHS + [S], np.int32)
    else:
        KH, G, D = 2, 16, 128
        S = 256
        lengths = np.asarray([0, 1, 100, 256], np.int32)
    B = len(lengths)
    q = (rng.standard_normal((B, KH, G, D)) * 2).astype(np.float32)
    kj, kt = _codes(rng, (B, S, KH * D))
    if KH == 1:
        vj, vt, ks, vs = kj, kt, 0.011, 0.011
    else:
        (vj, vt), ks, vs = _codes(rng, (B, S, KH * D)), 0.011, 0.017
    with pltpu.force_tpu_interpret_mode():
        want = ja.decode_attention(jnp.asarray(q, jnp.bfloat16), kj, vj, jnp.asarray(lengths),
                                   k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    got = ta.decode_attention(torch.from_numpy(q).bfloat16(), kt, vt, torch.from_numpy(lengths),
                              k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    assert got.shape == (B, KH, G, D) and torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_paged_latent_e4m3_matches_reference(rng):
    """K15 at MLA's geometry on an e4m3 latent pool (KH = 1, G = 16,
    D = 640, 64-row pages drawn from a pool of 24, a page may recur, the
    pool as K and V): within KERNEL_TOL of the Pallas kernel."""
    G, D, ps, pmax, n_pages = 16, 640, 64, 9, 24
    lengths = np.asarray(LATENT_LENGTHS + [pmax * ps], np.int32)
    B = len(lengths)
    q = (rng.standard_normal((B, 1, G, D)) * 2).astype(np.float32)
    pj, pt = _codes(rng, (n_pages, ps, D))
    table = rng.integers(0, n_pages, (B, pmax)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_decode_attention(jnp.asarray(q, jnp.bfloat16), pj, pj,
                                          jnp.asarray(table), jnp.asarray(lengths),
                                          k_scale=0.011, v_scale=0.011, out_dtype=jnp.float32)
    got = tpa.paged_decode_attention(torch.from_numpy(q).bfloat16(), pt, pt,
                                     torch.from_numpy(table), torch.from_numpy(lengths),
                                     k_scale=0.011, v_scale=0.011, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_block_sparse_e4m3_matches_reference(rng):
    """K17 on e4m3 caches (KH = 2, G = 4, D = 128, 128-row blocks, 4 table
    entries): no live entry, one block, a first block wholly past the
    length before a live one, a block cut by the length, two whole
    blocks. Within KERNEL_TOL of the Pallas kernel."""
    B, KH, G, D, bs, S, nsel = 5, 2, 4, 128, 128, 512, 4
    q = (rng.standard_normal((B, KH, G, D)) * 2).astype(np.float32)
    (kj, kt), (vj, vt) = (_codes(rng, (B, S, KH * D)) for _ in range(2))
    sel = np.asarray([[0, 0, 0, 0], [2, 0, 0, 0], [3, 0, 0, 0], [1, 0, 0, 0], [2, 3, 0, 0]],
                     np.int32)
    nvalid = np.asarray([0, 1, 2, 1, 2], np.int32)
    lengths = np.asarray([300, 400, 200, 200, 512], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jbs.block_sparse_decode_attention(
            jnp.asarray(q, jnp.bfloat16), kj, vj, jnp.asarray(sel), jnp.asarray(nvalid),
            jnp.asarray(lengths), k_scale=0.011, v_scale=0.017, block_size=bs,
            out_dtype=jnp.float32)
    got = tbs.block_sparse_decode_attention(
        torch.from_numpy(q).bfloat16(), kt, vt, torch.from_numpy(sel), torch.from_numpy(nvalid),
        torch.from_numpy(lengths), k_scale=0.011, v_scale=0.017, block_size=bs,
        out_dtype=torch.float32)
    assert nsel == sel.shape[1] and torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)


def latent_cluster_decode_e4m3(q, cache, lengths, k_scale, v_scale, chunk):
    """The e4m3 instance of the latent cluster kernel
    (csrc/latent_decode.cuh) for every slot of one e4m3 latent tensor
    [B, S, D] as K and V, split as ``latent_plan`` says: f32 scores; per
    round the running max at each chunk from all pieces' maxima in order;
    each piece's e = exp(s - m_c) in f32, its esum, and its PV from e
    rounded to bf16 in f32, summed per rank over its pieces of one chunk (a
    segment); the owner sums a chunk's segments and esums in rank order,
    then l = l alpha + esum, acc = acc alpha + y. f32 out."""
    B, _, G, D = q.shape
    S = cache.shape[1]
    ks, vs = (ta._scalar(t, "cpu") for t in (k_scale, v_scale))
    vals = ta.e4m3_decode_plain(cache)                                   # [B, S, D]
    inv_sqrt_d = ks / torch.sqrt(torch.tensor(float(D)))
    scores = torch.einsum("bgd,bsd->bgs", q[:, 0].to(torch.bfloat16).float(), vals) * inv_sqrt_d
    out = torch.empty(B, 1, G, D)
    for b in range(B):
        L = max(min(int(lengths[b]), S), 0)
        s, vb = scores[b], vals[b]
        m_prev = torch.full((G,), -1e30)
        m, l, acc = torch.full((G, 1), -1e30), torch.zeros(G, 1), torch.zeros(G, D)
        for rnd in ta.latent_plan(L, chunk):
            order = [p for held in rnd for p in held]
            cm = {}
            for i, (c, lo, hi) in enumerate(order):
                m_prev = torch.maximum(m_prev, s[:, lo:hi].amax(-1))
                if i == len(order) - 1 or order[i + 1][0] != c:
                    cm[c] = m_prev
            segments = []  # (chunk, esum, f32 partial) of each rank, rank by rank
            for held in rnd:
                for c, lo, hi in held:
                    e = torch.exp(s[:, lo:hi] - cm[c][:, None])
                    es, y = e.sum(-1), e.to(torch.bfloat16).float() @ vb[lo:hi]
                    if segments and segments[-1][0] == c and held[0] != (c, lo, hi):
                        segments[-1] = (c, segments[-1][1] + es, segments[-1][2] + y)
                    else:
                        segments.append((c, es, y))
            for c in sorted(cm):
                t = torch.zeros(G, D)
                es = torch.zeros(G)
                for cc, e, y in segments:
                    if cc == c:
                        t, es = t + y, es + e
                mc = cm[c][:, None]
                alpha = torch.exp(m - mc)
                l = l * alpha + es[:, None]
                acc = acc * alpha + t
                m = mc
        out[b, 0] = acc * (vs / l.clamp_min(1e-30))
    return out


@pytest.mark.parametrize("S", [520, 512])
def test_latent_e4m3_split_matches_reference(rng, S):
    """MLA's geometry on one e4m3 latent tensor split as the latent cluster
    kernel splits it (one chunk of 520 keys; two chunks of 256): within
    1e-5 of the port's plain version (the same f32 scores and bf16
    probabilities, f32 sums in another order: outputs ~0.5, f32 rounding
    ~1e-7 a sum) and within KERNEL_TOL of the Pallas kernel (interpret
    mode); an empty slot gives 0."""
    G, D, sc = 16, 640, 0.011
    lengths = np.asarray(LATENT_LENGTHS + [S], np.int32)
    B = len(lengths)
    q = (rng.standard_normal((B, 1, G, D)) * 2).astype(np.float32)
    cj, ct = _codes(rng, (B, S, D))
    tq, tl = torch.from_numpy(q).bfloat16(), torch.from_numpy(lengths)
    got = latent_cluster_decode_e4m3(tq, ct, tl, sc, sc, ta._decode_chunk(S, 256))
    want = ta.decode_attention_plain(tq, ct, ct, tl, sc, sc, out_dtype=torch.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = ja.decode_attention(jnp.asarray(q, jnp.bfloat16), cj, cj, jnp.asarray(lengths),
                                  k_scale=sc, v_scale=sc, out_dtype=jnp.float32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=KERNEL_TOL, atol=KERNEL_TOL)


# ---------------------------------------------------------------------------
# models: DeepSeek-V2 over an e4m3 latent cache, a skip-softmax llama over e4m3 KV
# ---------------------------------------------------------------------------
# the small compressed MLA config with every FP8 GEMM a whole number of the
# reference's 128-column tiles (its wfp8_gemm runs interpreted): r = 192 and
# dr = 64 (a 256-wide latent row); one MoE layer (4 experts of width 384,
# 2 shared), to keep the reference's interpreted compiles short
MLA_FP8 = dict(kv_lora_rank=192, num_layers=1, first_k_dense=0)
B, T, STEPS, S = 2, 8, 3, 32


@pytest.fixture(scope="module")
def mla_fp8():
    """The small MLA model under FP8_KV_CFG (e4m3 weights, static e4m3
    activations, e4m3 k quantizer) compressed by the reference's
    ``compress`` and calibrated by one JAX forward; the port's copy."""
    tcfg = port_cfg(torch.float32, **MLA_FP8)
    jb = jax_calibrate(jcompress(float_bundle(tcfg, FP8_KV, jnp.float32, seed=6,
                                              lm_scale=4.0)))
    return jb, from_jax_variables(to_numpy(jb.variables), tcfg, FP8_KV, device="cpu"), tcfg


def _teacher_forced(apply, cache, ids, to_np):
    out, cache = apply(ids[:, :T], cache)
    rows = [to_np(out[:, -1])]
    for t in range(STEPS):
        out, cache = apply(ids[:, T + t:T + t + 1], cache)
        rows.append(to_np(out[:, -1]))
    return np.stack(rows), cache


@pytest.mark.parametrize("calibrated", [True, False], ids=["fp8_kv", "uncalibrated"])
def test_mla_e4m3_latent_logits_match_reference(mla_fp8, monkeypatch, calibrated):
    """Prefill then teacher-forced decode over an e4m3 latent cache. FP8_KV:
    the k quantizer's e4m3 codes and scale; the reference with its K5 and
    its GEMMs interpreted (``pallas_interpreted(prefill_and_gemms=True)``),
    the port through K5's and K8's plain versions: within 1e-3 of the
    logits (f32 model, the two agree to ~5e-5). Uncalibrated: the f32
    model with no quantizer, its latent rows cast to e4m3 with scale 1 (the
    reference's rule), against the reference's K5 at 1e-3 too. The decode
    steps run K5 (its plain version), and the cache holds e4m3 codes."""
    if calibrated:
        jb, tb, tcfg = mla_fp8
    else:
        tcfg = tt.tiny_mla_test_config(dtype=torch.float32)
        jb = float_bundle(tcfg, None, jnp.float32, seed=6, lm_scale=4.0)
        tb = from_jax_variables(to_numpy(jb.variables), tcfg, device="cpu")
    calls = []

    def spy(q, kc, vc, lengths, **kw):
        calls.append((kc.dtype, kc is vc, float(kw["k_scale"])))
        return ta.decode_attention(q, kc, vc, lengths, **kw)

    monkeypatch.setattr(tm, "decode_attention", spy)
    ids = np.random.default_rng(3).integers(1, tcfg.vocab_size, (B, T + STEPS)).astype(np.int32)
    got, tcache = _teacher_forced(tb.apply, tt.make_cache(tcfg, B, S, dtype=torch.float8_e4m3fn,
                                                          device="cpu"),
                                  torch.from_numpy(ids), lambda x: x.float().numpy())
    with pallas_interpreted(monkeypatch, prefill_and_gemms=calibrated):
        fn = jax.jit(jb.make_fn())
        want, _ = _teacher_forced(lambda i, c: fn(jb.variables, jnp.asarray(i), c),
                                  jt.make_cache(jb.module.cfg, B, S, dtype=jnp.float8_e4m3fn),
                                  ids, lambda x: np.asarray(x, np.float32))
    assert all(t.dtype == torch.float8_e4m3fn for t in tcache["k"])
    assert len(calls) == STEPS * tcfg.num_layers and all(
        c[0] == torch.float8_e4m3fn and c[1] for c in calls)
    assert calibrated or all(c[2] == 1.0 for c in calls)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# numpy seed 5; the third prompt arrives after two ticks. Every greedy
# choice on these prompts is at least 0.11 above its runner-up in
# log-probability (the port's Decoder, one prompt at a time), where the
# two packages agree to ~1e-4.
PROMPT_LENS = (5, 12, 3)


def test_mla_e4m3_latent_pages_greedy_tokens_match_reference_engine(mla_fp8, monkeypatch):
    """Three staggered requests through both engines over e4m3 latent pools
    of 8-row pages (one prefill bucket, 4 new tokens each, to keep the
    reference's interpreted compile short; the dense cache is held at the
    logits above): the reference with its K15, K16 and GEMMs interpreted,
    the port through K15's and K16's plain versions. The same tokens and
    stop reasons, log-probs within 1e-3, every pool e4m3, every page back
    in the pool."""
    jb, tb, tcfg = mla_fp8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16,), max_admit=1, paged=True,
              page_size=8, kv_pages=13)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=4) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=4))
        engine.run()
        return reqs

    with pallas_interpreted(monkeypatch, prefill_and_gemms=True):
        want = serve(JaxEngine(jb, kv_dtype=jnp.float8_e4m3fn, **kw))
    teng = ServingEngine(tb, device="cpu", kv_dtype=torch.float8_e4m3fn, **kw)
    got = serve(teng)
    assert all(t.dtype == torch.float8_e4m3fn for t in teng.cache["k"])
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=1e-3)
    assert teng.allocator.free_pages == 12


def test_skip_softmax_e4m3_decode_matches_reference(monkeypatch):
    """A 1-layer f32 llama (D = 128, 2 KV heads, G = 2) with skip-softmax
    over 64-row blocks and an e4m3 KV cache (no quantizer: keys and values
    cast, scale 1): a 160-token prefill then 3 decode steps, teacher
    forced. The block summaries hold the keys' real values (codes times
    k_scale) and every decode step attends the selected blocks through K17
    (its plain version here; the reference's interpreted kernel under its
    shape rule). Logits within 1e-4 (f32, the packages agree to ~1e-6);
    the cache holds e4m3 codes."""
    cfg_kw = dict(vocab_size=256, hidden_size=256, num_layers=1, num_heads=4, num_kv_heads=2,
                  head_dim=128, intermediate_size=256, max_position_embeddings=512)
    tcfg = tt.tiny_test_config(dtype=torch.float32, **cfg_kw)
    jb0 = float_bundle(tcfg, None, jnp.float32, seed=2)
    ss = dict(block_size=64, tau=2.0, budget=0.5)
    jb = jsparsify(jb0, **ss)
    tb = sparsify_attention_dynamic(from_jax_variables(to_numpy(jb0.variables), tcfg,
                                                       device="cpu"), **ss)
    calls = []

    def spy(q, kc, vc, sel, nvalid, lengths, **kw):
        calls.append((kc.dtype, nvalid.tolist()))
        return tbs.block_sparse_decode_attention(q, kc, vc, sel, nvalid, lengths, **kw)

    monkeypatch.setattr(tt, "block_sparse_decode_attention", spy)
    n, steps, maxlen = 160, 3, 256
    ids = np.random.default_rng(4).integers(1, 256, (2, n + steps)).astype(np.int32)

    def run(apply, cache, to_np, wrap):
        out, cache = apply(wrap(ids[:, :n]), cache)
        rows = [to_np(out[:, -1])]
        for t in range(steps):
            out, cache = apply(wrap(ids[:, n + t:n + t + 1]), cache)
            rows.append(to_np(out[:, -1]))
        return np.stack(rows), cache

    got, tcache = run(tb.apply, tt.make_cache(tb.module.cfg, 2, maxlen, torch.float8_e4m3fn,
                                              device="cpu"),
                      lambda x: x.float().numpy(), torch.from_numpy)
    with pallas_interpreted(monkeypatch):
        fn = jax.jit(jb.make_fn())
        want, _ = run(lambda i, c: fn(jb.variables, i, c),
                      jt.make_cache(jb.module.cfg, 2, maxlen, dtype=jnp.float8_e4m3fn),
                      lambda x: np.asarray(x, np.float32), jnp.asarray)
    assert tcache["k"][0].dtype == torch.float8_e4m3fn
    assert len(calls) == steps and all(c[0] == torch.float8_e4m3fn for c in calls)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
