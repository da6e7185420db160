"""Calibrated skip-softmax decode attention: the port's
``sparsity/skip_softmax.py`` and the decoder's skip-softmax cache held
against the JAX package on numpy inputs: block summaries (chunked writes,
writes past the last block), Quest bounds (with the -inf overflow of
unwritten blocks), block selection (tied and forced blocks, an empty slot),
RULER needle ids, threshold calibration (through K14 on a D = 128 model),
the mode record, and prefill + greedy decode through K17 in f32 and with an
int8 KV cache; the serving engine's refusal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._test_utils.pallas_interpret import pallas_interpreted
from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.sparsity import skip_softmax as js
from modelopt_tpu_torch.core.bundle import apply_mode
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.serve import ServingEngine
from modelopt_tpu_torch.sparsity import skip_softmax as ts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a kernel wrapper the decoder
    imported) in a list."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


# --------------------------------------------------------------------------
# summaries, bounds, selection
# --------------------------------------------------------------------------
def test_summaries_match_bit_for_bit(rng):
    """Chunked prefill writes and single-token writes fold into the same
    min / max summaries; a write running past the last block is dropped."""
    B, S, KH, D, bs = 2, 128, 2, 16, 32
    k = rng.standard_normal((B, S + 8, KH, D)).astype(np.float32)
    jmax, jmin = js.init_block_summaries(B, S, KH, D, bs)
    tmax, tmin = ts.init_block_summaries(B, S, KH, D, bs, device="cpu")
    # per-slot starts differ; the last write of slot 1 runs 8 rows past S
    writes = (((0, 0), 40), ((40, 40), 57), ((97, 97), 1), ((98, 128), 8))
    for (s0, s1), n in writes:
        start = np.asarray([s0, s1], np.int32)
        kn = np.stack([k[0, s0:s0 + n], k[1, s1:s1 + n]])
        jmax, jmin = js.update_block_summaries(jmax, jmin, jnp.asarray(kn),
                                               jnp.asarray(start), bs)
        out = ts.update_block_summaries(tmax, tmin, _t(kn), _t(start), bs)
        assert out[0] is tmax and out[1] is tmin  # in place
    assert np.array_equal(tmax.numpy(), np.asarray(jmax))
    assert np.array_equal(tmin.numpy(), np.asarray(jmin))


def _summaries(rng, B, nb, KH, D, written):
    """Block summaries of random keys for the first ``written[b]`` blocks of
    slot b, the initial -/+3e38 elsewhere."""
    kmax = np.full((B, nb, KH, D), -3e38, np.float32)
    kmin = np.full((B, nb, KH, D), 3e38, np.float32)
    for b, n in enumerate(written):
        kb = rng.standard_normal((n, 16, KH, D)).astype(np.float32)
        kmax[b, :n], kmin[b, :n] = kb.max(1), kb.min(1)
    return kmax, kmin


def test_upper_bounds_match_with_overflow(rng):
    """Finite bounds within f32 summation order; an unwritten block's
    -/+3e38 summaries overflow to -inf in both packages, never NaN."""
    B, nb, KH, G, D = 3, 8, 2, 4, 32
    kmax, kmin = _summaries(rng, B, nb, KH, D, (8, 5, 0))
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    q[2] = -np.abs(q[2])  # all-negative q: only the kmin product overflows
    want = np.asarray(js.block_upper_bounds(jnp.asarray(q), jnp.asarray(kmax),
                                            jnp.asarray(kmin)))
    got = ts.block_upper_bounds(_t(q), _t(kmax), _t(kmin)).numpy()
    assert not np.isnan(got).any()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[1, 5:]).all() and np.isneginf(got[2]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tau,budget,sink,recent", [(1.0, 0.5, 1, 2), (4.0, 0.25, 2, 1),
                                                    (1e9, 1.0, 1, 2), (0.0, 0.3, 0, 0)])
def test_selection_matches_with_ties(rng, tau, budget, sink, recent):
    """Equal ``sel`` and ``nvalid``: slots whose blocks repeat (every bound
    tied), forced sink / recent blocks (all scoring +inf, ordered by
    index), a prompt that was never summarized (-inf bounds in range), an
    empty slot, and lengths in the middle of a block."""
    B, nb, KH, G, D, bs = 5, 8, 2, 2, 16, 16
    kmax, kmin = _summaries(rng, B, nb, KH, D, (8, 8, 6, 0, 8))
    kmax[1, :], kmin[1, :] = kmax[1, 2], kmin[1, 2]        # slot 1: all blocks tied
    kmax[4, 3], kmin[4, 3] = kmax[4, 6], kmin[4, 6]        # slot 4: one tied pair
    kmax[2, :4], kmin[2, :4] = -3e38, 3e38                 # slot 2: prompt unsummarized
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    lengths = np.asarray([128, 100, 90, 0, 119], np.int32)
    cfg = dict(block_size=bs, tau=tau, budget=budget, sink_blocks=sink, recent_blocks=recent)
    js_sel, js_n = js.select_blocks(jnp.asarray(q), jnp.asarray(kmax), jnp.asarray(kmin),
                                    jnp.asarray(lengths), js.SkipSoftmaxConfig(**cfg))
    sel, n = ts.select_blocks(_t(q), _t(kmax), _t(kmin), _t(lengths),
                              ts.SkipSoftmaxConfig(**cfg))
    assert sel.dtype == torch.int32 and n.dtype == torch.int32
    assert np.array_equal(n.numpy(), np.asarray(js_n))
    assert np.array_equal(sel.numpy(), np.asarray(js_sel))


def test_ruler_needle_ids_match():
    want = js.ruler_needle_batches(1000, num_batches=2, batch_size=3, seq_len=256, seed=5)
    got = ts.ruler_needle_batches(1000, num_batches=2, batch_size=3, seq_len=256, seed=5,
                                  device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# models: hidden 512, 4 heads and 2 KV heads of D = 128, 2 layers
# --------------------------------------------------------------------------
WIDE = dict(hidden_size=512, num_heads=4, num_kv_heads=2, intermediate_size=1024,
            max_position_embeddings=512)
KV_INT8 = {"quant_cfg": {"*k_quantizer": {"num_bits": 8, "axis": None},
                         "*v_quantizer": {"num_bits": 8, "axis": None}},
           "algorithm": "max"}


def _reference(dtype=jnp.float32, qcfg=None):
    """A JAX f32 Decoder initialised from PRNGKey(0), as a bundle (with a
    quantize record when ``qcfg`` is given)."""
    cfg = jt.tiny_test_config(dtype=dtype, param_dtype=jnp.float32, **WIDE)
    module = jt.Decoder(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    variables = dict(module.init(jax.random.PRNGKey(0), ids))
    records = () if qcfg is None else (ModeRecord("quantize", jget_config(qcfg), {}),)
    return ModelBundle(module=module, variables=variables, example_inputs=(ids,),
                       records=records)


def _port(jb, qcfg=None):
    return from_jax_variables(jax.tree.map(np.asarray, jb.variables),
                              tt.tiny_test_config(dtype=torch.float32, **WIDE), qcfg,
                              device="cpu")


@pytest.fixture(scope="module")
def f32_pair():
    jb = _reference()
    return jb, _port(jb)


def test_mode_record_replays(f32_pair):
    """The mode shares the weights, leaves the source bundle dense, and its
    record replays onto a fresh bundle to the same config, as the
    reference's does."""
    jb, tb = f32_pair
    jsb = js.sparsify_attention_dynamic(jb, block_size=64, tau=5.0)
    tsb = ts.sparsify_attention_dynamic(tb, block_size=64, tau=5.0)
    rec = tsb.records[-1]
    assert rec.mode == jsb.records[-1].mode == "skip_softmax"
    assert rec.config == jsb.records[-1].config
    assert dataclasses.asdict(tsb.module.cfg.skip_softmax) == dataclasses.asdict(
        jsb.module.cfg.skip_softmax)
    assert tb.module.cfg.skip_softmax is None
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(tb.module.parameters(), tsb.module.parameters()))
    assert all(m.cfg is tsb.module.cfg for m in tsb.module.modules() if hasattr(m, "cfg"))
    again = apply_mode(tb, rec.mode, rec.config)
    assert again.module.cfg == tsb.module.cfg


def test_calibration_matches(monkeypatch, f32_pair):
    """Same tau, recalls within 1e-5 and the same worst head (of a chosen
    tau that drops blocks, so the minimum is not a tie at 1.0), from RULER
    batches of 384 tokens: the capture forwards (T >= 256, D = 128) attend
    through K14 in both packages (its twin here, the Pallas kernel in
    interpret mode there)."""
    jb, tb = f32_pair
    jbat = js.ruler_needle_batches(256, num_batches=1, batch_size=2, seq_len=384)
    tbat = ts.ruler_needle_batches(256, num_batches=1, batch_size=2, seq_len=384, device="cpu")
    # this random model's bounds lie within ~2 of each other: the grid spans
    # skipping most of the mass (0.3) to keeping all of it (2.0)
    kw = dict(recall_target=0.5, block_size=64, tau_grid=(0.3, 0.6, 1.0, 1.5, 2.0))
    with pallas_interpreted(monkeypatch):
        _, want = js.calibrate_skip_softmax(jb, jbat, **kw)
    calls = _spy(monkeypatch, tt, "flash_attention")
    tsb, got = ts.calibrate_skip_softmax(tb, tbat, **kw)
    assert len(calls) == 2  # one batch, two layers
    assert got["tau"] == want["tau"] == 1.5
    assert tsb.module.cfg.skip_softmax.tau == got["tau"]
    assert got["recalls"].keys() == want["recalls"].keys()
    for t in want["recalls"]:
        assert got["recalls"][t] == pytest.approx(want["recalls"][t], abs=1e-5)
    assert got["worst_head"]["layer"] == want["worst_head"]["layer"]
    assert got["worst_head"]["head"] == want["worst_head"]["head"]
    assert got["worst_head"]["recall"] == pytest.approx(want["worst_head"]["recall"], abs=1e-5)


def _decode(apply, make_cache, prompt, steps, to_np):
    """Prefill then greedy decode: (logits of every step [steps + 1, B, V],
    tokens [steps, B], the final cache)."""
    logits, cache = apply(prompt, make_cache())
    rows = [to_np(logits[:, -1])]
    toks = []
    for _ in range(steps):
        tok = rows[-1].argmax(-1).astype(np.int32)[:, None]
        toks.append(tok[:, 0])
        logits, cache = apply(tok, cache)
        rows.append(to_np(logits[:, -1]))
    return np.stack(rows), np.stack(toks), cache


MAXLEN, PROMPT, STEPS = 512, 320, 4


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_matches(monkeypatch, kv):
    """The reference's ``_decode_compare`` run in both packages: a 320-token
    cached prefill (the masked einsum over the cache) then 4 greedy decode
    steps through K17 (64-row blocks, block * KH = 128), tau 1e9 and budget
    1.0 (every in-range block, ordered by bound). Greedy tokens equal;
    logits within 5e-3 of the largest: the twin and the interpreted Pallas
    kernel take the same rounding points, but exp and f32 summation order
    differ in the last bits, so a few 7-bit probability codes (int8) or
    bf16 probabilities (f32 model, bf16 PV operands) round the other way,
    each moving an attention output by up to 1/127 or 2^-8 of a value
    (measured: 1.3e-3 and 2.7e-4 of the largest logit). The final summaries
    agree: on the int8 cache they are codes times the carried scale, equal
    but where a key's last bits round its code the other way (at most one
    code step, on under 1% of the entries); in f32 within 2e-3, as the
    second layer's keys of the decode steps carry the first layer's
    attention rounding above (measured 3.9e-4)."""
    qcfg = None if kv == "f32" else KV_INT8
    jb = _reference(qcfg=qcfg)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, (2, PROMPT)).astype(np.int32)
    jdt, tdt = (None, None) if kv == "f32" else (jnp.int8, torch.int8)
    if qcfg is not None:  # KV amax from one cached forward, carried to the port
        cal = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
        _, mut = cal(jb.variables, jnp.asarray(prompt[:, :64]), jt.make_cache(jb.module.cfg,
                                                                            2, 64))
        jb = jb.replace(variables={**jb.variables, "quant": mut["quant"]})
    tb = _port(jb, qcfg)
    jsb = js.sparsify_attention_dynamic(jb, block_size=64, tau=1e9, budget=1.0)
    tsb = ts.sparsify_attention_dynamic(tb, block_size=64, tau=1e9, budget=1.0)
    with pallas_interpreted(monkeypatch):
        fn = jax.jit(jsb.make_fn())
        want, wtok, jcache = _decode(
            lambda ids, c: fn(jsb.variables, jnp.asarray(ids), c),
            lambda: jt.make_cache(jsb.module.cfg, 2, MAXLEN, dtype=jdt), prompt, STEPS,
            lambda x: np.asarray(x, np.float32))
    calls = _spy(monkeypatch, tt, "block_sparse_decode_attention")
    got, gtok, tcache = _decode(
        lambda ids, c: tsb.apply(torch.from_numpy(np.ascontiguousarray(ids)), c),
        lambda: tt.make_cache(tsb.module.cfg, 2, MAXLEN, dtype=tdt, device="cpu"), prompt,
        STEPS, lambda x: x.float().numpy())
    assert np.array_equal(gtok, wtok)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * np.abs(want).max())
    for name in ("kmax", "kmin"):
        assert len(tcache[name]) == 2
        for i, (t, j) in enumerate(zip(tcache[name], jcache[name])):
            t, j = t.numpy(), np.asarray(j)
            if kv == "int8":
                step = float(getattr(tsb.module, f"layers_{i}").attn.k_quantizer.amax) / 127
                np.testing.assert_allclose(t, j, rtol=0, atol=1.01 * step)
                assert (t != j).mean() < 0.01
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    # every layer's summaries are its own tensors
    assert tcache["kmax"][0].data_ptr() != tcache["kmax"][1].data_ptr()
    assert len(calls) == 2 * STEPS  # K17's wrapper (its twin on the CPU), every layer


def test_make_cache_refuses_ragged_blocks(f32_pair):
    tsb = ts.sparsify_attention_dynamic(f32_pair[1], block_size=64)
    with pytest.raises(ValueError, match="divisible"):
        tt.make_cache(tsb.module.cfg, 1, 500, device="cpu")


def test_engine_refuses_skip_softmax(f32_pair):
    """The reference engine cannot serve a skip-softmax bundle (its shared
    summaries fail the donating prefill; its prefill never writes them),
    so the port's engine refuses one and names both faults."""
    tsb = ts.sparsify_attention_dynamic(f32_pair[1], block_size=64)
    with pytest.raises(NotImplementedError, match="donate") as err:
        ServingEngine(tsb, max_batch=2, max_seq_len=128, prefill_buckets=(64,), device="cpu")
    assert "summaries" in str(err.value)
