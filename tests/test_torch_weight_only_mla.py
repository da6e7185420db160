"""DeepSeek-V2 under the weight-only presets on the CPU: the small compressed
MLA config (``small_mla_compressed_config``: experts of width 384, K/2 =
128 + 64 like V2-Lite's 1408; a dense layer of width 320 like its 10944)
under INT4_BLOCKWISE_WEIGHT_ONLY_CFG and NVFP4_WEIGHT_ONLY_CFG with a bf16
latent cache, compressed by the reference's ``compress``, carried into the
port by ``from_jax_variables`` and held against the reference: logits, the
GEMM routes, greedy tokens through both engines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels.quant_gemm import _nvfp4_chunk
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import backends as jbackends
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.kernels import quant_gemm as tk
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant import backends as tb_
from modelopt_tpu_torch.quant import qtensor as tq
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec
from modelopt_tpu_torch.serve import ServingEngine
from tests.test_torch_mla import float_bundle, port_cfg, router_gaps, to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them, and the suite runs several workers side by
    side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INT4, NVFP4 = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_WEIGHT_ONLY_CFG"
B, T, S, STEPS = 2, 8, 32, 2
# numpy seed of the ids: on these inputs every top-2 router choice of the
# port is at least 0.12 in router logits from a tie under both presets
IDS_SEED = 10
MIN_ROUTER_GAP = 0.03
# bf16 products against the reference's: its CPU path multiplies bf16 x by
# the dequantized weight rounded to bf16 (2^-9 of each weight), the port's
# kernels (their twins here) multiply by the exact weight and scale the f32
# sums; over two layers and the lm_head, 3% of the logit range
LOGIT_BAR = 3e-2


def _gemm_shape_rule(fmt, x, kn, block=128):
    """The reference's ``_pallas_ok`` without its backend test and without
    its small-product cut (K * N < 2^22, which would leave every GEMM of
    this small model to XLA): N % 128 == 0, whole scale blocks, the NVFP4
    kernel's K % 128 == 0 and clean chunking, at most 256 rows."""
    K, N = kn
    if N % 128 or x.shape[0] > 256 or K % 128:
        return False
    if fmt in ("int4", "nvfp4"):
        K2 = K // 2
        if block % 8 or (K2 % block) % 8:
            return False
        if fmt == "nvfp4" and (K2 % block or _nvfp4_chunk(K2, block) is None):
            return False
    return True


@pytest.fixture(scope="module", params=[INT4, NVFP4])
def compressed(request):
    """One reference bundle a preset, compressed by the reference's
    ``compress`` (no calibration: weight-only, bf16 cache), and the port's
    copy of it."""
    preset = request.param
    tcfg = port_cfg()
    jb = jcompress(float_bundle(tcfg, preset, seed=6, lm_scale=4.0))
    return preset, jb, from_jax_variables(to_numpy(jb.variables), tcfg, preset, device="cpu")


def test_weight_only_logits_match(compressed, monkeypatch):
    """Prefill then teacher-forced decode over a bf16 latent cache. The
    reference runs the quantized GEMMs its shape rule admits through its
    Pallas kernels in interpret mode (w4a16_gemm, nvfp4_gemm; the expert
    down projection's grouped product takes its XLA einsum on the CPU), the
    port its kernels' twins (K6 / K10 at straddle K, K9 / K13 with the 64-row tail, the
    dense layer's K = 320 dequantized under NVFP4, uncompressed under
    int4). Held to LOGIT_BAR of the logit range; greedy choices agree at
    every step and no top-2 router choice is within MIN_ROUTER_GAP of a
    tie."""
    preset, jb, tb = compressed
    monkeypatch.setattr(jbackends, "_pallas_ok", _gemm_shape_rule)
    ids = np.random.default_rng(IDS_SEED).integers(1, 512, (B, T + STEPS)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(jb.make_fn())
        cache = jt.make_cache(jb.module.cfg, B, S)
        lj, cache = fn(jb.variables, jnp.asarray(ids[:, :T]), cache)
        want = [np.asarray(lj[:, -1], np.float32)]
        for t in range(STEPS):
            lj, cache = fn(jb.variables, jnp.asarray(ids[:, T + t:T + t + 1]), cache)
            want.append(np.asarray(lj[:, -1], np.float32))
    tcache = tt.make_cache(port_cfg(), B, S, device="cpu")
    assert tcache["k"][0].dtype == torch.bfloat16
    with router_gaps(tb) as gaps:
        lt, tcache = tb.apply(torch.from_numpy(ids[:, :T]), tcache)
        got = [lt[:, -1].float().numpy()]
        for t in range(STEPS):
            lt, tcache = tb.apply(torch.from_numpy(ids[:, T + t:T + t + 1]), tcache)
            got.append(lt[:, -1].float().numpy())
    assert min(gaps) > MIN_ROUTER_GAP
    want, got = np.stack(want), np.stack(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_BAR * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_weight_only_routes(compressed, monkeypatch):
    """Spied calls of one prefill and one decode step of the port: the
    experts' down projection (K = 384, K/2 % 128 == 64) takes
    grouped_w4a16_gemm or grouped_nvfp4_gemm at both; under NVFP4 the dense
    layer's K = 320 (K % 128 != 0, the reference's _pallas_ok rule) takes
    the dequantize path and never nvfp4_gemm, while the K = 128, 256 and
    768 projections take nvfp4_gemm; under int4 the K = 320 projection is
    not packed, and the others take w4a16_gemm. A
    grouped NVFP4 weight with K/2 % 64 != 0 takes the einsum."""
    preset, _, tb = compressed
    calls = []
    for name in ("w4a16_gemm", "grouped_w4a16_gemm", "nvfp4_gemm", "grouped_nvfp4_gemm",
                 "dequantize_qtensor"):
        real = getattr(tb_, name)
        monkeypatch.setattr(tb_, name, lambda *a, _n=name, _r=real, **k: calls.append(
            (_n, a[2][0] if _n == "dequantize_qtensor" else a[0].shape[-1])) or _r(*a, **k))
    cache = tt.make_cache(port_cfg(), 1, S, device="cpu")
    _, cache = tb.apply(torch.ones(1, 4, dtype=torch.int32), cache)
    _, cache = tb.apply(torch.ones(1, 1, dtype=torch.int32), cache)
    plain, grouped = (("w4a16_gemm", "grouped_w4a16_gemm") if preset == INT4
                      else ("nvfp4_gemm", "grouped_nvfp4_gemm"))
    assert calls.count((grouped, 384)) == 2  # one MoE layer, two forwards
    assert {k for n, k in calls if n == plain} == {128, 256, 768}
    assert (plain, 320) not in calls
    if preset == NVFP4:
        assert calls.count(("dequantize_qtensor", 320)) == 2
    assert {n for n, _ in calls} == {plain, grouped} | ({"dequantize_qtensor"}
                                                         if preset == NVFP4 else set())
    # K = 160: K/2 = 80, whole 16-row scale blocks (the reference's grouped
    # rule admits it) but not whole 64-row tails: the einsum, on both devices
    calls.clear()
    E, K, N = 2, 160, 128
    pt = tq.quantize_nvfp4(torch.randn(K, E * N))
    x3 = torch.randn(3, E, K).bfloat16()
    spec = TSpec(num_bits=(2, 1), block={-2: 16, "type": "dynamic", "scale_format": "e4m3",
                                         "two_level": True})
    y = tb_.grouped_qgemm(x3, pt, spec, (E, K, N))
    assert calls == [("dequantize_qtensor", K)] and y.shape == (3, E, N)
    assert not tk.nvfp4_gemm_ok(K, N) and tk.nvfp4_gemm_ok(384, N)


# the second prompt streams in chunks of 16 + 4, the third arrives after two
# ticks; numpy seed of the prompts a preset: every greedy choice of the
# port on them is at least 0.19 above its runner-up, every top-2 router
# choice at least 0.098 from a tie
PROMPT_LENS = (5, 20, 3)
PROMPT_SEED = {INT4: 36, NVFP4: 41}


def test_weight_only_greedy_tokens_match_reference_engine(compressed):
    """Three staggered requests through the reference's engine (its CPU
    paths) and the port's (the kernels' twins) over bf16 latent caches: the
    same tokens and stop reasons, log-probs within 0.05 (the bf16 rounding
    of the reference's dequantized weights, as LOGIT_BAR)."""
    preset, jb, tb = compressed
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16,), max_admit=1)
    rng = np.random.default_rng(PROMPT_SEED[preset])
    prompts = [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=4) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=4))
        engine.run()
        return reqs

    want = serve(JaxEngine(jb, **kw))
    got = serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.05)
