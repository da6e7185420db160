"""K6 w4a16_gemm and K10 grouped_w4a16_gemm: the port's plain twins (what
the CUDA kernels are held to on the card) against the JAX Pallas kernels in
interpret mode, decode and prefill forms; the weight-only branch of qgemm
against the JAX qgemm on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import quant_gemm as jk
from modelopt_tpu.quant import backends as jb
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.qspec import QuantizerSpec
from modelopt_tpu_torch.kernels import quant_gemm as tk
from modelopt_tpu_torch.quant import backends as tb
from modelopt_tpu_torch.quant import qtensor as tq
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC = QuantizerSpec(num_bits=4, block={-2: 128})
TSPEC = TSpec(num_bits=4, block={-2: 128})


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def order_bar(y, x, w, out):
    """How far two W4A16 products may differ when both multiply the same
    bf16 x by the same exact weights in f32 and only the order of the f32
    sums differs: K * 2^-24 * max(|x| @ |w|) (the worst-case f32 summation
    error), plus one ulp of the largest output in the output type (a sum
    that differs in its last f32 bits may round to the neighbouring bf16)."""
    K = x.shape[-1]
    order = K * 2.0**-24 * float((np.abs(x) @ np.abs(w)).max())
    top = float(np.abs(y).max())
    return order + 2.0**(np.floor(np.log2(top)) - (7 if out == "bf16" else 23))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("M", [1, 8, 300])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_w4a16_plain_matches_pallas(rng, interp, M, out):
    """Both multiply bf16 x by exact widened nibbles with f32 accumulation
    and put the block scale on the f32 accumulator; they sum in another
    order (the Pallas decode grid interleaves each block's halves, its
    prefill grid adds all low-half blocks before the high half, the twin
    interleaves): held to ``order_bar``. M=300 takes the M-tiled prefill
    grid."""
    K, N = 512, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    yj = np.asarray(jk.w4a16_gemm(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                                  block=128, out_dtype=jdt).astype(jnp.float32))
    yt = tk.w4a16_gemm(torch.from_numpy(x).bfloat16(), _t(p["data"]), _t(p["scale"]),
                       block=128, out_dtype=tdt)
    assert yt.dtype == tdt and yt.shape == (M, N)
    bar = order_bar(yj, _bf16(x), np.asarray(jq.dequantize_int4(p, 128)), out)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=bar)


@pytest.mark.parametrize("M", [3, 8])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_grouped_w4a16_plain_matches_pallas(rng, interp, M, out):
    """Per-expert K6 arithmetic on the folded layout [K, E*N], expert e in
    columns e*N:(e+1)*N: held to ``order_bar`` expert by expert."""
    E, K, N = 4, 512, 256
    w = rng.standard_normal((K, E * N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    yj = np.asarray(jk.grouped_w4a16_gemm(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                                          N, block=128, out_dtype=jdt).astype(jnp.float32))
    yt = tk.grouped_w4a16_gemm(torch.from_numpy(x).bfloat16(), _t(p["data"]),
                               _t(p["scale"]), N, out_dtype=tdt)
    assert yt.shape == (E, M, N) and yt.dtype == tdt
    wd = np.asarray(jq.dequantize_int4(p, 128))
    for e in range(E):
        bar = order_bar(yj[e], _bf16(x[e]), wd[:, e * N:(e + 1) * N], out)
        np.testing.assert_allclose(yt[e].float().numpy(), yj[e], rtol=0, atol=bar)


@pytest.mark.parametrize("M", [1, 300])
def test_w4a16_straddle_plain_matches_pallas(rng, interp, M):
    """K=384 (K/2 % 128 == 64), the reference's straddle order in the twin
    (low-half blocks, the straddle block's two f32 dots summed under one
    scale row, the high-half blocks): held to ``order_bar``, plain and
    grouped."""
    K, N, E = 384, 256, 2
    w = rng.standard_normal((K, E * N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    wd = np.asarray(jq.dequantize_int4(p, 128))
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    yj = np.asarray(jk.w4a16_gemm(jnp.asarray(x[0], jnp.bfloat16), p["data"], p["scale"],
                                  block=128, out_dtype=jnp.float32))
    yt = tk.w4a16_gemm(torch.from_numpy(x[0]).bfloat16(), _t(p["data"]), _t(p["scale"]),
                       out_dtype=torch.float32)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=order_bar(yj, _bf16(x[0]), wd, "f32"))
    gj = np.asarray(jk.grouped_w4a16_gemm(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                                          N, block=128, out_dtype=jnp.float32))
    gt = tk.grouped_w4a16_gemm(torch.from_numpy(x).bfloat16(), _t(p["data"]), _t(p["scale"]),
                               N, out_dtype=torch.float32)
    for e in range(E):
        np.testing.assert_allclose(gt[e].numpy(), gj[e], rtol=0, atol=order_bar(
            gj[e], _bf16(x[e]), wd[:, e * N:(e + 1) * N], "f32"))


def test_w4a16_straddle_refused():
    """The CUDA K6 and K10 take straddle shapes (K/2 % 128 == 64): such a
    tensor off the CPU passes the card's shape check and reaches the
    device check (here, with no card, refused as not on the card), while
    block sizes other than 128 are still refused by the shape check."""
    p = tq.quantize_int4(torch.randn(384, 256))
    x = torch.empty(2, 384, dtype=torch.bfloat16, device="meta")
    data, scale = p["data"].to("meta"), p["scale"].to("meta")
    with pytest.raises(ValueError, match="on the card"):
        tk.w4a16_gemm(x, data, scale)
    with pytest.raises(ValueError, match="on the card"):
        tk.grouped_w4a16_gemm(x.reshape(2, 1, 384), data, scale, 128)
    p64 = tq.quantize_int4(torch.randn(384, 256), block=64)
    with pytest.raises(NotImplementedError, match="block-128"):
        tk.w4a16_gemm(x, p64["data"].to("meta"), p64["scale"].to("meta"), block=64)
    with pytest.raises(NotImplementedError, match="block-128"):
        tk.grouped_w4a16_gemm(x.reshape(2, 1, 384), p64["data"].to("meta"),
                              p64["scale"].to("meta"), 128, block=64)


def _w4a16_rank_split(x3, packed, scale, n, R, out_dtype):
    """K6 / K10's straddle decode tile on a cluster of R CTAs, in f32 on the
    CPU: the reference's 2 nfull + 1 stages (the low-half blocks, the
    straddle block's low tail plus high head, the high-half blocks), each
    an f32 product rounded under its scale row; rank r runs the recurrence
    ``acc + d*s`` from zero over its contiguous run of stages [r nst / R,
    (r + 1) nst / R), and the ranks' partials are summed in rank order."""
    E, _, K = x3.shape
    K2 = K // 2
    nfull = K2 // 128
    xf = x3.to(torch.bfloat16).float()
    p = packed.to(torch.int32)
    qlo = ((p & 0xF) - 8).float().reshape(K2, E, n).transpose(0, 1)
    qhi = (((p >> 4) ^ 8) - 8).float().reshape(K2, E, n).transpose(0, 1)
    sc = scale.reshape(-1, E, n).transpose(0, 1)

    def lo(r0, m):
        return torch.bmm(xf[..., r0:r0 + m], qlo[:, r0:r0 + m])

    def hi(r0, m):
        return torch.bmm(xf[..., K2 + r0:K2 + r0 + m], qhi[:, r0:r0 + m])

    stages = ([lo(128 * b, 128) for b in range(nfull)] + [lo(128 * nfull, 64) + hi(0, 64)]
              + [hi(64 + 128 * b, 128) for b in range(nfull)])
    nst = len(stages)
    out = None
    for r in range(R):
        acc = torch.zeros_like(stages[0])
        for s in range(r * nst // R, (r + 1) * nst // R):
            acc = acc + stages[s] * sc[:, s:s + 1]
        out = acc if out is None else out + acc
    return out.to(out_dtype)


def test_w4a16_straddle_rank_split_matches_twin_and_pallas(rng, interp):
    """The order of sums of K6's and K10's straddle decode tile on a
    cluster (R = 1, 2, 4, 8 over DeepSeek-V2-Lite's K = 1408: 11 stages,
    contiguous runs of them per rank, partials summed in rank order) stays
    within ``order_bar`` of the twin, and of K10's Pallas kernel in
    interpret mode (E = 2), at M = 8, f32 out; the plain product (expert
    0's columns) against K6's twin. At R = 1 it is the twin's order
    exactly."""
    K, N, M, E = 1408, 128, 8, 2
    w = rng.standard_normal((K, E * N)).astype(np.float32) / np.sqrt(K)
    pt = tq.quantize_int4(torch.from_numpy(w))
    wd = tq.dequantize_int4(pt).numpy()
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    yj = np.asarray(jk.grouped_w4a16_gemm(jnp.asarray(x, jnp.bfloat16),
                                          jnp.asarray(pt["data"].numpy()),
                                          jnp.asarray(pt["scale"].numpy()), N,
                                          out_dtype=jnp.float32))
    yp = tk.grouped_w4a16_gemm_plain(xt, pt["data"], pt["scale"], N, out_dtype=torch.float32)
    d0, s0 = pt["data"][:, :N].contiguous(), pt["scale"][:, :N].contiguous()
    y0 = tk.w4a16_gemm_plain(xt[0], d0, s0, out_dtype=torch.float32)
    assert tk._w4a16_stages(K // 2) == 11
    for R in (1, 2, 4, 8):
        ys = _w4a16_rank_split(xt, pt["data"], pt["scale"], N, R, torch.float32)
        ys0 = _w4a16_rank_split(xt[:1], d0, s0, N, R, torch.float32)[0]
        if R == 1:
            assert torch.equal(ys, yp) and torch.equal(ys0, y0)
        np.testing.assert_allclose(ys0.numpy(), y0.numpy(), rtol=0,
                                   atol=order_bar(y0.numpy(), _bf16(x[0]), wd[:, :N], "f32"))
        for e in range(E):
            bar = order_bar(yj[e], _bf16(x[e]), wd[:, e * N:(e + 1) * N], "f32")
            np.testing.assert_allclose(ys[e].numpy(), yp[e].numpy(), rtol=0, atol=bar)
            np.testing.assert_allclose(ys[e].numpy(), yj[e], rtol=0, atol=bar)


@pytest.mark.parametrize("E,M,N,K,want", [
    (1, 8, 2048, 1408, 4),     # one 2048-column straddle weight: 32 tiles, 11 stages
    (1, 8, 64, 1408, 8),       # one tile: 8 ranks of the 11 stages (more than K // 256)
    (1, 8, 64, 384, 2),        # one tile, K = 384: 3 stages, never more ranks than stages
    (64, 8, 2048, 1408, 1),    # K10, DeepSeek-V2-Lite's expert down projection: 2,048 tiles
])
def test_w4a16_straddle_cluster_ranks(E, M, N, K, want):
    """The decode tile's cluster size at straddle K counts the 2 nfull + 1
    stages of the recurrence, not the 128-row blocks."""
    R = tk._w4a16_ranks(E, M, N, K // 2)
    assert R == want
    assert R <= tk._w4a16_stages(K // 2) == 2 * (K // 256) + 1


@pytest.mark.parametrize("E,M,N,K,want", [
    (1, 8, 4096, 2048, 2),     # Qwen3-30B-A3B q_proj: 64 column tiles
    (1, 8, 512, 2048, 8),      # k_proj / v_proj: 8 tiles
    (1, 16, 2048, 4096, 4),    # o_proj: 32 tiles, 16 blocks
    (1, 1, 98304, 2048, 1),    # the folded gate / up experts: 1,536 tiles
    (128, 8, 2048, 768, 1),    # K10, the expert down projection: 4,096 tiles
    (1, 8, 64, 768, 2),        # one tile, K = 768: never more ranks than its 3 blocks
])
def test_w4a16_decode_cluster_ranks(E, M, N, K, want):
    """The decode tile's cluster size (CTAs that split one output tile's
    128-row blocks, summed in one launch) at path C's shapes: the few-tile
    projections split, the many-tile ones do not, and no rank is left
    without a block."""
    R = tk._w4a16_ranks(E, M, N, K // 2)
    assert R == want
    assert R <= K // 256 and R in (1, 2, 4, 8)
    assert tk._w4a16_ranks(E, 17, N, K // 2) == 1  # the wgmma tile: no split


def test_w4a16_off_cpu_never_computes_the_twin():
    """A tensor that is not on the CPU goes to the kernel's checks, never
    to the plain twin: here (no card) they refuse it."""
    p = tq.quantize_int4(torch.randn(256, 128))
    x = torch.empty(4, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        tk.w4a16_gemm(x, p["data"].to("meta"), p["scale"].to("meta"))


@pytest.mark.parametrize("M", [4, 300])
def test_qgemm_weight_only_matches_reference(rng, M):
    """int4 weights without int8 activations (INT4_BLOCKWISE_WEIGHT_ONLY_CFG):
    the reference's CPU qgemm multiplies bf16 x by the bf16-rounded
    dequantized weight, the port runs K6's arithmetic (its twin here, the
    kernel on the card) at every M. Both approximate the same product: held
    at bf16 tolerance (2^-8 of the output scale, plus the weight's bf16
    rounding summed over K)."""
    K, N = 256, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w))
    yj = np.asarray(jb.qgemm(jnp.asarray(x, jnp.bfloat16), p, SPEC, (K, N))
                    .astype(jnp.float32))
    pt = {k: _t(v) for k, v in p.items()}
    yt = tb.qgemm(torch.from_numpy(x).bfloat16(), pt, TSPEC, (K, N))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=2e-2 * np.abs(yj).max())


def test_qgemm_weight_only_routes_to_w4a16(rng, monkeypatch):
    """Every M of an int4 weight-only product goes through the K6 wrapper
    (on the card the kernel, including the small products the reference's
    TPU dispatch leaves to XLA)."""
    calls = []
    real = tb.w4a16_gemm
    monkeypatch.setattr(tb, "w4a16_gemm", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    p = tq.quantize_int4(torch.randn(256, 128))
    for M in (1, 16, 300):
        tb.qgemm(torch.randn(M, 256).bfloat16(), p, TSPEC, (256, 128))
    assert calls == [(1, 256), (16, 256), (300, 256)]
