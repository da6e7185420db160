"""K11 grouped_w4a8_gemm: the port's plain twin (what the CUDA kernel is
held to on the card, bit for bit) against the JAX Pallas kernel in
interpret mode, aligned and straddle widths, M not a multiple of 8; the
``grouped_qgemm`` int4 + int8-activation branch against the reference
branch's own steps around that kernel; the gateless ``QuantEinsum`` down
projection, which reaches K11, against the reference's on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import quant_gemm as jk
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.quant.qspec import QuantizerSpec
from modelopt_tpu_torch.kernels import quant_gemm as tk
from modelopt_tpu_torch.quant import backends as tb
from modelopt_tpu_torch.quant.config import get_config
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
W4A8 = "W4A8_INT8KV_CFG"


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(rng, E, K, N):
    """A folded expert weight [K, E*N] packed by the reference."""
    w = rng.standard_normal((K, E * N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    return p, {k: _t(v) for k, v in p.items()}


def _fused_stages(xq, pt, N):
    """The twin's stages (``_w4a8_body``'s order) with each update
    ``acc + q * s`` rounded once, as a fused multiply-add: the product of an
    integer dot and an f32 scale is exact in f64, the sum rounded to f32."""
    E, M, K = xq.shape
    K2 = K // 2
    nfull, rem = divmod(K2, 128)
    p = pt["data"].numpy().astype(np.int64)
    qlo, qhi = (p & 0xF) - 8, ((p >> 4) ^ 8) - 8
    sc = pt["scale"].numpy().astype(np.float64)
    x = xq.astype(np.int64)
    out = np.zeros((E, M, N), np.float32)
    for e in range(E):
        c = slice(e * N, (e + 1) * N)
        acc = np.zeros((M, N), np.float32)

        def upd(acc, q, srow):
            return (acc.astype(np.float64) + q.astype(np.float64) * sc[srow, c]).astype(
                np.float32)

        def lo(r0, n):
            return x[e][:, r0:r0 + n] @ qlo[r0:r0 + n, c]

        def hi(r0, n):
            return x[e][:, K2 + r0:K2 + r0 + n] @ qhi[r0:r0 + n, c]

        if rem == 0:
            for b in range(nfull):
                acc = upd(upd(acc, lo(b * 128, 128), b), hi(b * 128, 128), nfull + b)
        else:
            for b in range(nfull):
                acc = upd(acc, lo(b * 128, 128), b)
            acc = upd(acc, lo(nfull * 128, rem) + hi(0, rem), nfull)
            for b in range(nfull):
                acc = upd(acc, hi(rem + b * 128, 128), nfull + 1 + b)
        out[e] = acc
    return out


@pytest.mark.parametrize("K", [256, 384])   # aligned; straddle (K/2 % 128 == 64)
@pytest.mark.parametrize("M", [3, 8, 13])   # the Pallas wrapper pads M to 8
def test_grouped_w4a8_plain_matches_pallas(rng, interp, M, K):
    """Exact integer dots on both sides and the same f32 stages in
    ``_w4a8_body``'s order: per expert, the twin is K1's twin bit for bit.
    XLA's CPU backend, which runs the interpreted kernel, contracts each
    update ``acc + q * s`` into one fused multiply-add, where the twin (as
    K1's and K12's twins and CUDA kernels) rounds the product and the sum
    apart: the interpreted kernel equals those stages with fused updates bit
    for bit, and the twin lies within the product roundings' bound of it,
    2^-24 of each update's size."""
    E, N = 4, 128
    p, pt = _packed(rng, E, K, N)
    xq = rng.integers(-127, 128, (E, M, K)).astype(np.int8)
    yj = np.asarray(jk.grouped_w4a8_gemm(jnp.asarray(xq), p["data"], p["scale"], N, block=128))
    yt = tk.grouped_w4a8_gemm(torch.from_numpy(xq), pt["data"], pt["scale"], N)
    assert yt.shape == (E, M, N) and yt.dtype == torch.float32
    for e in range(E):
        c = slice(e * N, (e + 1) * N)
        assert torch.equal(yt[e], tk.w4a8_gemm_plain(torch.from_numpy(xq[e]), pt["data"][:, c],
                                                     pt["scale"][:, c]))
    np.testing.assert_array_equal(_fused_stages(xq, pt, N), yj)
    updates = K // 128  # one per scale row
    bound = updates * 2.0**-23 * np.abs(yj).max()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=bound)


def _reference_branch(x3, p, efn):
    """The reference's int4 + int8-activation branch of ``grouped_qgemm``
    (backends.py:183-193), its steps composed around the interpreted
    kernel: per-(expert, row) scale max(|x|, 1e-12)/127, codes
    clip(round(x / xs), -127, 127), the kernel's f32 product times xs, in
    x's dtype, [M, E, N]."""
    E, K, N = efn
    xe = x3.transpose(1, 0, 2)
    xf = xe.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=2, keepdims=True), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    y = jk.grouped_w4a8_gemm(xq, p["data"], p["scale"], N, block=128)
    return (y * xs).astype(x3.dtype).transpose(1, 0, 2)


@pytest.mark.parametrize("M,K", [(5, 256), (8, 384)])
def test_grouped_qgemm_int8_branch_matches_reference_steps(rng, interp, M, K):
    """The port's branch (K11's twin on the CPU) against the reference's
    steps around its interpreted kernel, in bf16: the codes and scales are
    the same bits, the f32 products differ only by the fused updates above,
    so every output lies within one bf16 ulp of the reference's."""
    E, N = 4, 128
    efn = (E, K, N)
    p, pt = _packed(rng, E, K, N)
    x3 = rng.standard_normal((M, E, K)).astype(np.float32)
    want = np.asarray(_reference_branch(jnp.asarray(x3, jnp.bfloat16), p, efn)
                      .astype(jnp.float32))
    got = tb.grouped_qgemm(torch.from_numpy(x3).bfloat16(), pt, TSPEC, efn, act_int8=True,
                           act_raw=True)
    assert got.shape == (M, E, N) and got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def _einsum_pair(rng, E, fin, fout):
    """A compressed gateless down projection ``bteo,eod->bted`` in both
    packages: the reference's packed folded weight under W4A8_INT8KV_CFG,
    carried into the port's module."""
    from modelopt_tpu.nn import layers as jl
    from modelopt_tpu_torch.nn.layers import QuantEinsum
    from modelopt_tpu_torch.nn.quantizer import assign_paths

    w = (rng.standard_normal((E, fin, fout)) / np.sqrt(fin)).astype(np.float32)
    spec = jget_config(W4A8).resolve("/weight_quantizer")[0]
    qt, _ = jq.quantize_qtensor(jnp.asarray(w).transpose(1, 0, 2).reshape(fin, E * fout), spec)
    jmod = jl.QuantEinsum(einsum_str="bteo,eod->bted", kernel_shape=(E, fin, fout),
                          dtype=jnp.bfloat16)
    tmod = QuantEinsum("bteo,eod->bted", (E, fin, fout), dtype=torch.bfloat16, device="cpu")
    assign_paths(tmod)
    tmod.set_qweight({k: _t(v) for k, v in qt.items()})
    return jmod, {"quant": {"qweight": qt}}, tmod


def test_gateless_quant_einsum_matches_reference():
    """The gateless compressed down projection on [2, 3, E, fin] bf16
    activations: the reference's CPU path (per-(token, expert) int8
    fake-quant, the dequantized weight, a bf16 einsum) against the port's
    (per-(expert, row) int8 codes through K11's twin, the row scale after),
    at the W4A8 bar of the other MoE tests, 2e-2 of the output scale."""
    from modelopt_tpu.nn.quantizer import quantization_active as jactive
    from modelopt_tpu_torch.nn.quantizer import quantization_active

    rng = np.random.default_rng(12)
    E, fin, fout = 4, 256, 128
    jmod, variables, tmod = _einsum_pair(rng, E, fin, fout)
    x = rng.standard_normal((2, 3, E, fin)).astype(np.float32)
    with jactive(jget_config(W4A8)):
        want = np.asarray(jmod.apply(variables, jnp.asarray(x, jnp.bfloat16))
                          .astype(jnp.float32))
    with quantization_active(get_config(W4A8)):
        got = tmod(torch.from_numpy(x).bfloat16())
    assert got.shape == (2, 3, E, fout) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_down_projection_dispatch(monkeypatch):
    """The compressed W4A8 down projection at M <= 256 rows: without gates
    one K11 call and no K12, with gates one K12 call and no K11; above 256
    rows neither (the reference's dequantize steps)."""
    from modelopt_tpu_torch.nn.quantizer import quantization_active

    calls = []
    for name in ("grouped_w4a8_gemm", "grouped_w4a8_combine_gemm"):
        real = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    E, fin, fout = 2, 256, 128
    _, _, tmod = _einsum_pair(np.random.default_rng(0), E, fin, fout)
    seen = []
    with quantization_active(get_config(W4A8)):
        for T in (8, 300):
            x = torch.randn(1, T, E, fin).bfloat16()
            for gates in (None, torch.rand(1, T, E).bfloat16()):
                calls.clear()
                y = tmod(x, gates=gates)
                assert y.shape == ((1, T, E, fout) if gates is None else (1, T, fout))
                seen.append(list(calls))
    assert seen == [["grouped_w4a8_gemm"], ["grouped_w4a8_combine_gemm"], [], []]


# ---------------------------------------------------------------------------
# K12's card design on the CPU: the routed experts only, summed in expert order
# ---------------------------------------------------------------------------
def _routed_sum(xq, gs, pt, N, tile=32):
    """K12's CUDA kernel, on the CPU: per 32-token tile, the list of experts
    some row of the tile is routed to (a gscale that compares non-zero, so
    -0.0 counts as zero), each used expert's gated term acc_e * gscale[e]
    rounded, summed in list order (expert order) from +0; the experts the
    list leaves out are never read."""
    M = xq.shape[1]
    y = tk.grouped_w4a8_gemm_plain(xq, pt["data"], pt["scale"], N)
    out = torch.zeros(M, N)
    for m0 in range(0, M, tile):
        rows = slice(m0, min(m0 + tile, M))
        used = [e for e in range(xq.shape[0]) if bool((gs[e, rows] != 0).any())]
        acc = torch.zeros(rows.stop - m0, N)
        for e in used:
            acc = acc + y[e, rows] * gs[e, rows][:, None]
        out[rows] = acc
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def _gates(rng, kind, E, M):
    """gscale [E, M]: ``top2`` each row routed to 2 experts; ``single`` each
    used expert routed by exactly one row; ``negzero`` top2 with -0.0 in
    about half the unrouted entries and in one expert's whole row; ``zero`` no
    row routed anywhere (all +0 and -0)."""
    g = np.zeros((E, M), np.float32)
    if kind in ("top2", "negzero"):
        for m in range(M):
            g[rng.choice(E, 2, replace=False), m] = rng.random(2) * 0.05 + 1e-3
    if kind == "single":
        for m, e in enumerate(rng.choice(E, min(M, E), replace=False)):
            g[e, m] = rng.random() * 0.05 + 1e-3
    if kind in ("negzero", "zero"):
        neg = (g == 0) & (rng.random((E, M)) < 0.5)
        g[neg] = -0.0
        g[int(np.argmin(g.any(axis=1))), :] = -0.0  # one expert's whole row
    return torch.from_numpy(g)


@pytest.mark.parametrize("K", [256, 384])  # aligned; straddle (K/2 % 128 == 64)
@pytest.mark.parametrize("kind,M", [("top2", 5), ("single", 6), ("negzero", 8),
                                    ("zero", 4), ("top2", 40)])
def test_combine_over_routed_experts_is_the_plain_version(K, kind, M):
    """The plain version adds every expert's term in expert order; K12's
    kernel adds only those of the experts some row of its 32-token tile is
    routed to. A skipped term is acc * (+-0) = +-0 (acc is finite), out
    starts at +0, a sum of finite terms under round-to-nearest is never -0,
    and x + (+-0) = x for every other x: so the two agree bit for bit (sign
    bits of zeros included), with experts routed by a single row, -0.0
    gates, no routed expert at all (then out is +0 everywhere), and M = 40
    (two token tiles with lists of their own)."""
    rng = np.random.default_rng(K + M)
    E, N = 6, 64
    _, pt = _packed(rng, E, K, N)
    xq = torch.from_numpy(rng.integers(-127, 128, (E, M, K)).astype(np.int8))
    gs = _gates(rng, kind, E, M)
    want = tk.grouped_w4a8_combine_gemm(xq, gs, pt["data"], pt["scale"], N)
    got = _routed_sum(xq, gs, pt, N)
    assert torch.equal(_bits(got), _bits(want))
    if kind == "zero":
        assert torch.equal(_bits(want), torch.zeros(M, N, dtype=torch.int32))
    else:
        assert (want != 0).any()


@pytest.mark.parametrize("E,K", [(64, 1408), (128, 768)])
@pytest.mark.parametrize("M", [1, 8, 16, 32])
def test_combine_plan_fits_the_card(E, K, M):
    """K12's cluster at the served decode geometries (DeepSeek-V2-Lite's and
    Qwen3-30B-A3B's down projections, N = 2048), every expert used: a
    cluster of 16 (16 tiles of 128 columns x 16 = 256 CTAs, at 32 rows two
    16-token tiles and 512, within COMBINE_TARGET_CTAS); a CTA's shared memory (the 4-stage ring, at straddle
    K the high blocks' products, the held terms, the used list) within
    227 KB; held slots as many as keep three CTAs an SM
    (COMBINE_WAVE_SMEM), at least three, at most one a rank's expert. At
    M <= 8 every rank holds all its terms in one round."""
    N, K2 = 2048, K // 2
    R, slots = tk._combine_plan(E, M, N, K2)
    assert R == 16 and N // tk.GROUPED_BN * -(-M // 16) * R <= tk.COMBINE_TARGET_CTAS
    smem = tk._combine_smem(E, M, K2, R, slots)
    assert smem <= tk.SMEM_LIMIT
    assert slots <= -(-E // R)
    assert smem <= tk.COMBINE_WAVE_SMEM or slots == tk.COMBINE_MIN_SLOTS
    if slots < -(-E // R):
        assert tk._combine_smem(E, M, K2, R, slots + 1) > tk.COMBINE_WAVE_SMEM
    if M <= 8 and E == 128:
        assert slots == E // R
    tok = 8 if M <= 8 else 16
    ring = 4 * (64 * 128 + 2 * tok * 64 + 2 * 128 * 4)
    hold = (K2 // 128) * tok * 128 * 4 if K2 % 128 else 0  # the straddle's held high blocks
    assert smem == ring + hold + slots * tok * 128 * 4 + 4 * E + 80


def test_card_kernels_take_their_column_multiples():
    """On a tensor off the CPU the wrappers check the CUDA kernels' limits
    before anything else: the 128-column tiles of K12 and K11 want
    N % 128 == 0 (straddle K accepted); shapes that pass reach the device
    check, which refuses these meta tensors."""
    def args(E, K, N, M=8):
        pt = {"data": torch.empty(K // 2, E * N, dtype=torch.uint8, device="meta"),
              "scale": torch.empty(K // 128, E * N, device="meta")}
        return torch.empty(E, M, K, dtype=torch.int8, device="meta"), pt

    E = 2
    for K in (256, 384):
        for N, ok in ((64, False), (192, False), (128, True), (2048, True)):
            xq, pt = args(E, K, N)
            gs = torch.empty(E, 8, device="meta")
            want = "must be on the card" if ok else f"N={N} must be a multiple of 128"
            with pytest.raises(ValueError, match=want):
                tk.grouped_w4a8_combine_gemm(xq, gs, pt["data"], pt["scale"], N)
            with pytest.raises(ValueError, match=want):
                tk.grouped_w4a8_gemm(xq, pt["data"], pt["scale"], N)
