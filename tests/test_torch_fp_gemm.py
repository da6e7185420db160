"""K7 w8a16_gemm, K8 wfp8_gemm, K9 nvfp4_gemm and K13 grouped_nvfp4_gemm:
the port's plain twins (what the CUDA kernels are held to on the card)
against the JAX Pallas kernels in interpret mode; qgemm, grouped_qgemm and
moe_down_qgemm for int8, e4m3 and NVFP4 weights against the JAX backends
on the CPU, at M <= 256 (the kernels) and above (dequantize + matmul), and
the dispatch between them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import quant_gemm as jk
from modelopt_tpu.quant import backends as jb
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu_torch.kernels import quant_gemm as tk
from modelopt_tpu_torch.quant import backends as tb
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


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


NVFP4_BLOCK = {-2: 16, "type": "dynamic", "scale_format": "e4m3", "two_level": True}
SPECS = {"int8": dict(num_bits=8, axis=(-1,)), "fp8": dict(num_bits=(4, 3)),
         "nvfp4": dict(num_bits=(2, 1), block=NVFP4_BLOCK)}
JQUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8, "nvfp4": jq.quantize_nvfp4}
JDEQ = {"int8": jq.dequantize_int8, "fp8": jq.dequantize_fp8, "nvfp4": jq.dequantize_nvfp4}


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _packed(rng, fmt, K, N):
    """A weight [K, N] packed by the reference: (reference dict, port dict,
    dequantized f32 weight)."""
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    p = JQUANT[fmt](jnp.asarray(w))
    return p, {k: _t(v) for k, v in p.items()}, np.asarray(JDEQ[fmt](p))


def order_bar(y, x, w, out):
    """How far two products may differ when both multiply the same bf16 x
    by the same bf16-exact weights in f32 and only the order of the f32
    sums differs: K * 2^-24 * max(|x| @ |w|), plus one ulp of the largest
    output in the output type (test_torch_w4a16.py's bar)."""
    K = x.shape[-1]
    order = K * 2.0**-24 * float((np.abs(x) @ np.abs(w)).max())
    top = float(np.abs(y).max())
    return order + 2.0**(np.floor(np.log2(top)) - (7 if out == "bf16" else 23))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _dtypes(out):
    return (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_byte_gemm_plain_matches_pallas(rng, interp, fmt, M, out):
    """K7 and K8: bf16 x times int8 / e4m3 weights (exact in bf16) in f32,
    the f32 scale ([1, N] / [1, 1]) on the f32 result; the Pallas kernel
    tiles N and sums K in its own order: held to ``order_bar``."""
    K, N = 512, 256
    p, pt, wd = _packed(rng, fmt, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jdt, tdt = _dtypes(out)
    jfn, tfn = (jk.w8a16_gemm, tk.w8a16_gemm) if fmt == "int8" else (jk.wfp8_gemm,
                                                                      tk.wfp8_gemm)
    yj = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                        out_dtype=jdt).astype(jnp.float32))
    yt = tfn(torch.from_numpy(x).bfloat16(), pt["data"], pt["scale"], out_dtype=tdt)
    assert yt.dtype == tdt and yt.shape == (M, N)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                               atol=order_bar(yj, _bf16(x), wd, out))


# K = 384: K/2 = 128 + 64, the card's 64-row tail (DeepSeek-V2-Lite's K = 1408)
@pytest.mark.parametrize("K", [512, 1024, 384])  # one 256-row chunk a half; two; one of 192
# M = 40: the card's wgmma tile (above M = 16), one ragged 64-token tile
@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_nvfp4_plain_matches_pallas(rng, interp, K, M, out):
    """K9: each e2m1 value times its e4m3 block scale, exact in bf16, then
    bf16 x times those in f32 and scale2 on the f32 result. The Pallas
    kernel sums chunk by chunk (K/2 = 512: two chunks a half), the twin in
    one product: held to ``order_bar``. The twin's bit-assembled e2m1
    decode equals the reference kernel's and the packing's table."""
    N = 256
    p, pt, wd = _packed(rng, "nvfp4", K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jdt, tdt = _dtypes(out)
    yj = np.asarray(jk.nvfp4_gemm(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                                  p["scale2"], out_dtype=jdt).astype(jnp.float32))
    yt = tk.nvfp4_gemm(torch.from_numpy(x).bfloat16(), pt["data"], pt["scale"], pt["scale2"],
                       out_dtype=tdt)
    assert yt.dtype == tdt and yt.shape == (M, N)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                               atol=order_bar(yj, _bf16(x), wd, out))
    codes = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(
        tk._decode_e2m1(torch.from_numpy(codes)).numpy(),
        np.asarray(jk._decode_e2m1(jnp.asarray(codes))))
    # the kernel's weights are exact in bf16; times scale2 they are the
    # reference's dequantized weight up to the order of the two f32 scales
    unit = tk.nvfp4_unit_weights(pt["data"], pt["scale"])
    assert torch.equal(unit.bfloat16().float(), unit)
    np.testing.assert_allclose((unit * pt["scale2"]).numpy(), wd, rtol=2.0**-23, atol=0)


# K = 384: the card's 64-row tail, as DeepSeek-V2-Lite's experts (K = 1408)
@pytest.mark.parametrize("K", [512, 768, 384])  # one 256-row chunk a half; two of 192; one
@pytest.mark.parametrize("M", [3, 8])
def test_grouped_nvfp4_plain_matches_pallas(rng, interp, K, M):
    """K13: K9's arithmetic per expert on the folded layout [K/2, E*N],
    expert e in columns e*N:(e+1)*N; K=768 is Qwen3-30B-A3B's expert width
    (K/2 = 384, two 192-row chunks a half): held to ``order_bar`` expert by
    expert."""
    E, N = 3, 256
    p, pt, wd = _packed(rng, "nvfp4", K, E * N)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    yj = np.asarray(jk.grouped_nvfp4_gemm(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                                          p["scale2"], N, out_dtype=jnp.float32))
    yt = tk.grouped_nvfp4_gemm(torch.from_numpy(x).bfloat16(), pt["data"], pt["scale"],
                               pt["scale2"], N, out_dtype=torch.float32)
    assert yt.shape == (E, M, N)
    for e in range(E):
        np.testing.assert_allclose(yt[e].numpy(), yj[e], rtol=0, atol=order_bar(
            yj[e], _bf16(x[e]), wd[:, e * N:(e + 1) * N], "f32"))


@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("fmt", ["int8", "fp8", "nvfp4"])
def test_qgemm_matches_reference(rng, fmt, M):
    """qgemm for each new format against the JAX qgemm on the CPU (its
    dequantize path: bf16 x times the bf16-rounded dequantized weight). The
    port's twin (M <= 256) multiplies exact weights and scales the f32
    result; above 256 rows it dequantizes as the reference does. Held at
    bf16 tolerance, 2^-8 of the output scale plus the weight's bf16
    rounding summed over K."""
    K, N = 256, 128
    p, pt, _ = _packed(rng, fmt, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    yj = np.asarray(jb.qgemm(jnp.asarray(x, jnp.bfloat16), p, JSpec(**SPECS[fmt]), (K, N))
                    .astype(jnp.float32))
    yt = tb.qgemm(torch.from_numpy(x).bfloat16(), pt, TSpec(**SPECS[fmt]), (K, N))
    assert yt.dtype == torch.bfloat16 and yt.shape == (M, N)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=2e-2 * np.abs(yj).max())


@pytest.mark.parametrize("M", [3, 300])
def test_grouped_and_moe_down_nvfp4_match_reference(rng, M):
    """grouped_qgemm and moe_down_qgemm with NVFP4 experts against the JAX
    backends on the CPU: K13's twin at M <= 256, dequantize + einsum
    above; bf16 tolerance."""
    E, K, N = 4, 256, 128
    p, pt, _ = _packed(rng, "nvfp4", K, E * N)
    x3 = rng.standard_normal((M, E, K)).astype(np.float32)
    g = rng.random((M, E)).astype(np.float32)
    js, ts = JSpec(**SPECS["nvfp4"]), TSpec(**SPECS["nvfp4"])
    yj = np.asarray(jb.grouped_qgemm(jnp.asarray(x3, jnp.bfloat16), p, js, (E, K, N))
                    .astype(jnp.float32))
    yt = tb.grouped_qgemm(torch.from_numpy(x3).bfloat16(), pt, ts, (E, K, N))
    assert yt.shape == (M, E, N)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=2e-2 * np.abs(yj).max())
    dj = np.asarray(jb.moe_down_qgemm(jnp.asarray(x3, jnp.bfloat16), p, js, (E, K, N),
                                      jnp.asarray(g, jnp.bfloat16)).astype(jnp.float32))
    dt = tb.moe_down_qgemm(torch.from_numpy(x3).bfloat16(), pt, ts, (E, K, N),
                           torch.from_numpy(g).bfloat16())
    np.testing.assert_allclose(dt.float().numpy(), dj, rtol=0, atol=2e-2 * np.abs(dj).max())


def test_dispatch_takes_the_kernels_at_decode(rng, monkeypatch):
    """At M <= 256 every new format goes through its kernel (the twin on
    the CPU), MoE down projections through K13; above 256 rows none does
    (the reference's dequantize + matmul)."""
    calls = []
    for name in ("w8a16_gemm", "wfp8_gemm", "nvfp4_gemm", "grouped_nvfp4_gemm"):
        real = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    K, N, E = 256, 128, 2
    for M in (8, 300):
        x = torch.randn(M, K).bfloat16()
        for fmt in ("int8", "fp8", "nvfp4"):
            pt = _packed(rng, fmt, K, N)[1]
            tb.qgemm(x, pt, TSpec(**SPECS[fmt]), (K, N))
        pt = _packed(rng, "nvfp4", K, E * N)[1]
        tb.moe_down_qgemm(torch.randn(M, E, K).bfloat16(), pt, TSpec(**SPECS["nvfp4"]),
                          (E, K, N), torch.rand(M, E).bfloat16())
    assert calls == ["w8a16_gemm", "wfp8_gemm", "nvfp4_gemm", "grouped_nvfp4_gemm"]


@pytest.mark.parametrize("E,M,N,K2,want", [
    (1, 8, 4096, 1024, 4),        # decode q: 64 tiles of 64 columns
    (1, 8, 512, 1024, 8),         # decode k / v: 8 tiles
    (1, 8, 2048, 2048, 8),        # decode o: 32 tiles, 16 blocks
    (1, 8, 98304, 1024, 1),       # decode folded gate / up: 1,536 tiles, no split
    (128, 8, 2048, 384, 1),       # K13 at decode: 4,096 tiles of three blocks
    (1, 128, 512, 1024, 8),       # 8 wgmma tiles: a cluster of 8 in one launch
    (1, 128, 98304, 1024, 1),     # 1,536 tiles: no split
    (128, 32, 2048, 384, 1),      # K13, the expert down projection
])
def test_nvfp4_splits_and_cluster_ranks(E, M, N, K2, want):
    """Cluster ranks of an NVFP4 product at path I's shapes (Qwen3-30B-A3B's
    q, k / v, o and folded gate / up, K13's experts; K2 = K / 2): both tiles
    split the blocks over a cluster summed in the same launch (no K split
    and no second launch at any M), only where the tiles are few, never
    with more ranks than blocks."""
    R = tk._nvfp4_ranks(E, M, N, K2)
    assert R == want
    assert R in (1, 2, 4, 8) and R <= K2 // 128


def test_cuda_wrappers_refuse_shapes_they_cannot_take():
    """Off the CPU a wrapper launches its kernel or raises: shapes outside
    the CUDA kernels' tiles (K % 128 for K7/K8, K/2 % 64 for K9/K13,
    N % 64) are refused before any launch, as are wrong dtypes."""
    meta = dict(device="meta")
    x = torch.empty(8, 192, dtype=torch.bfloat16, **meta)
    w8 = torch.empty(192, 128, dtype=torch.int8, **meta)
    with pytest.raises(NotImplementedError, match="K % 128"):
        tk.w8a16_gemm(x, w8, torch.empty(1, 128, **meta))
    x = torch.empty(8, 256, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="wants"):
        tk.wfp8_gemm(x, torch.empty(256, 128, dtype=torch.int8, **meta),
                     torch.empty(1, 1, **meta))
    # the wgmma tile's TMA maps and the decode tile's 16-byte copies need x
    # and W on 16-byte boundaries
    w8 = torch.empty(256 * 128 + 8, dtype=torch.int8, **meta)[8:].view(256, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.w8a16_gemm(x, w8, torch.empty(1, 128, **meta))
    xo = torch.empty(8 * 256 + 4, dtype=torch.bfloat16, **meta)[4:].view(8, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.wfp8_gemm(xo, torch.empty(256, 128, dtype=torch.float8_e4m3fn, **meta),
                     torch.empty(1, 1, **meta))
    with pytest.raises(NotImplementedError, match="K/2 % 64"):
        tk.nvfp4_gemm(torch.empty(8, 192, dtype=torch.bfloat16, **meta),
                      torch.empty(96, 128, dtype=torch.uint8, **meta),
                      torch.empty(12, 128, dtype=torch.float8_e4m3fn, **meta),
                      torch.empty(1, 1, **meta))
    with pytest.raises(NotImplementedError, match="N % 64"):
        tk.grouped_nvfp4_gemm(torch.empty(2, 8, 512, dtype=torch.bfloat16, **meta),
                              torch.empty(256, 2 * 96, dtype=torch.uint8, **meta),
                              torch.empty(32, 2 * 96, dtype=torch.float8_e4m3fn, **meta),
                              torch.empty(1, 1, **meta), 96)


def _bf16_bits(v):
    """f32 values, each exact in bf16, as their bf16 bits."""
    return (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _bf16_value(bits):
    """bf16 bits as f64 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_byte_operands_exhaustive(fmt):
    """The exact byte -> bf16 identities K7's and K8's CUDA fragments rest
    on (csrc/w8a16_gemm.cu), over every code, bit for bit against the
    reference's ``astype(bfloat16)`` of the same bytes. int8: the byte b
    under 0x43 is the bf16 v = 2^s (128 + (b & 0x7F)), s its sign bit, and
    one bf16 fma v * (s ? .5 : 1) + (s ? -256 : -128), factor and addend
    built from s by bit operations, gives b (an integer of at most 8 bits:
    the fma rounds nothing). e4m3 (its 254 codes without NaN): the card's
    e4m3x2 -> f16x2 conversion (exact; modelled by the reference's f16
    cast), then the f16 bits shifted right by 3 under 0x0FFF, with the sign
    kept, are the bf16 of 2^-112 times the value, a normal bf16 (or zero),
    and one bf16 multiply by 2^112 gives the value."""
    u8 = np.arange(256, dtype=np.uint8)
    if fmt == "int8":
        want = _bf16_bits(np.asarray(jnp.asarray(u8.view(np.int8)).astype(jnp.bfloat16)
                                     .astype(jnp.float32)))
        v = 0x4300 | u8.astype(np.uint16)
        s = v & 0x0080
        got = _bf16_value(v) * _bf16_value(s ^ 0x3F80) + _bf16_value(s | 0xC300)
        np.testing.assert_array_equal(got, u8.view(np.int8).astype(np.float64))
    else:
        u8 = u8[(u8 & 0x7F) != 0x7F]
        assert u8.size == 254
        codes = jnp.asarray(u8.view(jnp.float8_e4m3fn))
        want = _bf16_bits(np.asarray(codes.astype(jnp.bfloat16).astype(jnp.float32)))
        h = np.asarray(codes.astype(jnp.float16)).view(np.uint16).astype(np.uint32)
        t = ((h >> 3) & 0x0FFF) | (h & 0x8000)
        assert np.all(((t & 0x7F80) != 0) | ((t & 0x7FFF) == 0))  # no bf16 subnormal
        got = _bf16_value(t) * _bf16_value(0x7780)
        assert _bf16_value(0x7780) == 2.0**112
    # every result is exact in bf16: its bits are the reference's
    assert np.all(_bf16_value(_bf16_bits(got)) == got)
    np.testing.assert_array_equal(_bf16_bits(got), want)


@pytest.mark.parametrize("M,N,K,want", [
    (8, 6144, 4096, 4),      # Llama-3-8B fused qkv: 48 decode tiles of 128 columns
    (8, 4096, 4096, 8),      # o: 32 tiles
    (8, 28672, 4096, 1),     # fused gate_up: 224 tiles
    (8, 4096, 14336, 8),     # down: 32 tiles, 112 blocks
    (32, 6144, 4096, 4),     # the 32-row prefill bucket: one token tile of the wgmma tile
    (32, 4096, 4096, 8),
    (32, 28672, 4096, 1),
    (32, 4096, 14336, 8),
    (128, 6144, 4096, 1),    # the FP8 parity's prefill: 96 tiles of 64 tokens, one CTA an SM
    (128, 4096, 4096, 2),
    (128, 28672, 4096, 1),
    (128, 4096, 14336, 2),
    (1, 64, 256, 2),         # one tile, two blocks: never more ranks than blocks
])
def test_byte_gemm_cluster_ranks(M, N, K, want):
    """K7 / K8's cluster size (CTAs that split one output tile's 128-row
    blocks, summed in one launch) at paths G's and H's shapes: up to two
    CTAs an SM while one token tile covers M, one above; the few-tile
    projections split, the many-tile ones do not, and no rank is left
    without a block."""
    R = tk._byte_ranks(M, N, K)
    assert R == want
    assert R <= K // 128 and R in (1, 2, 4, 8)


def _rank_split(x, data, scale, R, out_dtype):
    """K7 / K8's arithmetic on a cluster of R CTAs, in f32 on the CPU: rank r
    multiplies bf16 x by the exact bf16 weights over its contiguous run of
    the 128-row blocks [r nblk / R, (r + 1) nblk / R), the ranks' partials
    are summed in rank order, and the scale multiplies the sum once."""
    xb = x.to(torch.bfloat16).float()
    w = data.float()
    nblk = data.shape[0] // 128
    acc = None
    for r in range(R):
        rows = slice(r * nblk // R * 128, (r + 1) * nblk // R * 128)
        part = xb[:, rows] @ w[rows]
        acc = part if acc is None else acc + part
    return (acc * scale.float().reshape(1, -1)).to(out_dtype)


@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_byte_gemm_rank_split_matches_twin_and_pallas(rng, interp, fmt, R):
    """The cluster split's order of sums (partials over contiguous runs of
    blocks, summed in rank order, the scale once after the sum) stays within
    the order bar of the twin, and of the Pallas kernel in interpret mode at
    ``test_byte_gemm_plain_matches_pallas``'s tolerance."""
    K, N, M = 1024, 128, 8
    p, pt, wd = _packed(rng, fmt, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    for out in ("f32", "bf16"):
        jdt, tdt = _dtypes(out)
        ys = _rank_split(xt, pt["data"], pt["scale"], R, tdt)
        plain = tk.w8a16_gemm_plain if fmt == "int8" else tk.wfp8_gemm_plain
        yp = plain(xt, pt["data"], pt["scale"], out_dtype=tdt)
        jfn = jk.w8a16_gemm if fmt == "int8" else jk.wfp8_gemm
        yj = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16), p["data"], p["scale"],
                            out_dtype=jdt).astype(jnp.float32))
        bar = order_bar(yj, _bf16(x), wd, out)
        assert ys.dtype == tdt and ys.shape == (M, N)
        np.testing.assert_allclose(ys.float().numpy(), yp.float().numpy(), rtol=0, atol=bar)
        np.testing.assert_allclose(ys.float().numpy(), yj, rtol=0, atol=bar)


def _nvfp4_rank_split(x3, packed, scale, scale2, n, R, out_dtype):
    """K9 / K13's arithmetic on a cluster of R CTAs, in f32 on the CPU: rank
    r multiplies bf16 x by the exact scaled weights (e2m1 times its e4m3
    block scale) of its contiguous run of the 128-row packed blocks
    [r nblk / R, (r + 1) nblk / R), both halves of K, the ranks' partials
    are summed in rank order, and scale2 multiplies the sum once."""
    E, _, K = x3.shape
    K2 = K // 2
    xb = x3.to(torch.bfloat16).float()
    w = tk.nvfp4_unit_weights(packed, scale).reshape(K, E, n).transpose(0, 1)
    nblk = K2 // 128
    acc = None
    for r in range(R):
        lo = torch.arange(r * nblk // R * 128, (r + 1) * nblk // R * 128)
        rows = torch.cat([lo, K2 + lo])
        part = torch.bmm(xb[:, :, rows], w[:, rows])
        acc = part if acc is None else acc + part
    return (acc * scale2.float().reshape(1, 1, 1)).to(out_dtype)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("grouped", [False, True])
def test_nvfp4_rank_split_matches_twin_and_pallas(rng, interp, grouped, M):
    """The order of sums of K9's and K13's cluster split (R = 1, 2, 8:
    partials over contiguous runs of blocks, summed in rank order, scale2
    once after the sum) stays within the order bar of the twin, and of the
    Pallas kernel in interpret mode at ``test_nvfp4_plain_matches_pallas``'s
    tolerance, plain and grouped (E = 2), f32 and bf16 out."""
    K, N = 2048, 128  # eight 128-row blocks: one a rank at R = 8
    E = 2 if grouped else 1
    p, pt, wd = _packed(rng, "nvfp4", K, E * N)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    for out in ("f32", "bf16"):
        jdt, tdt = _dtypes(out)
        xj = jnp.asarray(x, jnp.bfloat16)
        if grouped:
            yj = jk.grouped_nvfp4_gemm(xj, p["data"], p["scale"], p["scale2"], N, out_dtype=jdt)
            yp = tk.grouped_nvfp4_gemm_plain(xt, pt["data"], pt["scale"], pt["scale2"], N,
                                             out_dtype=tdt)
        else:
            yj = jk.nvfp4_gemm(xj[0], p["data"], p["scale"], p["scale2"], out_dtype=jdt)[None]
            yp = tk.nvfp4_gemm_plain(xt[0], pt["data"], pt["scale"], pt["scale2"],
                                     out_dtype=tdt)[None]
        yj = np.asarray(yj.astype(jnp.float32))
        for R in (1, 2, 8):
            ys = _nvfp4_rank_split(xt, pt["data"], pt["scale"], pt["scale2"], N, R, tdt)
            assert ys.dtype == tdt and ys.shape == (E, M, N)
            for e in range(E):
                bar = order_bar(yj[e], _bf16(x[e]), wd[:, e * N:(e + 1) * N], out)
                np.testing.assert_allclose(ys[e].float().numpy(), yp[e].float().numpy(), rtol=0,
                                           atol=bar)
                np.testing.assert_allclose(ys[e].float().numpy(), yj[e], rtol=0, atol=bar)


def test_nvfp4_operands_exhaustive():
    """The exact e2m1 -> bf16 identity K9's and K13's CUDA fragments rest on
    (csrc/nvfp4_gemm.cu, ``e2m1x2_to_bf16x2``), over every pair of packed
    bytes and both halves, against the reference's decode: the bytes at
    bits 0-7 and 16-23 of a word, masked to their low (high) nibbles and
    multiplied by 4160 (260), then masked by 0x81C081C0, hold in each 16-bit
    lane the bf16 of 2^-126 times the code's value (a subnormal for codes 0
    and 1); one bf16 multiply by 2^126 gives the value. Times every e4m3
    block scale (its 254 codes without NaN) the weight is exact in bf16."""
    b = np.arange(256, dtype=np.uint32)
    q = (b[:, None] | (b[None, :] << 16)).ravel()  # every pair of bytes
    codes = np.arange(16, dtype=np.int32)
    ref = np.asarray(jk._decode_e2m1(jnp.asarray(codes))).astype(np.float64)
    for half, mask, mul in ((0, 0x000F000F, 4160), (1, 0x00F000F0, 260)):
        v = ((q & mask) * mul) & 0x81C081C0
        for lane in (0, 1):
            lane_bits = (v >> (16 * lane)) & 0xFFFF
            got = _bf16_value(lane_bits) * 2.0**126
            code = (q >> (16 * lane + 4 * half)) & 0xF
            np.testing.assert_array_equal(got, ref[code])
    u8 = np.arange(256, dtype=np.uint8)
    u8 = u8[(u8 & 0x7F) != 0x7F]
    scales = np.asarray(jnp.asarray(u8.view(jnp.float8_e4m3fn)).astype(jnp.float32))
    weights = ref[:, None] * scales[None, :].astype(np.float64)
    assert np.all(_bf16_value(_bf16_bits(weights.astype(np.float32))) == weights)
