"""K12 grouped_w4a8_combine_gemm: the port's plain twin (what the CUDA
kernel is held to on the card) against the JAX Pallas kernel in interpret
mode; grouped_qgemm and moe_down_qgemm against the JAX backends on the CPU
at M <= 256 and M > 256, and the dispatch that sends decode shapes to the
kernels (K10's twin is held to JAX in test_torch_w4a16.py)."""

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


def _packed(rng, E, K, N):
    """A folded expert weight [K, E*N] packed by the reference."""
    w = rng.standard_normal((K, E * N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("M", [3, 8])
def test_grouped_w4a8_combine_plain_matches_pallas(rng, interp, M):
    """Exact integer dots on both sides; the f32 block-scale and combine
    sums run in another order (the Pallas grid tiles N and revisits the
    output per expert), hence the reference suite's bar
    (tests/unit/kernels/test_quant_gemm.py:265): rtol 1e-4, atol 1e-2."""
    E, K, N = 4, 256, 128
    p, pt = _packed(rng, E, K, N)
    xq = rng.integers(-127, 128, (E, M, K)).astype(np.int8)
    gs = rng.standard_normal((E, M)).astype(np.float32)
    yj = np.asarray(jk.grouped_w4a8_combine_gemm(jnp.asarray(xq), jnp.asarray(gs), p["data"],
                                                 p["scale"], N, block=128))
    yt = tk.grouped_w4a8_combine_gemm(torch.from_numpy(xq), torch.from_numpy(gs),
                                      pt["data"], pt["scale"], N)
    assert yt.shape == (M, N) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-4, atol=1e-2)


def test_grouped_w4a8_combine_is_expert_order_sum(rng):
    """The twin is the per-expert K1 product gated and summed in expert
    order, bit for bit (the order the CUDA kernel keeps)."""
    E, K, N, M = 3, 256, 64, 5
    _, pt = _packed(rng, E, K, N)
    xq = torch.from_numpy(rng.integers(-127, 128, (E, M, K)).astype(np.int8))
    gs = torch.from_numpy(rng.standard_normal((E, M)).astype(np.float32))
    want = torch.zeros(M, N)
    for e in range(E):
        cols = slice(e * N, (e + 1) * N)
        y = tk.w4a8_gemm(xq[e], pt["data"][:, cols].contiguous(),
                         pt["scale"][:, cols].contiguous())
        want = want + y * gs[e][:, None]
    assert torch.equal(tk.grouped_w4a8_combine_gemm(xq, gs, pt["data"], pt["scale"], N), want)


def _reference_args(rng, M, E=4, K=256, N=128):
    p, pt = _packed(rng, E, K, N)
    x3 = rng.standard_normal((M, E, K)).astype(np.float32)
    g = rng.random((M, E)).astype(np.float32)
    return p, pt, x3, g, (E, K, N)


@pytest.mark.parametrize("M", [8, 300])
@pytest.mark.parametrize("act_int8", [True, False])
def test_moe_down_qgemm_matches_reference(rng, M, act_int8):
    """Down-projection + routed combine against the reference's CPU path
    (per-(token, expert) int8 fake-quant under W4A8, bf16-rounded dequantized
    weights, bf16 einsums). The port takes the kernels' arithmetic at
    M <= 256 (K12 fused, or K10 then the combine einsum) and the reference's
    own dequantize + product steps above. Held at bf16 tolerance (2e-2 of
    the output scale)."""
    p, pt, x3, g, efn = _reference_args(rng, M)
    yj = np.asarray(jb.moe_down_qgemm(jnp.asarray(x3, jnp.bfloat16), p, SPEC, efn,
                                      jnp.asarray(g, jnp.bfloat16), act_int8=act_int8,
                                      act_raw=act_int8).astype(jnp.float32))
    yt = tb.moe_down_qgemm(torch.from_numpy(x3).bfloat16(), pt, TSPEC, efn,
                           torch.from_numpy(g).bfloat16(), act_int8=act_int8,
                           act_raw=act_int8)
    assert yt.shape == (M, efn[2]) and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=2e-2 * np.abs(yj).max())


@pytest.mark.parametrize("M,act_int8", [(8, False), (300, False), (300, True), (8, True)])
def test_grouped_qgemm_matches_reference(rng, M, act_int8):
    """Per-expert products without gates, [M, E, N]: weight-only rides K10
    at M <= 256; above 256 rows (and, on the CPU only, int8 activations at
    M <= 256, whose kernel K11 is not ported) the reference's dequantize +
    product steps. bf16 tolerance as above."""
    p, pt, x3, _, efn = _reference_args(rng, M)
    yj = np.asarray(jb.grouped_qgemm(jnp.asarray(x3, jnp.bfloat16), p, SPEC, efn,
                                     act_int8=act_int8, act_raw=act_int8)
                    .astype(jnp.float32))
    yt = tb.grouped_qgemm(torch.from_numpy(x3).bfloat16(), pt, TSPEC, efn,
                          act_int8=act_int8, act_raw=act_int8)
    assert yt.shape == (M, efn[0], efn[2])
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=2e-2 * np.abs(yj).max())


def test_dispatch_sends_decode_shapes_to_the_kernels(rng, monkeypatch):
    """At M <= 256 the W4A8 down-projection with gates is one K12 call and
    the weight-only one a K10 call; above 256 rows neither runs."""
    calls = []
    for name in ("grouped_w4a8_combine_gemm", "grouped_w4a16_gemm"):
        real = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    _, pt, x3, g, efn = _reference_args(rng, 300)
    x3, g = torch.from_numpy(x3).bfloat16(), torch.from_numpy(g).bfloat16()
    for M in (8, 300):
        for act in (True, False):
            tb.moe_down_qgemm(x3[:M], pt, TSPEC, efn, g[:M], act_int8=act, act_raw=act)
    assert calls == ["grouped_w4a8_combine_gemm", "grouped_w4a16_gemm"]


def test_routes_without_a_kernel_raise_off_cpu():
    """On a tensor off the CPU, a grouped product without a ported kernel
    raises: int8 activations without gates at M <= 256 (K11) and formats
    other than int4; int4 above 256 rows is allowed (the reference's XLA
    steps)."""
    E, K, N = 2, 256, 128
    pt = tq.quantize_int4(torch.randn(K, E * N))
    x3 = torch.empty(8, E, K, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        tb.grouped_qgemm(x3, pt, TSPEC, (E, K, N), act_int8=True, act_raw=True)
    p8 = tq.quantize_int8(torch.randn(K, E * N))
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        tb.grouped_qgemm(x3, p8, TSpec(num_bits=8, axis=(-1,)), (E, K, N))
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        tb.moe_down_qgemm(x3, p8, TSpec(num_bits=8, axis=(-1,)), (E, K, N),
                          torch.empty(8, E, device="meta"))
