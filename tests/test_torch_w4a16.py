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


def test_w4a16_straddle_refused():
    """K/2 % block != 0 is not ported: the wrapper raises instead of
    computing something else."""
    p = tq.quantize_int4(torch.randn(704, 128), block=64)
    with pytest.raises(NotImplementedError, match="straddl"):
        tk.w4a16_gemm(torch.zeros(2, 704), p["data"], p["scale"], block=64)


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
