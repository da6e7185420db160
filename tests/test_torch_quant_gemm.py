"""K1 w4a8_gemm: the port's plain version (what the CUDA kernel is held to
on the card) against the JAX Pallas kernel in interpret mode; qgemm against
the JAX qgemm on the CPU."""

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


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("M", [1, 8, 300])
def test_w4a8_plain_matches_pallas(rng, interp, M):
    """Integer dots are exact on both sides; the f32 block-scale sums run in
    a different order (the Pallas decode grid tiles K), hence the reference
    suite's bar (test_quant_gemm.py:55): rtol 1e-4, atol 1e-2. M=300 crosses
    the M>256 rule (output written in out_dtype)."""
    K, N = 512, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    yj = np.asarray(jk.w4a8_gemm(jnp.asarray(xq), p["data"], p["scale"], block=128))
    yt = tk.w4a8_gemm(torch.from_numpy(xq), torch.from_numpy(np.array(p["data"])),
                      torch.from_numpy(np.array(p["scale"])), block=128)
    assert yt.dtype == torch.float32 and yt.shape == (M, N)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-4, atol=1e-2)


def test_w4a8_straddle_refused(rng):
    """K/2 % block != 0 (K=1408-style straddle blocks) is not ported: the
    wrapper raises instead of computing something else."""
    p = tq.quantize_int4(torch.randn(704, 128), block=64)
    with pytest.raises(NotImplementedError, match="straddl"):
        tk.w4a8_gemm(torch.zeros(2, 704, dtype=torch.int8), p["data"], p["scale"], block=64)


@pytest.mark.parametrize("M", [4, 300])
def test_qgemm_matches_reference(rng, M):
    """The reference's CPU qgemm fake-quantizes x per token and multiplies
    bf16 x by the bf16-rounded dequantized weight; the port runs the exact
    int8 x int4 product with f32 scales (the card's arithmetic). Both
    approximate the same W4A8 product: held at bf16 tolerance (2^-8 of the
    output scale, plus the weight's bf16 rounding summed over K)."""
    K, N = 256, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w))
    yj = np.asarray(jb.qgemm(jnp.asarray(x, jnp.bfloat16), p, SPEC, (K, N),
                             act_int8=True, act_raw=True).astype(jnp.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    yt = tb.qgemm(torch.from_numpy(x).bfloat16(), pt, TSpec(num_bits=4, block={-2: 128}),
                  (K, N), act_int8=True, act_raw=True).float().numpy()
    scale = np.abs(yj).max()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-2 * scale)


def test_qgemm_dequantize_path_is_cpu_only(rng):
    """Formats without a ported kernel (here int4 weights with bf16
    activations, the TPU's w4a16_gemm) take dequantize + matmul on the CPU,
    matching the reference at bf16 tolerance; on any other device they
    raise rather than let a library matmul stand in for the kernel."""
    K, N = 256, 128
    x = rng.standard_normal((4, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int4(jnp.asarray(w))
    yj = np.asarray(jb.qgemm(jnp.asarray(x, jnp.bfloat16), p, SPEC, (K, N))
                    .astype(jnp.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    spec = TSpec(num_bits=4, block={-2: 128})
    yt = tb.qgemm(torch.from_numpy(x).bfloat16(), pt, spec, (K, N)).float().numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-2 * np.abs(yj).max())
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        tb.qgemm(torch.empty(4, K, dtype=torch.bfloat16, device="meta"), pt, spec, (K, N))
