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


@pytest.mark.parametrize("M", [1, 8, 300])
def test_w4a8_straddle_plain_matches_pallas(rng, interp, M):
    """K=384 (K/2 % 128 == 64): one scale block straddles the split-half
    boundary. The twin takes the reference's straddle order (low-half
    blocks, the straddle block's two integer dots summed under one scale
    row, then the high-half blocks shifted by 64 rows); held at the
    reference suite's bar like the aligned shapes."""
    K, N = 384, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    yj = np.asarray(jk.w4a8_gemm(jnp.asarray(xq), p["data"], p["scale"], block=128))
    yt = tk.w4a8_gemm(torch.from_numpy(xq), torch.from_numpy(np.array(p["data"])),
                      torch.from_numpy(np.array(p["scale"])), block=128)
    assert yt.shape == (M, N)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-4, atol=1e-2)


def test_w4a8_straddle_refused(rng):
    """The CUDA K1 does not take straddle shapes yet: a tensor off the CPU
    with K/2 % 128 != 0 is refused before any launch (the twin above
    computes them on the CPU)."""
    p = tq.quantize_int4(torch.randn(384, 128))
    x = torch.empty(2, 384, dtype=torch.int8, device="meta")
    with pytest.raises(NotImplementedError, match="straddl"):
        tk.w4a8_gemm(x, p["data"].to("meta"), p["scale"].to("meta"))


def test_block_dots_straddle_order(rng):
    """The straddle order spelled out with the integer dots: acc over the
    low-half block, then the straddle block (low tail + high head under
    scale row 1), then the high-half block under scale row 2, each added
    in f32 as ``acc + q*s``: bit for bit."""
    K, N, M = 384, 64, 3
    qt = tq.quantize_int4(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)))
    x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.float32))
    q = tq.unpack_int4(qt["data"]).float()  # rows in original order
    s = qt["scale"]
    acc = torch.zeros(M, N)
    acc = acc + (x[:, :128] @ q[:128]) * s[0:1]
    acc = acc + (x[:, 128:192] @ q[128:192] + x[:, 192:256] @ q[192:256]) * s[1:2]
    acc = acc + (x[:, 256:] @ q[256:]) * s[2:3]
    assert torch.equal(tk.w4a8_gemm_plain(x.to(torch.int8), qt["data"], qt["scale"]), acc)


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
    """int8 per-channel weights with bf16 activations (K7 w8a16_gemm; its
    twin on the CPU) match the reference's CPU dequantize + matmul at bf16
    tolerance. The one qgemm route still without a ported kernel, int8
    weights with int8 activations above 256 rows (the reference's
    int8_dynamic_gemm), dequantizes on the CPU only and raises on any other
    device rather than let a library matmul stand in for the kernel."""
    K, N = 256, 128
    x = rng.standard_normal((4, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    p = jq.quantize_int8(jnp.asarray(w))
    jspec = QuantizerSpec(num_bits=8, axis=(-1,))
    yj = np.asarray(jb.qgemm(jnp.asarray(x, jnp.bfloat16), p, jspec, (K, N))
                    .astype(jnp.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    spec = TSpec(num_bits=8, axis=(-1,))
    yt = tb.qgemm(torch.from_numpy(x).bfloat16(), pt, spec, (K, N)).float().numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-2 * np.abs(yj).max())
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        tb.qgemm(torch.empty(300, K, dtype=torch.bfloat16, device="meta"), pt, spec, (K, N),
                 act_int8=True)


def test_packed_byte_operands_exhaustive():
    """The operand identities K1's CUDA tiles rest on, over every packed
    byte: each (q_lo, q_hi) pair in [-8, 7]^2 packed by the port's pack_int4
    (byte for byte the JAX package's) gives one of the 256 byte values b,
    and (b & 0x0F) == q_lo + 8 (the decode tile's dp4a operand, corrected
    by 8 * sum(x)), int8(b & 0xF0) == 16 * q_hi (the high half's operand in
    both tiles), int8(((b << 4) & 0xF0) ^ 0x80) == 16 * q_lo (the low half's
    operand in the tensor-core tile)."""
    qlo, qhi = (g.reshape(1, 256) for g in torch.meshgrid(
        torch.arange(-8, 8), torch.arange(-8, 8), indexing="ij"))
    q = torch.cat([qlo, qhi])                                # K = 2, N = 256
    b = tq.pack_int4(q)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q.numpy()))))
    b = b[0].to(torch.int32)
    assert sorted(b.tolist()) == list(range(256))

    def as_int8(x):
        return x.to(torch.uint8).view(torch.int8).to(torch.int32)

    assert torch.equal(b & 0x0F, qlo[0] + 8)
    assert torch.equal(as_int8(b & 0xF0), 16 * qhi[0])
    assert torch.equal(as_int8(((b << 4) & 0xF0) ^ 0x80), 16 * qlo[0])
