"""Packed int4 format of the PyTorch port against the JAX reference:
pack, unpack and quantize bit-exact in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu_torch.quant import qtensor as tq


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,N", [(256, 128), (704, 64)])
def test_pack_unpack_bit_exact(rng, K, N):
    q = rng.integers(-8, 8, (K, N)).astype(np.int32)
    pj = np.asarray(jq.pack_int4(jnp.asarray(q)))
    pt = tq.pack_int4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(pj, pt)
    # each side unpacks the other's bytes to the original codes
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(pj.copy())).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jq.unpack_int4(jnp.asarray(pt))), q)


@pytest.mark.parametrize("block", [64, 128])
def test_quantize_int4_bit_exact(rng, block):
    w = rng.standard_normal((512, 192)).astype(np.float32)
    pj = jq.quantize_int4(jnp.asarray(w), block=block)
    pt = tq.quantize_int4(torch.from_numpy(w), block=block)
    np.testing.assert_array_equal(np.asarray(pj["data"]), pt["data"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["scale"]), pt["scale"].numpy())


def test_cross_dequantize_identical(rng):
    """A weight packed by either package dequantizes identically on the other."""
    w = rng.standard_normal((256, 128)).astype(np.float32)
    pj = jq.quantize_int4(jnp.asarray(w))
    pt = tq.quantize_int4(torch.from_numpy(w))
    from_j = tq.dequantize_int4({k: torch.from_numpy(np.array(v)) for k, v in pj.items()})
    from_t = jq.dequantize_int4({k: jnp.asarray(v.numpy()) for k, v in pt.items()})
    np.testing.assert_array_equal(from_j.numpy(), np.asarray(from_t))
    np.testing.assert_array_equal(from_j.numpy(), np.asarray(jq.dequantize_int4(pj)))


def test_int8_per_channel_bit_exact(rng):
    w = rng.standard_normal((128, 96)).astype(np.float32)
    pj = jq.quantize_int8(jnp.asarray(w))
    pt = tq.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(pj["data"]), pt["data"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["scale"]), pt["scale"].numpy())


@pytest.mark.parametrize("K,N", [(384, 64), (1408, 32)])
def test_straddle_pack_quantize_dequantize_bit_exact(rng, K, N):
    """K % 128 == 0 with (K/2) % 128 == 64 (DeepSeek's expert width 1408):
    one scale block straddles the split-half boundary. Codes, scales and
    dequantized weights are bit-identical both ways."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    pj = jq.quantize_int4(jnp.asarray(w), block=128)
    pt = tq.quantize_int4(torch.from_numpy(w), block=128)
    np.testing.assert_array_equal(np.asarray(pj["data"]), pt["data"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["scale"]), pt["scale"].numpy())
    assert pt["scale"].shape == (K // 128, N)
    np.testing.assert_array_equal(tq.unpack_int4(pt["data"]).numpy(),
                                  np.asarray(jq.unpack_int4(pj["data"])))
    np.testing.assert_array_equal(tq.dequantize_int4(pt).numpy(),
                                  np.asarray(jq.dequantize_int4(pj)))


def test_straddle_folded_experts_bit_exact(rng):
    """The folded expert view [in, E*out] of straddle-shaped experts
    (in = 384) packs as the reference's compress packs it, and each
    expert's dequantized columns unfold to its own [in, out]."""
    E, fin, fout = 3, 384, 32
    w = rng.standard_normal((E, fin, fout)).astype(np.float32)
    folded = tq.fold_experts(torch.from_numpy(w))
    pj = jq.quantize_int4(jnp.asarray(w.transpose(1, 0, 2).reshape(fin, E * fout)))
    pt = tq.quantize_int4(folded)
    np.testing.assert_array_equal(np.asarray(pj["data"]), pt["data"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["scale"]), pt["scale"].numpy())
    per_expert = tq.unfold_experts(tq.dequantize_int4(pt), E)
    for e in range(E):
        own = tq.dequantize_int4(tq.quantize_int4(torch.from_numpy(w[e])))
        np.testing.assert_array_equal(per_expert[e].numpy(), own.numpy())


@pytest.mark.parametrize("K", [256, 384, 1408, 10944, 320])
def test_compressible_format_follows_reference(K):
    """int4 packs whole scale blocks of even K (``need_half=False``): the
    straddle shapes pack, K=10944 and K=320 (K % 128 == 64) do not, in both
    packages."""
    from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
    from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec

    want = jq.compressible_format(JSpec(num_bits=4, block={-2: 128}), (K, 64))
    got = tq.compressible_format(TSpec(num_bits=4, block={-2: 128}), (K, 64))
    assert got == want == ("int4" if K % 128 == 0 else None)
