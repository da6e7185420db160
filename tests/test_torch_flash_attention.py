"""K4 flash_prefill_attention: the port's plain version (what the CUDA
kernel is held to on the card) against the JAX Pallas kernel in interpret
mode, with chunks that start past 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import flash_attention as jf
from modelopt_tpu_torch.kernels import flash_attention as tf


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


@pytest.mark.parametrize("kind,tol", [("bf16", 2e-2), ("int8", 3e-2)])
def test_flash_prefill_plain_matches_pallas(rng, interp, kind, tol):
    """Same math on both sides (bf16 operands, f32 sums, -1e9 mask); the
    bars are the reference suite's (test_flash_attention.py:91,110)."""
    B, T, KH, G, D, S = 2, 64, 2, 2, 64, 256
    q = rng.standard_normal((B, T, KH, G, D)).astype(np.float32)
    start = np.asarray([32, 100], np.int32)
    if kind == "int8":
        ck = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        cv = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        ks, vs = 0.011, 0.017
        ckj, cvj = jnp.asarray(ck), jnp.asarray(cv)
        ckt, cvt = torch.from_numpy(ck), torch.from_numpy(cv)
    else:
        ck = rng.standard_normal((B, S, KH * D)).astype(np.float32)
        cv = rng.standard_normal((B, S, KH * D)).astype(np.float32)
        ks = vs = None
        ckj, cvj = jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16)
        ckt, cvt = torch.from_numpy(ck).bfloat16(), torch.from_numpy(cv).bfloat16()
    want = jf.flash_prefill_attention(jnp.asarray(q), ckj, cvj, jnp.asarray(start),
                                      k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    got = tf.flash_prefill_attention(torch.from_numpy(q), ckt, cvt,
                                     torch.from_numpy(start), k_scale=ks, v_scale=vs,
                                     out_dtype=torch.float32)
    assert got.shape == (B, T, KH, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
