"""K4 flash_prefill_attention and K14 flash_attention: the port's plain
versions (what the CUDA kernels are held to on the card) against the JAX
Pallas kernels in interpret mode: K4 with chunks that start past 0, and at
the served head geometry (D = 128, G = 4 and 8) with a chunk at start 0, one
that ends at the cache's last row and a ragged row count; K14 causal, with
a window and sinks, with rows not a multiple of the tile, at G = 1 and 4,
and at D = 128, G = 4 in bf16; K14's gradient against ``jax.grad`` of the
reference's."""

import jax
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


# (T, KH, G, D, S, starts): a small chunk past 0, then the served head geometry
# (D = 128, Llama-3-8B's G = 4 and Qwen3-30B-A3B's G = 8) with a chunk at
# start 0, a chunk that ends at row S - 1, and a ragged T * G (not a multiple
# of the card's 64-row tile)
PREFILL_SMALL = (64, 2, 2, 64, 256, (32, 100))
PREFILL_SERVED = {
    "G4-start0": (64, 2, 4, 128, 256, (0, 0)),
    "G8-ends-at-S": (64, 1, 8, 128, 256, (192, 100)),
    "G4-ragged": (41, 2, 4, 128, 256, (0, 215)),
    "G8-ragged": (33, 1, 8, 128, 256, (64, 223)),
}


@pytest.mark.parametrize("kind,tol,geom", [
    pytest.param("bf16", 2e-2, PREFILL_SMALL, id="bf16-0.02"),
    pytest.param("int8", 3e-2, PREFILL_SMALL, id="int8-0.03"),
] + [pytest.param(kind, tol, geom, id=f"{kind}-{name}")
     for kind, tol in (("bf16", 2e-2), ("int8", 3e-2)) for name, geom in PREFILL_SERVED.items()])
def test_flash_prefill_plain_matches_pallas(rng, interp, kind, tol, geom):
    """Same math on both sides (bf16 operands, f32 sums, -1e9 mask); the
    bars are the reference suite's (test_flash_attention.py:91,110)."""
    T, KH, G, D, S, starts = geom
    B = 2
    q = rng.standard_normal((B, T, KH, G, D)).astype(np.float32)
    start = np.asarray(starts, np.int32)
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


@pytest.mark.parametrize("T,G,window,sink,dtype,D", [
    pytest.param(128, 4, None, 0, "f32", 64, id="128-4-None-0-f32"),  # causal
    # sliding window with sink tokens
    pytest.param(128, 4, 32, 4, "f32", 64, id="128-4-32-4-f32"),
    # T * G rows not a multiple of the 64-row tile
    pytest.param(96, 4, None, 0, "f32", 64, id="96-4-None-0-f32"),
    pytest.param(128, 1, None, 0, "f32", 64, id="128-1-None-0-f32"),  # G = 1
    pytest.param(256, 4, 64, 2, "bf16", 64, id="256-4-64-2-bf16"),  # bf16 in and out
    # the served geometry (J's calibration: D = 128, G = 4, bf16) with T * G
    # = 400 and 1000 rows, not multiples of the card's 64-row tile
    pytest.param(100, 4, None, 0, "bf16", 128, id="100-4-None-0-bf16-D128"),
    pytest.param(250, 4, None, 0, "bf16", 128, id="250-4-None-0-bf16-D128"),
])
def test_flash_attention_plain_matches_pallas(rng, interp, T, G, window, sink, dtype, D):
    """The twin computes the TPU kernel's one-pass f32 softmax: within 1e-5
    of it in f32 (summation order only), one bf16 output ulp in bf16."""
    B, KH = 2, 2
    q = rng.standard_normal((B, T, KH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    # the reference's q tile: 64 rows (and at T * G = 1000, a padded last tile)
    want = jf.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), True, window, sink, 64)
    got = tf.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=True,
                             window=window, sink=sink)
    assert got.shape == q.shape and got.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("window,sink", [(None, 0), (8, 2)])
def test_flash_attention_gradient_matches_jax(rng, interp, window, sink):
    """The autograd function's backward recomputes through the reference's
    einsum formulation, as its custom_vjp does: gradients of sum(out^2)
    against ``jax.grad`` of the Pallas-backed function at 2e-3."""
    B, T, KH, G, D = 1, 32, 1, 2, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, KH, G, D), (B, T, KH, D), (B, T, KH, D)))

    def loss(q, k, v):
        return jnp.sum(jf.flash_attention(q, k, v, True, window, sink, 64) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tf.flash_attention(*leaves, causal=True, window=window, sink=sink) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)


def test_flash_attention_rule_and_refusals():
    """``flash_attention_ok`` is the reference's shape rule plus the card
    kernel's widths (``tests/test_torch_kernel_gates.py``); the wrapper
    refuses mismatched shapes."""
    assert tf.flash_attention_ok(1024, 1024, 128)
    assert not tf.flash_attention_ok(272, 272, 128)     # S % 128
    assert not tf.flash_attention_ok(256, 256, 16)      # D % 64
    assert not tf.flash_attention_ok(16384, 16384, 64)  # S > 8192
    with pytest.raises(ValueError):
        tf.flash_attention(torch.zeros(1, 4, 1, 1, 64), torch.zeros(1, 4, 2, 64),
                           torch.zeros(1, 4, 2, 64))
