"""K3 dense_kv_write and K2 fused_decode_attention: the port's plain
versions (what the CUDA kernels are held to on the card) against the JAX
kernels — the XLA path of dense_kv_write, the Pallas fused decode kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import attention as ja
from modelopt_tpu_torch.kernels import attention as ta


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


@pytest.mark.parametrize("start", [[0, 5], [3, 60]])  # 60 + T > S: clamped
def test_dense_kv_write_bit_exact(rng, start):
    B, S, T, KHD = 2, 64, 8, 128
    cache = rng.integers(-127, 128, (B, S, KHD)).astype(np.int8)
    vals = rng.integers(-127, 128, (B, T, KHD)).astype(np.int8)
    st = np.asarray(start, np.int32)
    want = np.asarray(ja.dense_kv_write(jnp.asarray(cache), jnp.asarray(vals), jnp.asarray(st)))
    got = ta.dense_kv_write(torch.from_numpy(cache.copy()), torch.from_numpy(vals),
                            torch.from_numpy(st)).numpy()
    np.testing.assert_array_equal(got, want)


def _dequant_ref(q, k, v, pos, kn, vn):
    """Float attention of q over keys [0, pos] with the new row at pos."""
    B, KH, G, D = q.shape
    out = np.zeros((B, KH, G, D), np.float32)
    for b in range(B):
        L = int(pos[b])
        kk = np.concatenate([k[b, :L], kn[b]], 0).reshape(L + 1, KH, D)
        vv = np.concatenate([v[b, :L], vn[b]], 0).reshape(L + 1, KH, D)
        for h in range(KH):
            s = q[b, h] @ kk[:, h].T / np.sqrt(D)
            p = np.exp(s - s.max(-1, keepdims=True))
            out[b, h] = (p / p.sum(-1, keepdims=True)) @ vv[:, h]
    return out


@pytest.mark.parametrize("S", [512, 96])   # 256-key chunks / one chunk of S
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_fused_decode_plain_matches_pallas(rng, interp, S, kind):
    """Caches bit-exact. Output within 1e-2 of the Pallas kernel (the two
    share every rounding point; exp and summation order differ in the last
    bits, which can move one 7-bit probability code). int8 also within 4e-2
    of dequantized float attention, the reference suite's bar for the int8
    requantization (test_attention.py:87)."""
    B, KH, G, D = 2, 2, 4, 64
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        kn = rng.integers(-127, 128, (B, 1, KH * D)).astype(np.int8)
        vn = rng.integers(-127, 128, (B, 1, KH * D)).astype(np.int8)
        ks, vs = 0.011, 0.017
        jd, td = jnp.int8, torch.int8
    else:
        k, v, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                        for sh in [(B, S, KH * D)] * 2 + [(B, 1, KH * D)] * 2)
        ks = vs = None
        jd, td = jnp.bfloat16, torch.bfloat16
    pos = np.asarray([S // 3, S - 2], np.int32)
    oj, ckj, cvj = ja.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(kn).astype(jd), jnp.asarray(vn).astype(jd),
        jnp.asarray(k).astype(jd), jnp.asarray(v).astype(jd), jnp.asarray(pos),
        k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    ot, ckt, cvt = ta.fused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn).to(td), torch.from_numpy(vn).to(td),
        torch.from_numpy(k).to(td), torch.from_numpy(v).to(td), torch.from_numpy(pos),
        k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    np.testing.assert_array_equal(ckt.float().numpy(), np.asarray(ckj.astype(jnp.float32)))
    np.testing.assert_array_equal(cvt.float().numpy(), np.asarray(cvj.astype(jnp.float32)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-2, atol=1e-2)
    if kind == "int8":
        ref = _dequant_ref(q, k * ks, v * vs, pos, kn * ks, vn * vs)
        np.testing.assert_allclose(ot.numpy(), ref, rtol=4e-2, atol=4e-2)


def test_fused_decode_refuses_sinks_and_softcap():
    q = torch.zeros(1, 1, 1, 8)
    c = torch.zeros(1, 4, 8)
    with pytest.raises(NotImplementedError):
        ta.fused_decode_attention(q, c[:, :1], c[:, :1], c, c.clone(),
                                  torch.zeros(1, dtype=torch.int32), softcap=5.0)
