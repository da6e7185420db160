"""K5 decode_attention: the port's plain twin (what the CUDA kernel is held
to on the card) against the JAX Pallas kernel in interpret mode, int8 and
bf16 caches, one chunk and two; the MLA formulation over a shared latent
cache (K and V one tensor); the wrapper's refusals and dispatch rule."""

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


def _float_attention(q, k, v, lengths):
    """Float attention of q [B, KH, G, D] over keys [0, lengths[b])."""
    B, KH, G, D = q.shape
    out = np.zeros((B, KH, G, D), np.float32)
    for b in range(B):
        L = int(lengths[b])
        kk = k[b, :L].reshape(L, KH, D)
        vv = v[b, :L].reshape(L, KH, D)
        for h in range(KH):
            s = q[b, h] @ kk[:, h].T / np.sqrt(D)
            p = np.exp(s - s.max(-1, keepdims=True))
            out[b, h] = (p / p.sum(-1, keepdims=True)) @ vv[:, h]
    return out


@pytest.mark.parametrize("S", [16, 512])   # one chunk of S / two 256-key chunks
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_attention_plain_matches_pallas(rng, interp, kind, D, S):
    """Output within 1e-2 of the Pallas kernel: the two share every rounding
    point (bf16 q, int8 q codes per row, 7-bit probability codes against
    the running max), and exp and summation order differ in the last bits,
    which can move one probability code. int8 also within 4e-2 of
    dequantized float attention, the reference suite's bar for the int8
    requantization (test_attention.py:87)."""
    B, KH, G = 3, 2, 4
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    lengths = np.asarray([1, S // 3, S], np.int32)
    if kind == "int8":
        k = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8)
        ks, vs = 0.011, 0.017
        jd, td = jnp.int8, torch.int8
    else:
        k, v = (rng.standard_normal((B, S, KH * D)).astype(np.float32) for _ in range(2))
        ks = vs = None
        jd, td = jnp.bfloat16, torch.bfloat16
    oj = ja.decode_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k).astype(jd),
                             jnp.asarray(v).astype(jd), jnp.asarray(lengths),
                             k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    ot = ta.decode_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).to(td),
                             torch.from_numpy(v).to(td), torch.from_numpy(lengths),
                             k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    assert ot.shape == (B, KH, G, D) and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-2, atol=1e-2)
    if kind == "int8":
        qb = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        ref = _float_attention(qb, k * ks, v * vs, lengths)
        np.testing.assert_allclose(ot.numpy(), ref, rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_mla_formulation_matches_einsum(rng, kind):
    """The MLA decode reformulation (the reference's
    tests/unit/models/test_mla.py:174-213) on the port's K5: q_eff =
    [q_lat ; q_pe ; 0-pad] * scale * sqrt(Dc) against padded latent rows,
    the same tensor as K and V, and o_lat the first r lanes of the output,
    equals absorbed attention computed with einsums. The f32 latent is
    the reference test's bar (2e-2; the kernel rounds q to bf16); int8
    codes with a per-tensor scale add the int8 requantization bar (4e-2)."""
    B, S, H, r, dr, Dc = 2, 16, 2, 24, 8, 128
    L = np.asarray([5, 16])
    rows = rng.standard_normal((B, S, r + dr)).astype(np.float32) * 0.3
    q_lat = rng.standard_normal((B, H, r)).astype(np.float32)
    q_pe = rng.standard_normal((B, H, dr)).astype(np.float32)
    scale = 1.0 / np.sqrt(17.0)
    rs = None
    if kind == "int8":
        rs = float(np.abs(rows).max()) / 127
        codes = np.clip(np.round(rows / rs), -127, 127)
        rows = (codes * rs).astype(np.float32)
    s = (np.einsum("bhr,bsr->bhs", q_lat, rows[..., :r])
         + np.einsum("bhd,bsd->bhs", q_pe, rows[..., r:])) * scale
    for b in range(B):
        s[b, :, L[b]:] = -1e30
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o_ref = np.einsum("bhs,bsr->bhr", p, rows[..., :r])

    pad = Dc - (r + dr)
    if kind == "int8":
        ck = torch.from_numpy(np.pad(codes, ((0, 0), (0, 0), (0, pad)))).to(torch.int8)
    else:
        ck = torch.from_numpy(np.pad(rows, ((0, 0), (0, 0), (0, pad)))).bfloat16()
    q_eff = np.pad(np.concatenate([q_lat, q_pe], -1), ((0, 0), (0, 0), (0, pad)))[:, None]
    q_eff = torch.from_numpy(q_eff * (scale * Dc ** 0.5)).float()
    o = ta.decode_attention(q_eff, ck, ck, torch.from_numpy(L.astype(np.int32)),
                            k_scale=rs, v_scale=rs, out_dtype=torch.float32)
    got = o.numpy()[:, 0][..., :r]
    tol = 2e-2 if kind == "f32" else 4e-2
    np.testing.assert_allclose(got, o_ref, rtol=tol, atol=tol)


def test_lengths_past_the_cache_are_clamped(rng):
    """An idle serving slot at the cache end asks for S + 1 keys: the twin
    attends all S, as the reference's mask does."""
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 128)).astype(np.float32)).bfloat16()
    c = torch.from_numpy(rng.integers(-127, 128, (1, 32, 128)).astype(np.int8))
    a = ta.decode_attention(q, c, c, torch.tensor([33], dtype=torch.int32), 0.01, 0.01)
    b = ta.decode_attention(q, c, c, torch.tensor([32], dtype=torch.int32), 0.01, 0.01)
    assert torch.equal(a, b)


def test_decode_attention_refusals():
    """Sinks and softcap are not ported: refused on every device. Off the
    CPU a tensor never reaches the twin: here (no card) the kernel's checks
    refuse a meta tensor, e4m3 caches too (they have a CUDA branch, so they
    are never dequantized for the bf16 one), and shapes the CUDA kernel was
    not written for raise before them."""
    q = torch.zeros(1, 1, 2, 128)
    c = torch.zeros(1, 4, 128, dtype=torch.int8)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sinks"):
        ta.decode_attention(q, c, c, n, softcap=5.0)
    meta = dict(device="meta")
    e4 = torch.zeros(1, 4, 128, dtype=torch.float8_e4m3fn, **meta)
    with pytest.raises(ValueError, match="on the card"):
        ta.decode_attention(torch.zeros(1, 1, 2, 128, **meta), e4, e4,
                            torch.ones(1, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="on the card"):
        ta.decode_attention(torch.zeros(1, 1, 2, 128, **meta),
                            torch.zeros(1, 4, 128, dtype=torch.int8, **meta),
                            torch.zeros(1, 4, 128, dtype=torch.int8, **meta),
                            torch.ones(1, dtype=torch.int32, **meta))
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        ta.decode_attention(torch.zeros(1, 1, 2, 768, **meta),
                            torch.zeros(1, 4, 768, dtype=torch.int8, **meta),
                            torch.zeros(1, 4, 768, dtype=torch.int8, **meta),
                            torch.ones(1, dtype=torch.int32, **meta))


@pytest.mark.parametrize("dtype,S,D,ok", [
    (torch.int8, 2176, 640, True), (torch.float8_e4m3fn, 64, 128, True),
    (torch.bfloat16, 2176, 640, False), (torch.int8, 8193, 640, False),
    (torch.int8, 64, 192, False)])
def test_dispatch_rule_is_the_reference_tpu_rule(dtype, S, D, ok):
    """The reference's TPU rule (``decode_attention_ok``, attention.py:396)
    and nothing else: a quantized cache (int8 or e4m3), S <= 8192, D a
    multiple of 128 (``ok``); K5's e4m3 branch is ported, so an e4m3 step
    the reference sends to its kernel goes to the port's
    (``test_torch_kernel_gates.py``)."""
    assert ta.decode_attention_ok((8, 1, 16, D), S, dtype) is ok
