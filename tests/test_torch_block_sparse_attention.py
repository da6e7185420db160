"""K17 block_sparse_decode_attention: the port's plain twin (what the CUDA
kernel is held to on the card) against the JAX package's Pallas kernel in
interpret mode, int8 caches with scales and bf16 caches, fewer live
entries than the table holds, lengths in the middle of a block, a live
block past the length; the reference's gather-and-softmax form against the
port's; the wrapper's refusals and dispatch rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import block_sparse_attention as jbs
from modelopt_tpu_torch.kernels import attention as ta
from modelopt_tpu_torch.kernels import block_sparse_attention as tbs


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


BS, NB = 16, 6
# per slot: (length, selected blocks in selection order, live entries); slot
# 0 keeps every in-range block, slot 1 ends mid-block and leaves its tail
# aliasing block 0, slot 2 has one live entry, slot 3 a live block past its
# length (every key there masked)
SLOTS = ((96, (0, 5, 4, 1, 2, 3), 6),
         (71, (0, 4, 3, 2, 0, 0), 4),
         (9, (0, 0, 0, 0, 0, 0), 1),
         (40, (0, 2, 5, 1, 0, 0), 4))


def _case(rng, kind, D, KH=2, G=4):
    B = len(SLOTS)
    S = NB * BS
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    if kind == "int8":
        kc, vc = (rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8) for _ in range(2))
        scales = (0.011, 0.017)
    else:
        kc, vc = (rng.standard_normal((B, S, KH * D)).astype(np.float32) for _ in range(2))
        scales = (None, None)
    sel = np.asarray([s[1] for s in SLOTS], np.int32)
    nvalid = np.asarray([s[2] for s in SLOTS], np.int32)
    lengths = np.asarray([s[0] for s in SLOTS], np.int32)
    return q, kc, vc, sel, nvalid, lengths, scales


def _both(kind, arr):
    if kind == "int8":
        return jnp.asarray(arr), torch.from_numpy(arr)
    return jnp.asarray(arr, jnp.bfloat16), torch.from_numpy(arr).bfloat16()


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_block_sparse_plain_matches_pallas(rng, interp, kind, D):
    """Within 1e-2 of the Pallas kernel (K5's and K15's bar): the twin walks
    the selected blocks in ``sel`` order with the same rounding points (bf16
    q, int8 q codes per row, 7-bit probability codes against each block's
    running max); exp and summation order differ in the last bits."""
    q, kc, vc, sel, nvalid, lengths, (ks, vs) = _case(rng, kind, D)
    jk, tk = _both(kind, kc)
    jv, tv = _both(kind, vc)
    want = jbs.block_sparse_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(sel), jnp.asarray(nvalid),
        jnp.asarray(lengths), k_scale=ks, v_scale=vs, block_size=BS, out_dtype=jnp.float32)
    got = tbs.block_sparse_decode_attention(
        torch.from_numpy(q).bfloat16(), tk, tv, torch.from_numpy(sel),
        torch.from_numpy(nvalid), torch.from_numpy(lengths), k_scale=ks, v_scale=vs,
        block_size=BS, out_dtype=torch.float32)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_xla_form_matches_reference(rng, kind):
    """The gather-and-softmax form (the decoder's path outside
    ``block_sparse_ok``) against the reference's at 1e-4, on f32 q."""
    q, kc, vc, sel, nvalid, lengths, (ks, vs) = _case(rng, kind, 128)
    jk, tk = _both(kind, kc)
    jv, tv = _both(kind, vc)
    want = jbs.block_sparse_decode_attention_xla(
        jnp.asarray(q), jk, jv, jnp.asarray(sel), jnp.asarray(nvalid), jnp.asarray(lengths),
        k_scale=ks, v_scale=vs, block_size=BS, out_dtype=jnp.float32)
    got = tbs.block_sparse_decode_attention_xla(
        torch.from_numpy(q), tk, tv, torch.from_numpy(sel), torch.from_numpy(nvalid),
        torch.from_numpy(lengths), k_scale=ks, v_scale=vs, block_size=BS,
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_every_block_in_order_is_dense_decode(rng):
    """Every in-range block selected in index order, none past the length:
    the twin is K5's twin with one block per chunk, bit for bit."""
    B, KH, G, D, S = 2, 2, 4, 128, 96
    q = torch.from_numpy(rng.standard_normal((B, KH, G, D)).astype(np.float32)).bfloat16()
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8))
              for _ in range(2))
    lengths = torch.tensor([96, 90], dtype=torch.int32)
    sel = torch.arange(NB, dtype=torch.int32).expand(B, NB).contiguous()
    nvalid = torch.full((B,), NB, dtype=torch.int32)
    got = tbs.block_sparse_decode_attention(q, kc, vc, sel, nvalid, lengths, 0.02, 0.03,
                                            block_size=BS, out_dtype=torch.float32)
    want = ta.decode_attention_plain(q, kc, vc, lengths, 0.02, 0.03,
                                     out_dtype=torch.float32, chunk=BS)
    assert torch.equal(got, want)


def test_selection_order_changes_the_codes(rng):
    """The 7-bit codes round against the running max block by block, so
    the same live set in another order is another output (the reason
    ``select_blocks`` must order as the reference does)."""
    q, kc, vc, sel, nvalid, lengths, (ks, vs) = _case(rng, "int8", 128)
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    t = torch.from_numpy
    a = tbs.block_sparse_decode_attention(*args, t(sel), t(nvalid), t(lengths), ks, vs,
                                          block_size=BS, out_dtype=torch.float32)
    flipped = sel.copy()
    flipped[0, :6] = flipped[0, :6][::-1]
    b = tbs.block_sparse_decode_attention(*args, t(flipped), t(nvalid), t(lengths), ks, vs,
                                          block_size=BS, out_dtype=torch.float32)
    assert torch.equal(a[1:], b[1:])
    assert not torch.equal(a[0], b[0])
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=5e-2)


def test_dispatch_rule_and_refusals():
    """``block_sparse_ok`` is the reference's shape rule plus the CUDA
    kernel's limits; bad shapes raise; off the CPU an e4m3 cache reaches
    the kernel's own checks (here, with no card, they refuse meta
    tensors): it has a CUDA branch, so it is never dequantized first."""
    assert tbs.block_sparse_ok(8, 8, 4, 128, 128)
    assert not tbs.block_sparse_ok(8, 8, 4, 64, 128)     # D % 128
    assert not tbs.block_sparse_ok(8, 1, 4, 128, 64)     # block * KH < 128
    assert not tbs.block_sparse_ok(8, 8, 4, 128, 12)     # block % 8
    assert not tbs.block_sparse_ok(8, 1, 32, 128, 128)   # G above the kernel's 16
    q = torch.zeros(1, 1, 1, 128)
    one = torch.zeros(1, dtype=torch.int32)
    meta = dict(device="meta")
    c8 = torch.zeros(1, 256, 128, dtype=torch.float8_e4m3fn, **meta)
    with pytest.raises(ValueError, match="on the card"):
        tbs.block_sparse_decode_attention(torch.zeros(1, 1, 1, 128, **meta), c8, c8,
                                          torch.zeros(1, 2, dtype=torch.int32, **meta),
                                          one.to("meta"), one.to("meta"), block_size=128)
    c = torch.zeros(1, 60, 128, dtype=torch.int8)
    with pytest.raises(ValueError):
        tbs.block_sparse_decode_attention(q, c, c, torch.zeros(1, 2, dtype=torch.int32),
                                          one, one, block_size=32)
