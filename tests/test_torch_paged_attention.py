"""K15 paged_decode_attention and K16 paged_kv_write: the port's plain twins
(what the CUDA kernels are held to on the card) against the JAX package's
Pallas kernel in interpret mode and its CPU scatter, int8 and bf16 pools,
ragged lengths, unused table entries aliasing page 0, the MLA form (one
latent pool as K and V); the page-table bookkeeping of
``serve/paged_cache.py`` against the reference's; the wrappers' refusals
and dispatch rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import paged_attention as jpa
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.serve import paged_cache as jpc
from modelopt_tpu_torch.kernels import paged_attention as tpa
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.serve import paged_cache as tpc


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


PS, PMAX, N_PAGES = 16, 4, 16
# slot lengths: one key, a ragged middle, the whole table (every entry used)
LENGTHS = (1, 23, PMAX * PS)


def _page_table(rng, lengths):
    """Distinct pool pages per slot in a shuffled order; entries past a
    slot's length point at the null page 0 (whose rows hold data too, so a
    read of it would show)."""
    pt = np.zeros((len(lengths), PMAX), np.int32)
    ids = rng.permutation(np.arange(1, N_PAGES))
    for b, L in enumerate(lengths):
        used = -(-int(L) // PS)
        pt[b, :used] = ids[b * PMAX:b * PMAX + used]
    return pt


def _pools(rng, kind, KHD, n=2):
    if kind == "int8":
        return [rng.integers(-127, 128, (N_PAGES, PS, KHD)).astype(np.int8) for _ in range(n)]
    return [rng.standard_normal((N_PAGES, PS, KHD)).astype(np.float32) for _ in range(n)]


def _both(kind, arr):
    """(JAX array, torch tensor) of a pool in the kind's storage dtype."""
    if kind == "int8":
        return jnp.asarray(arr), torch.from_numpy(arr)
    return jnp.asarray(arr, jnp.bfloat16), torch.from_numpy(arr).bfloat16()


def _run_both(q, kp, vp, pt, lengths, kind, scales, same=False):
    ks, vs = scales
    jk, tk = _both(kind, kp)
    jv, tv = (jk, tk) if same else _both(kind, vp)
    oj = jpa.paged_decode_attention(jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(pt),
                                    jnp.asarray(lengths), k_scale=ks, v_scale=vs,
                                    out_dtype=jnp.float32)
    ot = tpa.paged_decode_attention(torch.from_numpy(q).bfloat16(), tk, tv,
                                    torch.from_numpy(pt), torch.from_numpy(lengths),
                                    k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    return np.asarray(oj), ot


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_paged_decode_attention_plain_matches_pallas(rng, interp, kind, D):
    """Output within 1e-2 of the Pallas kernel (K5's bar): the twin walks
    the same pages with the same rounding points (bf16 q, int8 q codes per
    row, 7-bit probability codes against each page's running max); exp and
    summation order differ in the last bits. int8 also within 4e-2 of the
    reference's gather-and-softmax fallback (``paged_decode_attention_xla``,
    the bar of the int8 requantization)."""
    B, KH, G = 3, 2, 4
    lengths = np.asarray(LENGTHS, np.int32)
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    kp, vp = _pools(rng, kind, KH * D)
    pt = _page_table(rng, lengths)
    scales = (0.011, 0.017) if kind == "int8" else (None, None)
    oj, ot = _run_both(q, kp, vp, pt, lengths, kind, scales)
    assert ot.shape == (B, KH, G, D) and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), oj, rtol=1e-2, atol=1e-2)
    if kind == "int8":
        ox = jpa.paged_decode_attention_xla(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
            jnp.asarray(lengths), k_scale=scales[0], v_scale=scales[1],
            out_dtype=jnp.float32)
        np.testing.assert_allclose(ot.numpy(), np.asarray(ox), rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_mla_form_one_pool_as_k_and_v(rng, interp, kind):
    """MLA's decode: one shared KV head (KH=1), the query heads as G, padded
    latent rows of D=256, the same pool passed as K and V."""
    B, G, D = 3, 4, 256
    lengths = np.asarray(LENGTHS, np.int32)
    q = (rng.standard_normal((B, 1, G, D)) * 2).astype(np.float32)
    (lat,) = _pools(rng, kind, D, n=1)
    pt = _page_table(rng, lengths)
    scales = (0.02, 0.02) if kind == "int8" else (None, None)
    oj, ot = _run_both(q, lat, lat, pt, lengths, kind, scales, same=True)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=1e-2, atol=1e-2)


def test_page_walk_is_one_page_per_chunk(rng):
    """The twin is K5's twin over the gathered pages with one page per
    chunk: equal bit for bit, so the page walk, not the pool layout, is
    what sets the 7-bit codes."""
    from modelopt_tpu_torch.kernels import attention as ta

    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, 128)).astype(np.float32)).bfloat16()
    kp, vp = (torch.from_numpy(a) for a in _pools(rng, "int8", 256))
    pt = torch.from_numpy(_page_table(rng, LENGTHS))
    got = tpa.paged_decode_attention(q, kp, vp, pt, lengths, 0.01, 0.02)
    want = ta.decode_attention(q, tpa.paged_gather_dense(kp, pt),
                               tpa.paged_gather_dense(vp, pt), lengths, 0.01, 0.02,
                               chunk=PS)
    assert torch.equal(got, want)


def test_lengths_past_the_table_are_clamped(rng):
    """An idle serving slot at the cache cap asks for PMAX * page_size + 1
    keys: the twin attends the table's capacity, as the reference's page
    grid does."""
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 128)).astype(np.float32)).bfloat16()
    kp, vp = (torch.from_numpy(a) for a in _pools(rng, "int8", 128))
    pt = torch.arange(1, PMAX + 1, dtype=torch.int32)[None]
    cap = PMAX * PS
    a = tpa.paged_decode_attention(q, kp, vp, pt, torch.tensor([cap + 1], dtype=torch.int32))
    b = tpa.paged_decode_attention(q, kp, vp, pt, torch.tensor([cap], dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_paged_kv_write_plain_matches_reference(rng, kind):
    """K16's twin against the reference's CPU path (``.at[pids, offs].set``):
    bit-exact, the untouched rows kept, a target past the pool dropped."""
    B, T, KHD = 2, 5, 256
    (pool,) = _pools(rng, kind, KHD, n=1)
    vals = (rng.integers(-127, 128, (B, T, KHD)).astype(np.float32) if kind == "int8"
            else rng.standard_normal((B, T, KHD)).astype(np.float32))
    flat = rng.permutation(N_PAGES * PS)[:B * T]
    pids = (flat // PS).reshape(B, T).astype(np.int32)
    offs = (flat % PS).reshape(B, T).astype(np.int32)
    pids[1, 4] = N_PAGES  # out of the pool: dropped by both
    jp, tp = _both(kind, pool)
    jv = jnp.asarray(vals)
    want = np.asarray(jpa.paged_kv_write(jp, jv, jnp.asarray(pids), jnp.asarray(offs))
                      .astype(jnp.float32))
    got = tpa.paged_kv_write(tp, torch.from_numpy(vals), torch.from_numpy(pids),
                             torch.from_numpy(offs))
    assert got is tp and got.dtype == tp.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_paged_gather_dense_matches_reference(rng):
    (pool,) = _pools(rng, "int8", 128, n=1)
    pt = _page_table(rng, LENGTHS)
    want = np.asarray(jpa.paged_gather_dense(jnp.asarray(pool), jnp.asarray(pt)))
    got = tpa.paged_gather_dense(torch.from_numpy(pool), torch.from_numpy(pt))
    assert got.shape == (3, PMAX * PS, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_page_slots_clamp_the_column_like_the_reference_gather():
    """A write at position PMAX * page_size (a slot at the cache cap on an
    idle tick) takes the table's last column, offset 0: the reference's
    ``page_table[rows, pos // ps]`` clamps the column index."""
    pt = torch.tensor([[3, 7, 9], [4, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([[0, 9], [24, 5]], dtype=torch.int32)
    pids, offs = tpa.page_slots(pt, pos, 8)
    rows = jnp.arange(2)[:, None]
    jpos = jnp.asarray(pos.numpy())
    assert pids.tolist() == np.asarray(jnp.asarray(pt.numpy())[rows, jpos // 8]).tolist()
    assert pids.tolist() == [[3, 7], [0, 4]] and offs.tolist() == [[0, 1], [0, 5]]
    assert pids.dtype == offs.dtype == torch.int32


@pytest.mark.parametrize("B,KH,G,D,ps,ok", [
    (8, 8, 4, 128, 64, True), (8, 1, 16, 640, 64, True), (8, 1, 16, 256, 12, False),
    (8, 2, 4, 64, 64, False), (8, 1, 16, 768, 64, False), (8, 1, 32, 128, 64, False)])
def test_dispatch_rule(B, KH, G, D, ps, ok):
    """The reference's rule (``paged_attention_ok``: D % 128 == 0 and
    page_size % 8 == 0) and the CUDA kernel's limits (D <= 640, G <= 16)."""
    assert tpa.paged_attention_ok(B, KH, G, D, ps) is ok


def test_paged_wrapper_refusals():
    """Sinks and softcap are not ported: refused on every device. Off the
    CPU a tensor never reaches a twin: here (no card) the kernels' checks
    refuse meta tensors, e4m3 pools too (they have a CUDA branch, so they
    are never dequantized for the bf16 one), and shapes the CUDA kernels
    were not written for raise before them."""
    q = torch.zeros(1, 1, 2, 128)
    p = torch.zeros(4, 8, 128, dtype=torch.int8)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sinks"):
        tpa.paged_decode_attention(q, p, p, pt, n, softcap=5.0)
    meta = dict(device="meta")
    e4 = torch.zeros(4, 8, 128, dtype=torch.float8_e4m3fn, **meta)
    with pytest.raises(ValueError, match="on the card"):
        tpa.paged_decode_attention(torch.zeros(1, 1, 2, 128, **meta), e4, e4,
                                   pt.to("meta"), n.to("meta"))
    mp = torch.zeros(4, 8, 128, dtype=torch.int8, **meta)
    mpt = torch.zeros(1, 2, dtype=torch.int32, **meta)
    mn = torch.ones(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="on the card"):
        tpa.paged_decode_attention(torch.zeros(1, 1, 2, 128, **meta), mp, mp, mpt, mn)
    with pytest.raises(NotImplementedError, match="page_size=12"):
        mp12 = torch.zeros(4, 12, 128, dtype=torch.int8, **meta)
        tpa.paged_decode_attention(torch.zeros(1, 1, 2, 128, **meta), mp12, mp12, mpt, mn)
    with pytest.raises(ValueError, match="on the card"):
        tpa.paged_kv_write(mp, torch.zeros(1, 2, 128, dtype=torch.int8, **meta),
                           torch.zeros(1, 2, dtype=torch.int32, **meta),
                           torch.zeros(1, 2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="16-byte"):
        tpa.paged_kv_write(torch.zeros(4, 8, 24, dtype=torch.int8, **meta),
                           torch.zeros(1, 2, 24, dtype=torch.int8, **meta),
                           torch.zeros(1, 2, dtype=torch.int32, **meta),
                           torch.zeros(1, 2, dtype=torch.int32, **meta))


# --------------------------------------------------------------------------
# serve/paged_cache.py
# --------------------------------------------------------------------------
def test_allocator_hands_out_the_reference_page_ids():
    """The same alloc / free sequence gives the same page ids, refusals and
    free counts in both allocators."""
    ops = [("a", 0, 3), ("a", 1, 2), ("a", 0, 1), ("f", 1), ("a", 2, 4), ("a", 1, 9),
           ("f", 0), ("a", 1, 5), ("a", 3, 1), ("f", 2), ("f", 7), ("a", 0, 6)]
    ja, ta = jpc.PagedAllocator(13), tpc.PagedAllocator(13)
    for op in ops:
        if op[0] == "a":
            assert ta.alloc(op[1], op[2]) == ja.alloc(op[1], op[2]), op
        else:
            ja.free_slot(op[1])
            ta.free_slot(op[1])
        assert ta.free_pages == ja.free_pages and ta.owned == ja.owned, op


@pytest.mark.parametrize("model", ["mha", "mla"])
def test_make_paged_cache_and_page_table_rows(model):
    """Pools, placeholder, page table and lengths shaped and typed as the
    reference's; a table row replaced with its unused tail sent to page 0,
    in place."""
    if model == "mha":
        tcfg = tt.tiny_test_config()
        jcfg = jt.tiny_test_config()
    else:
        tcfg = tt.small_mla_compressed_config()
        jcfg = jt.DecoderConfig(**{k: getattr(tcfg, k) for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads", "attention_type",
            "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")})
    pcfg = tpc.PagedCacheConfig(page_size=8, n_pages=11, max_pages_per_slot=5)
    jc = jpc.make_paged_cache(jcfg, 3, jpc.PagedCacheConfig(8, 11, 5), dtype=jnp.int8)
    tc = tpc.make_paged_cache(tcfg, 3, pcfg, dtype=torch.int8, device="cpu")
    for key in ("k", "v"):
        assert [tuple(a.shape) for a in tc[key]] == [a.shape for a in jc[key]]
        assert all(a.dtype == torch.int8 for a in tc[key])
    assert tc["page_table"].dtype == tc["lengths"].dtype == torch.int32
    assert tuple(tc["page_table"].shape) == jc["page_table"].shape
    pt = tc["page_table"]
    jc = jpc.write_page_table(jc, 1, [4, 2, 9])
    assert tpc.write_page_table(tc, 1, [4, 2, 9])["page_table"] is pt
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jc["page_table"]))
    jc = jpc.write_page_table(jc, 1, [])
    tpc.write_page_table(tc, 1, [])
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jc["page_table"]))
    assert tpc.pages_needed(65, 64) == jpc.pages_needed(65, 64) == 2
