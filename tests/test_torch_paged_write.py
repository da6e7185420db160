"""A layer's KV write in one call: K16's ``paged_kv_write_rows`` (the page
lookup, MLA's zero pad and every pool) and K3's ``dense_kv_write_pair`` (an
MHA layer's K and V). Their plain versions, which the CUDA kernels are held
to on the card, against the JAX package's composites run on the CPU (its
gather, ``jnp.pad`` and one XLA-scatter ``paged_kv_write`` a pool; two
``dense_kv_write`` calls), compared as bytes; and the models' call sites,
one write call a layer."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from modelopt_tpu.kernels import attention as ja
from modelopt_tpu.kernels import paged_attention as jpa
from modelopt_tpu_torch.kernels import attention as ta
from modelopt_tpu_torch.kernels import paged_attention as tpa
from modelopt_tpu_torch.models import mla as tm
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
from modelopt_tpu_torch.serve.paged_cache import (PagedCacheConfig, make_paged_cache,
                                                  write_page_table)
from modelopt_tpu_torch.sparsity.skip_softmax import SkipSoftmaxConfig

PS, PMAX, P = 8, 4, 16
# pool row -> each kind's value row, in elements (bf16: 128 bytes of 256)
ROW = {"int8": 256, "e4m3": 256, "bf16": 128}
JDT = {"int8": jnp.int8, "e4m3": jnp.float8_e4m3fn, "bf16": jnp.bfloat16}
TDT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: torch's intra-op pool costs more than it saves, and
    the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(rng, kind, shape) -> np.ndarray:
    """Codes of ``kind`` as their bytes' integer view (int8, uint8, uint16):
    e4m3 of N(0, 48^2) values clipped to +-448 (no NaN code), bf16 of
    N(0, 1) values."""
    if kind == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "e4m3":
        return np.clip(x * 48.0, -448, 448).astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    return x.astype(ml_dtypes.bfloat16).view(np.uint16)


def _jax(kind, raw):
    return jax.lax.bitcast_convert_type(jnp.asarray(raw), JDT[kind])


def _torch(kind, raw):
    t = torch.from_numpy(raw.view(np.int16) if kind == "bf16" else raw.copy())
    return t.view(TDT[kind])


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint8)).reshape(*a.shape[:-1], -1)


def _slots(T):
    """A page table [4, PMAX] and positions [4, T]: slot 0 on distinct pages
    from row 3 on (a chunk crosses page edges); slot 1 with one entry past
    the pool (its rows are dropped); slot 2 at and past the table's
    capacity (the gather clamps the column, not the offset); slot 3 idle,
    every entry the null page 0."""
    pt = np.zeros((4, PMAX), np.int32)
    pt[0] = [5, 9, 2, 14]
    pt[1] = [7, P, 11, 3]
    pt[2] = [1, 12, 6, 15]
    starts = [3, PS + 2 if T == 1 else 0, PMAX * PS - 2 if T > 1 else PMAX * PS, 5]
    pos = np.asarray([np.arange(s, s + T) for s in starts], np.int32)
    return pt, pos


def _equal_at_shared_targets(vals, pt, pos):
    """Rows aimed at one target (past the capacity, on the null page) land
    in no set order, in the reference too: give them equal values."""
    pids = pt[np.arange(pt.shape[0])[:, None], np.minimum(pos // PS, PMAX - 1)]
    first = {}
    for b, t in np.ndindex(*pos.shape):
        key = (pids[b, t], pos[b, t] % PS)
        if key in first:
            for v in vals:
                v[b, t] = v[first[key]]
        else:
            first[key] = (b, t)


@pytest.mark.parametrize("T", [1, 20])
@pytest.mark.parametrize("pools", ["one padded", "two"])
@pytest.mark.parametrize("kind", ["int8", "e4m3", "bf16"])
def test_paged_kv_write_rows_matches_reference_composite(rng, kind, pools, T):
    """The plain version (and the wrapper on CPU tensors) against the
    reference's paged write, byte for byte: ``page_table[rows, pos // ps]``,
    ``pos % ps``, ``jnp.pad`` to the pool's row, ``paged_kv_write`` a pool;
    untouched rows kept, the padded tail zero."""
    n, row = (1 if pools == "one padded" else 2), ROW[kind]
    w = row - 64 if n == 1 else row
    pt, pos = _slots(T)
    pool_raw = [_raw(rng, kind, (P, PS, row)) for _ in range(n)]
    vals_raw = [_raw(rng, kind, (4, T, w)) for _ in range(n)]
    _equal_at_shared_targets(vals_raw, pt, pos)

    jpt, jpos = jnp.asarray(pt), jnp.asarray(pos)
    pids = jpt[jnp.arange(4)[:, None], jpos // PS]
    offs = jpos % PS
    want = []
    for p, v in zip(pool_raw, vals_raw):
        jv = jnp.pad(_jax(kind, v), ((0, 0), (0, 0), (0, row - w)))
        want.append(_bytes(jpa.paged_kv_write(_jax(kind, p), jv, pids, offs)))

    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    for fn in (tpa.paged_kv_write_rows_plain, tpa.paged_kv_write_rows):
        got = fn([_torch(kind, p) for p in pool_raw], [_torch(kind, v) for v in vals_raw],
                 tpt, tpos)
        assert len(got) == n
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), wnt)
    assert tpa.paged_kv_write.launches == 0  # CPU: the plain version only


def test_paged_kv_write_rows_refusals():
    """Pools of two shapes, rows wider than the pool's row and a table of
    another batch are refused on every device; off the CPU (here meta
    tensors) the wrapper reaches the card's checks and never the plain
    version."""
    pool = torch.zeros(P, PS, 32, dtype=torch.int8)
    rows = torch.zeros(2, 1, 32, dtype=torch.int8)
    pt, pos = torch.zeros(2, PMAX, dtype=torch.int32), torch.zeros(2, 1, dtype=torch.int32)
    for pools, vals, table in (((pool, torch.zeros(P, PS, 16, dtype=torch.int8)), (rows, rows),
                                pt),
                               ((pool,), (torch.zeros(2, 1, 48, dtype=torch.int8),), pt),
                               ((pool,), (rows,), pt[:1])):
        with pytest.raises(ValueError, match="paged_kv_write_rows"):
            tpa.paged_kv_write_rows(pools, vals, table, pos)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="on the card"):
        tpa.paged_kv_write_rows((pool.to("meta"),), (rows.to("meta"),), pt, pos.to("meta"))
    with pytest.raises(ValueError, match="16-byte"):
        tpa.paged_kv_write_rows((torch.zeros(P, PS, 24, dtype=torch.int8, **meta),),
                                (torch.zeros(2, 1, 24, dtype=torch.int8, **meta),),
                                pt.to("meta"), pos.to("meta"))


@pytest.mark.parametrize("kind,B,T,starts", [("int8", 4, 1, [0, 31, 7, 40]),
                                             ("bf16", 2, 12, [3, 25])])
def test_dense_kv_write_pair_matches_two_reference_writes(rng, kind, B, T, starts):
    """K3's two-cache form (plain and the wrapper on CPU tensors) against
    two calls of the reference's ``dense_kv_write``, byte for byte; starts
    past S - T clamped like its ``dynamic_update_slice``."""
    S, row = 32, 64
    caches = [_raw(rng, kind, (B, S, row)) for _ in range(2)]
    vals = [_raw(rng, kind, (B, T, row)) for _ in range(2)]
    st = np.asarray(starts, np.int32)
    want = [_bytes(ja.dense_kv_write(_jax(kind, c), _jax(kind, v), jnp.asarray(st)))
            for c, v in zip(caches, vals)]
    for fn in (ta.dense_kv_write_pair_plain, ta.dense_kv_write_pair):
        got = fn(*[_torch(kind, c) for c in caches], *[_torch(kind, v) for v in vals],
                 torch.from_numpy(st))
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), wnt)
    with pytest.raises(ValueError, match="dense_kv_write_pair"):
        ta.dense_kv_write_pair(_torch(kind, caches[0]), _torch(kind, caches[1])[:, :16],
                               _torch(kind, vals[0]), _torch(kind, vals[1]),
                               torch.from_numpy(st))


def _spy(monkeypatch, mod, name, seen):
    real = getattr(mod, name)

    def f(*a, **k):
        seen.append((name, a))
        return real(*a, **k)

    monkeypatch.setattr(mod, name, f)


@pytest.mark.parametrize("cache", ["paged", "paged mla", "dense", "skip_softmax"])
def test_one_write_call_a_layer(monkeypatch, cache):
    """Every cached forward, prefill and decode, writes each layer's rows by
    one call: ``paged_kv_write_rows`` with both pools (MHA) or the latent
    pool and its UNPADDED rows (MLA: the kernel pads), from positions and
    the page table as they are; ``dense_kv_write_pair`` with K and V on the
    dense and skip-softmax MHA caches. No other write call is made."""
    B, S = 2, 32
    if cache == "paged mla":
        cfg = tt.tiny_mla_test_config(dtype=torch.bfloat16)
    elif cache == "skip_softmax":
        cfg = tt.tiny_test_config(dtype=torch.bfloat16,
                                  skip_softmax=SkipSoftmaxConfig(block_size=8))
    else:
        cfg = tt.tiny_test_config(dtype=torch.bfloat16)
    bundle = build_compressed_bundle(cfg, {"quant_cfg": {}}, device="cpu")
    if cache.startswith("paged"):
        kv = make_paged_cache(cfg, B, PagedCacheConfig(page_size=PS, n_pages=P,
                                                       max_pages_per_slot=PMAX),
                              device="cpu")
        for slot in range(B):
            write_page_table(kv, slot, [1 + slot * PMAX + i for i in range(PMAX)])
    else:
        kv = tt.make_cache(cfg, B, S, device="cpu")
    seen = []
    for mod in (tt, tm):
        for name in ("paged_kv_write_rows", "dense_kv_write_pair", "dense_kv_write"):
            if hasattr(mod, name):
                _spy(monkeypatch, mod, name, seen)
    ids = torch.ones(B, 5, dtype=torch.int32)
    for T in (4, 1):
        seen.clear()
        _, kv = bundle.apply(ids[:, :T], kv)
        L = cfg.num_layers
        if cache.startswith("paged"):
            assert [s[0] for s in seen] == ["paged_kv_write_rows"] * L
            for _, (pools, rows, table, positions) in seen:
                assert table is kv["page_table"] and positions.shape == (B, T)
                if cache == "paged mla":
                    r = cfg.kv_lora_rank + cfg.qk_rope_head_dim
                    assert len(pools) == 1 and rows[0].shape == (B, T, r)
                    assert r < pools[0].shape[-1]
                else:
                    assert len(pools) == 2 and rows[0].shape == rows[1].shape
        else:
            assert [s[0] for s in seen] == ["dense_kv_write_pair"] * L
            for _, (ck, cv, k_rows, v_rows, start) in seen:
                assert ck.shape == cv.shape and k_rows.shape[1] == T == v_rows.shape[1]
