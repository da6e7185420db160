"""K2 fused_decode_attention split over keys, K15
paged_decode_attention and K17 block_sparse_decode_attention split over
pages (K17's pages: its selected blocks), and K5 / K15 at MLA's geometry
split over pieces of the latent rows, as the CUDA kernels' thread-block
clusters split them: torch models of the kernels' rounds held to the JAX
package's Pallas kernels (interpret mode) and to the port's plain versions.
They pin the claim that splitting a slot's keys over C CTAs changes no int8
probability code: the codes depend only on each chunk's running max, which
the ranks agree on before any code is rounded, and the integer partials sum
exactly in any order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import attention as ja
from modelopt_tpu_torch.kernels import attention as ta

C = 8  # CTAs a cluster


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pieces(L: int, S: int, chunk: int):
    """The kernel's rounds: per round, the keys [lo, hi) of each rank. One
    chunk of S: one round, rank r takes [L r/C, L (r+1)/C). Chunks of
    `chunk`: round k gives rank r chunk kC + r."""
    if chunk >= S:
        return [[(L * r // C, L * (r + 1) // C) for r in range(C)]] if L else []
    n_chunks = -(-L // chunk)
    return [[(min((k * C + r) * chunk, L), min((k * C + r + 1) * chunk, L)) for r in range(C)]
            for k in range(-(-n_chunks // C))]


def cluster_decode(q, k_new, v_new, k_cache, v_cache, pos, k_scale, v_scale,
                   chunk: int = 256):
    """The kernel's steps for every (slot, KV head), round by round: each
    rank's max; the running max at each rank's chunk; each rank's codes
    and integer (int8) or f32 (bf16) partials; the partials of one chunk
    summed over the ranks that hold it and the f32 recurrence over the
    round's chunks in order; then the new token. f32 out; the caches are
    not written."""
    B, S, KHD = k_cache.shape
    KH, G, D = q.shape[1:]
    chunk = ta._decode_chunk(S, chunk)
    int8 = k_cache.dtype == torch.int8
    ks, vs = (ta._scalar(t, "cpu") for t in (k_scale, v_scale))
    inv_sqrt_d = ks / torch.sqrt(torch.tensor(float(D)))
    qf = q.to(torch.bfloat16).float()
    k4, v4 = k_cache.view(B, S, KH, D), v_cache.view(B, S, KH, D)
    if int8:
        qmax = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        q8 = torch.round(qf * (torch.tensor(127.0) / qmax))
        scores = torch.einsum("bhgd,bthd->bhgt", q8, k4.float()) * (qmax * (inv_sqrt_d / 127.0))
    else:
        scores = torch.einsum("bhgd,bthd->bhgt", qf, ta._kv_values(k4)) * inv_sqrt_d
    out = torch.empty(B, KH, G, D)
    for b in range(B):
        L = min(int(pos[b]), S - 1)
        for h in range(KH):
            s, vb = scores[b, h], v4[b, :, h]
            m_prev = torch.full((G,), -1e30)
            m, l, acc = torch.full((G, 1), -1e30), torch.zeros(G, 1), torch.zeros(G, D)
            for rnd in pieces(L, S, chunk):
                mr = []
                for lo, hi in rnd:
                    if hi > lo:
                        m_prev = torch.maximum(m_prev, s[:, lo:hi].amax(-1))
                    mr.append(m_prev)
                if chunk >= S:
                    mr = [m_prev] * C
                held = None
                for r, (lo, hi) in enumerate(rnd):
                    if hi > lo:
                        e = torch.exp(s[:, lo:hi] - mr[r][:, None])
                        if int8:
                            e8 = torch.round(e * 127.0).to(torch.int64)
                            es, y = e8.sum(-1), e8 @ vb[lo:hi].to(torch.int64)
                        else:
                            es = e.sum(-1)
                            y = e.to(torch.bfloat16).float() @ ta._kv_values(vb[lo:hi])
                        held = (es, y) if held is None else (held[0] + es, held[1] + y)
                    if held is not None and (chunk < S or r == C - 1):
                        es, y = held
                        if int8:
                            es, y = es.float() * (1.0 / 127.0), y.float() * (1.0 / 127.0)
                        m_cur = mr[r][:, None]
                        alpha = torch.exp(m - m_cur)
                        l = l * alpha + es[:, None]
                        acc = acc * alpha + y
                        m, held = m_cur, None
            kn = k_new.reshape(B, KH, D)[b, h].float()
            vn = v_new.reshape(B, KH, D)[b, h].float()
            s_n = (qf[b, h] * kn).sum(-1, keepdim=True) * inv_sqrt_d
            m_fin = torch.maximum(m, s_n)
            alpha = torch.exp(m - m_fin)
            e_n = torch.exp(s_n - m_fin)
            l_fin = l * alpha + e_n
            out[b, h] = (acc * alpha + e_n * vn) * (vs / l_fin.clamp_min(1e-30))
    return out


# positions: empty slots (0), one key, fewer keys than ranks, chunk edges
# (255, 256 keys), ragged, and past the cache (clamped to S - 1). 2176: one
# chunk of S, a rank's share up to 272 keys; 2048: eight 256-key chunks, one
# round; 4352: seventeen chunks, three rounds.
POS = {2176: [0, 1, 5, 255, 256, 1100, 2175, 2300],
       2048: [0, 1, 7, 255, 256, 257, 1023, 2047, 3000],
       4352: [0, 9, 256, 2047, 2048, 2049, 4100, 4351]}


@pytest.mark.parametrize("S", [2176, 2048, 4352])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_split_over_keys_matches_reference(rng, kind, G, S):
    """Against the Pallas kernel (interpret mode): within 1e-2, the bar of
    test_torch_attention.py (exp and the summation order differ in the last
    bits there, which can move one 7-bit code). Against the port's plain
    version: int8 bit for bit (the same codes, exact integer partials, the
    same f32 recurrence); bf16 to f32 rounding, 1e-5 of the largest output
    (only the order of the f32 PV and exp sums moves)."""
    KH, D = 2, 128
    pos = np.asarray(POS[S], np.int32)
    B = len(pos)
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8) for _ in range(2))
        kn, vn = (rng.integers(-127, 128, (B, 1, KH * D)).astype(np.int8) for _ in range(2))
        ks, vs = 0.02, 0.03
        jd, td = jnp.int8, torch.int8
    else:
        k, v, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                        for sh in [(B, S, KH * D)] * 2 + [(B, 1, KH * D)] * 2)
        ks = vs = None
        jd, td = jnp.bfloat16, torch.bfloat16
    tq = torch.from_numpy(q)
    tkn, tvn, tk, tv = (torch.from_numpy(a).to(td) for a in (kn, vn, k, v))
    got = cluster_decode(tq, tkn, tvn, tk, tv, pos, ks, vs)
    # the Pallas kernel's writes are bounds-checked in interpret mode: it gets
    # the position the port clamps a past-the-cache one to
    with pltpu.force_tpu_interpret_mode():
        ref, *_ = ja.fused_decode_attention(
            jnp.asarray(q), jnp.asarray(kn).astype(jd), jnp.asarray(vn).astype(jd),
            jnp.asarray(k).astype(jd), jnp.asarray(v).astype(jd),
            jnp.asarray(np.minimum(pos, S - 1)), k_scale=ks, v_scale=vs, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=1e-2)
    want, *_ = ta.fused_decode_attention_plain(tq, tkn, tvn, tk.clone(), tv.clone(),
                                               torch.from_numpy(pos), ks, vs,
                                               out_dtype=torch.float32)
    if kind == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# K15 paged_decode_attention split over pages
# ---------------------------------------------------------------------------
SB, PP = 512, 8  # keys a CTA holds scores of; pages a CTA holds a round


def page_runs(npages: int, P: int):
    """The kernel's rounds of C * P pages: per round, the pages [p0, p1) of
    each rank, the round's pages split in C contiguous runs."""
    rounds = []
    for base in range(0, npages, C * P):
        n = min(C * P, npages - base)
        rounds.append([(base + n * r // C, base + n * (r + 1) // C) for r in range(C)])
    return rounds


def _scores(qf, k4, ks, int8):
    """Every key's score [B, KH, G, T] as the cluster kernels compute it:
    int8, q requantized per row and exact integer dots; bf16, f32 sums."""
    D = qf.shape[-1]
    inv_sqrt_d = ks / torch.sqrt(torch.tensor(float(D)))
    if int8:
        qmax = qf.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        q8 = torch.round(qf * (torch.tensor(127.0) / qmax))
        return torch.einsum("bhgd,bthd->bhgt", q8, k4.float()) * (qmax * (inv_sqrt_d / 127.0))
    return torch.einsum("bhgd,bthd->bhgt", qf, ta._kv_values(k4)) * inv_sqrt_d


def replay_pages(s, vb, spans, P, int8):
    """The cluster kernels' rounds over one (slot, KV head): scores s
    [G, T], values vb [T, D], ``spans`` each page's keys [lo, hi) in page
    order. Per round of C * P pages: each rank's pages scored and their
    maxima taken; the running max at every page of the round from all
    ranks' maxima, in page order; each page's codes against its running
    max and its integer (int8) or f32 (bf16) partials; the f32 recurrence
    over the round's pages in order. Returns (l [G, 1], acc [G, D])."""
    G, D = s.shape[0], vb.shape[-1]
    m_prev = torch.full((G,), -1e30)
    m, l, acc = torch.full((G, 1), -1e30), torch.zeros(G, 1), torch.zeros(G, D)
    for rnd in page_runs(len(spans), P):
        mr = {}
        for p0, p1 in rnd:
            for p in range(p0, p1):
                lo, hi = spans[p]
                m_prev = torch.maximum(m_prev, s[:, lo:hi].amax(-1))
                mr[p] = m_prev
        parts = {}
        for p, mp in mr.items():
            lo, hi = spans[p]
            e = torch.exp(s[:, lo:hi] - mp[:, None])
            if int8:
                e8 = torch.round(e * 127.0).to(torch.int64)
                es, y = e8.sum(-1), e8 @ vb[lo:hi].to(torch.int64)
                es, y = es.float() * (1.0 / 127.0), y.float() * (1.0 / 127.0)
            else:
                es = e.sum(-1)
                y = e.to(torch.bfloat16).float() @ ta._kv_values(vb[lo:hi])
            parts[p] = (es, y)
        for p in sorted(mr):
            es, y = parts[p]
            m_cur = mr[p][:, None]
            alpha = torch.exp(m - m_cur)
            l = l * alpha + es[:, None]
            acc = acc * alpha + y
            m = m_cur
    return l, acc


def cluster_paged_decode(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale):
    """K15's cluster kernel for every (slot, KV head): the slot's pages
    gathered in table order, page p the keys [p ps, min(L, (p + 1) ps)) (the
    last page cut at the length, no key past it visited), replayed as
    ``replay_pages``. f32 out."""
    B, KH, G, D = q.shape
    _, ps, KHD = k_pages.shape
    PMAX = page_table.shape[1]
    P = min(PP, SB // ps)
    int8 = k_pages.dtype == torch.int8
    ks, vs = (ta._scalar(t, "cpu") for t in (k_scale, v_scale))
    idx = page_table.reshape(-1).long()
    k4 = k_pages[idx].reshape(B, PMAX * ps, KH, D)
    v4 = v_pages[idx].reshape(B, PMAX * ps, KH, D)
    scores = _scores(q.to(torch.bfloat16).float(), k4, ks, int8)
    out = torch.empty(B, KH, G, D)
    for b in range(B):
        L = min(int(lengths[b]), PMAX * ps)
        spans = [(p * ps, min(L, (p + 1) * ps)) for p in range(-(-L // ps))]
        for h in range(KH):
            l, acc = replay_pages(scores[b, h], v4[b, :, h], spans, P, int8)
            out[b, h] = acc * (vs / l.clamp_min(1e-30))
    return out


def cluster_sparse_decode(q, k_cache, v_cache, sel, nvalid, lengths, k_scale, v_scale,
                          block_size):
    """K17's cluster kernel (K15's body over the selected blocks) for every
    (slot, KV head): page p the whole block sel[b, p] for p < min(nvalid[b],
    NSEL), in table order, its keys at or past lengths[b] scored -1e30 (a
    block with no live key still rounds its codes: exp(0) while the running
    max is -1e30), replayed as ``replay_pages``. f32 out."""
    B, KH, G, D = q.shape
    S = k_cache.shape[1]
    NSEL, bs = sel.shape[1], block_size
    P = min(PP, SB // bs)
    int8 = k_cache.dtype == torch.int8
    ks, vs = (ta._scalar(t, "cpu") for t in (k_scale, v_scale))
    rows = (sel.long()[..., None] * bs + torch.arange(bs)).reshape(B, NSEL * bs)
    k4 = torch.stack([k_cache[b, rows[b]] for b in range(B)]).view(B, NSEL * bs, KH, D)
    v4 = torch.stack([v_cache[b, rows[b]] for b in range(B)]).view(B, NSEL * bs, KH, D)
    scores = _scores(q.to(torch.bfloat16).float(), k4, ks, int8)
    scores = torch.where(rows[:, None, None, :] < lengths.long()[:, None, None, None], scores,
                         torch.tensor(-1e30))
    out = torch.empty(B, KH, G, D)
    for b in range(B):
        n = max(min(int(nvalid[b]), NSEL), 0)
        spans = [(p * bs, (p + 1) * bs) for p in range(n)]
        for h in range(KH):
            l, acc = replay_pages(scores[b, h], v4[b, :, h], spans, P, int8)
            out[b, h] = acc * (vs / l.clamp_min(1e-30))
    return out


# a shuffled pool of 12 pages of 8 rows, tables of 72 entries drawn from it
# (a page may recur); lengths: an empty slot, one key, a page edge (9),
# 25 pages over 8 ranks, and two rounds (64 pages a round: 513 keys, and
# the whole table, 576)
PAGED_LENGTHS = [0, 1, 9, 200, 513, 576]


@pytest.mark.parametrize("kind,G", [("int8", 1), ("int8", 4), ("int8", 8), ("bf16", 4)])
def test_split_over_pages_matches_reference(rng, kind, G):
    """Against the port's plain version: int8 bit for bit (the same codes,
    exact integer partials, the same f32 recurrence in page order); bf16 to
    f32 rounding, 1e-5 of the largest output. Against the Pallas kernel
    (interpret mode): int8 within 1e-5 of the largest output (the same
    codes; XLA's CPU code rounds the f32 recurrence's products and sums with
    fused multiply-adds, an ulp or two away, so not bit for bit); bf16
    within 1e-2, K15's bar in test_torch_paged_attention.py."""
    from modelopt_tpu.kernels import paged_attention as jpa
    from modelopt_tpu_torch.kernels import paged_attention as tpa

    KH, D, ps, n_pages, pmax = 2, 128, 8, 12, 72
    lengths = np.asarray(PAGED_LENGTHS, np.int32)
    B = len(lengths)
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    pt = rng.integers(0, n_pages, (B, pmax)).astype(np.int32)
    if kind == "int8":
        kp, vp = (rng.integers(-127, 128, (n_pages, ps, KH * D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = 0.02, 0.03
        jd, td = jnp.int8, torch.int8
    else:
        kp, vp = (rng.standard_normal((n_pages, ps, KH * D)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
        jd, td = jnp.bfloat16, torch.bfloat16
    tq, tpt, tl = torch.from_numpy(q), torch.from_numpy(pt), torch.from_numpy(lengths)
    tk, tv = (torch.from_numpy(a).to(td) for a in (kp, vp))
    got = cluster_paged_decode(tq, tk, tv, tpt, tl, ks, vs)
    want = tpa.paged_decode_attention_plain(tq, tk, tv, tpt, tl, ks, vs, out_dtype=torch.float32)
    if kind == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    with pltpu.force_tpu_interpret_mode():
        ref = jpa.paged_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
            jnp.asarray(pt), jnp.asarray(lengths), k_scale=ks, v_scale=vs,
            out_dtype=jnp.float32)
    bar = 1e-5 * float(np.abs(ref).max()) if kind == "int8" else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0 if kind == "int8" else 1e-2,
                               atol=bar)


# ---------------------------------------------------------------------------
# K17 block_sparse_decode_attention on K15's cluster body
# ---------------------------------------------------------------------------
SPARSE_BS, SPARSE_NB = 16, 12
# per slot: (length, selected blocks in table order); S = 192. No live
# entry; one block, cut by the length; a first block wholly past the length
# before live ones; every block past the length (the mean of their V rows);
# twelve blocks, more than the cluster's 8 ranks (the last cut); nine whole
# blocks and an aliased tail
SPARSE_SLOTS = ((150, ()), (56, (3,)), (20, (5, 0, 1)), (5, (3, 7)),
                (170, (11, 0, 5, 1, 10, 2, 9, 3, 8, 4, 7, 6)),
                (192, (0, 2, 4, 6, 8, 10, 1, 3, 5)))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_sparse_split_over_blocks_matches_reference(rng, kind):
    """K17's cluster model (K15's split with a block for a page, whole,
    keys past the length at -1e30) against the port's plain version: int8
    bit for bit (the same codes, exact integer partials, the same f32
    recurrence in block order), bf16 within 1e-5 of the largest output;
    against the Pallas kernel (interpret mode) at
    ``test_block_sparse_plain_matches_pallas``'s bar, 1e-2."""
    from modelopt_tpu.kernels import block_sparse_attention as jbs
    from modelopt_tpu_torch.kernels import block_sparse_attention as tbs

    KH, G, D, bs = 2, 4, 128, SPARSE_BS
    B, S, NSEL = len(SPARSE_SLOTS), SPARSE_NB * bs, SPARSE_NB
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    if kind == "int8":
        kc, vc = (rng.integers(-127, 128, (B, S, KH * D)).astype(np.int8) for _ in range(2))
        ks, vs = 0.011, 0.017
        jd, td = jnp.int8, torch.int8
    else:
        kc, vc = (rng.standard_normal((B, S, KH * D)).astype(np.float32) for _ in range(2))
        ks = vs = None
        jd, td = jnp.bfloat16, torch.bfloat16
    sel = np.zeros((B, NSEL), np.int32)
    for b, (_, blocks) in enumerate(SPARSE_SLOTS):
        sel[b, :len(blocks)] = blocks
    nvalid = np.asarray([len(blocks) for _, blocks in SPARSE_SLOTS], np.int32)
    lengths = np.asarray([n for n, _ in SPARSE_SLOTS], np.int32)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = (torch.from_numpy(a).to(td) for a in (kc, vc))
    tsel, tnv, tl = (torch.from_numpy(a) for a in (sel, nvalid, lengths))
    got = cluster_sparse_decode(tq, tk, tv, tsel, tnv, tl, ks, vs, bs)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # no live entry: l = 0, out 0
    want = tbs.block_sparse_decode_attention_plain(tq, tk, tv, tsel, tnv, tl, ks, vs,
                                                   block_size=bs, out_dtype=torch.float32)
    if kind == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    with pltpu.force_tpu_interpret_mode():
        ref = jbs.block_sparse_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd),
            jnp.asarray(sel), jnp.asarray(nvalid), jnp.asarray(lengths), k_scale=ks, v_scale=vs,
            block_size=bs, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# K5 and K15 at MLA's geometry: the latent cluster kernel
# ---------------------------------------------------------------------------
def latent_cluster_decode(q, cache, lengths, k_scale, v_scale, chunk, page_table=None):
    """The latent cluster kernel (csrc/latent_decode.cuh) for every slot:
    one int8 latent tensor [B, S, D] (or pool [n_pages, chunk, D] with
    ``page_table``) as K and V, one KV head, G <= 16 query rows, split as
    ``latent_plan`` says. Per round: each rank's pieces scored and their
    maxima taken; the running max at each chunk of the round from all
    pieces' maxima, in order; each piece's codes against its chunk's
    running max, summed as s32 per rank over its pieces of one chunk (a
    segment); the owner of each column sums a chunk's segments over the
    ranks, then one f32 update per chunk in order. f32 out."""
    from modelopt_tpu_torch.kernels import paged_attention as tpa

    B, KH, G, D = q.shape
    assert KH == 1 and G <= 16
    if page_table is not None:
        cache = tpa.paged_gather_dense(cache, page_table)
    S = cache.shape[1]
    ks, vs = (ta._scalar(t, "cpu") for t in (k_scale, v_scale))
    scores = _scores(q.to(torch.bfloat16).float(), cache.view(B, S, 1, D), ks, True)[:, 0]
    out = torch.empty(B, 1, G, D)
    for b in range(B):
        L = max(min(int(lengths[b]), S), 0)
        s, vb = scores[b], cache[b].to(torch.int64)
        m_prev = torch.full((G,), -1e30)
        m, l, acc = torch.full((G, 1), -1e30), torch.zeros(G, 1), torch.zeros(G, D)
        for rnd in ta.latent_plan(L, chunk):
            assert len(rnd) <= ta.LATENT_RANKS
            order = [p for held in rnd for p in held]
            cm = {}
            for i, (c, lo, hi) in enumerate(order):
                m_prev = torch.maximum(m_prev, s[:, lo:hi].amax(-1))
                if i == len(order) - 1 or order[i + 1][0] != c:
                    cm[c] = m_prev
            segments = []  # (chunk, sum of codes, s32 partial) of each rank, rank by rank
            for held in rnd:
                assert 1 <= len(held) <= ta.LATENT_SLOTS
                for c, lo, hi in held:
                    assert hi - lo <= ta.LATENT_PIECE and lo // chunk == (hi - 1) // chunk == c
                    e8 = torch.round(torch.exp(s[:, lo:hi] - cm[c][:, None]) * 127.0)
                    e8 = e8.to(torch.int64)
                    es, y = e8.sum(-1), e8 @ vb[lo:hi]
                    if segments and segments[-1][0] == c and held[0] != (c, lo, hi):
                        segments[-1] = (c, segments[-1][1] + es, segments[-1][2] + y)
                    else:
                        segments.append((c, es, y))
            for c in sorted(cm):
                t = sum(y for cc, _, y in segments if cc == c)
                es = sum(e for cc, e, _ in segments if cc == c)
                mc = cm[c][:, None]
                alpha = torch.exp(m - mc)
                l = l * alpha + es.float()[:, None] * (1.0 / 127.0)
                acc = acc * alpha + t.float() * (1.0 / 127.0)
                m = mc
        out[b, 0] = acc * (vs / l.clamp_min(1e-30))
    return out


# empty, one key, a short context (one piece: rank 0 alone), a piece's
# edge (64 / 65 keys: one piece and two), 300 keys over five ranks, the
# whole cache
LATENT_LENGTHS = [0, 1, 33, 64, 65, 300]


@pytest.mark.parametrize("layout", ["one chunk", "256-key chunks", "pages"])
def test_latent_split_matches_reference(rng, layout):
    """MLA's geometry (one KV head, G = 16, D = 640, one int8 latent tensor
    as K and V) split as the latent cluster kernel splits it: bit for bit
    the port's plain version (the same codes, exact integer partials, the
    same f32 recurrence chunk by chunk); against the Pallas kernel
    (interpret mode) within 1e-2, the bar of
    test_torch_decode_attention.py (exp and the summation order differ in
    the last bits there, which can move one 7-bit code)."""
    from modelopt_tpu.kernels import paged_attention as jpa
    from modelopt_tpu_torch.kernels import paged_attention as tpa

    G, D, sc = 16, 640, 0.03
    S = {"one chunk": 520, "256-key chunks": 512, "pages": 576}[layout]
    lengths = np.asarray(LATENT_LENGTHS + [S], np.int32)
    B = len(lengths)
    q = (rng.standard_normal((B, 1, G, D)) * 2).astype(np.float32)
    tq, tl = torch.from_numpy(q).bfloat16(), torch.from_numpy(lengths)
    if layout == "pages":
        ps = 64
        pmax, n_pages = S // ps, 24  # tables drawn from a pool of 24 pages (a page may recur)
        pool = rng.integers(-127, 128, (n_pages, ps, D)).astype(np.int8)
        pt = rng.integers(0, n_pages, (B, pmax)).astype(np.int32)
        tp, tpt = torch.from_numpy(pool), torch.from_numpy(pt)
        got = latent_cluster_decode(tq, tp, tl, sc, sc, ps, tpt)
        want = tpa.paged_decode_attention_plain(tq, tp, tp, tpt, tl, sc, sc,
                                                out_dtype=torch.float32)
        with pltpu.force_tpu_interpret_mode():
            jp = jnp.asarray(pool)
            ref = jpa.paged_decode_attention(jnp.asarray(q, jnp.bfloat16), jp, jp,
                                             jnp.asarray(pt), jnp.asarray(lengths), k_scale=sc,
                                             v_scale=sc, out_dtype=jnp.float32)
    else:
        lat = rng.integers(-127, 128, (B, S, D)).astype(np.int8)
        tc = torch.from_numpy(lat)
        got = latent_cluster_decode(tq, tc, tl, sc, sc, ta._decode_chunk(S, 256))
        want = ta.decode_attention_plain(tq, tc, tc, tl, sc, sc, out_dtype=torch.float32)
        with pltpu.force_tpu_interpret_mode():
            jc = jnp.asarray(lat)
            ref = ja.decode_attention(jnp.asarray(q, jnp.bfloat16), jc, jc, jnp.asarray(lengths),
                                      k_scale=sc, v_scale=sc, out_dtype=jnp.float32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # no key: l = 0, out 0
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("chunk,S", [(2176, 2176), (520, 520), (256, 4096), (64, 2176),
                                     (8, 512), (136, 2176), (2176, 8192)])
def test_latent_plan_covers_every_length(chunk, S):
    """At every length up to S: the pieces cover [0, L) once, in order,
    each at most LATENT_PIECE keys inside one chunk; a round takes whole
    chunks, at most LATENT_RANKS ranks of at most LATENT_SLOTS pieces; one
    piece in all exactly where L <= min(LATENT_PIECE, chunk) (rank 0
    alone). The held rows and partials fit the kernel's shared memory."""
    for L in range(S + 1):
        plan = ta.latent_plan(L, chunk)
        keys, total = 0, 0
        for rnd in plan:
            assert 1 <= len(rnd) <= ta.LATENT_RANKS
            chunks = {c for held in rnd for c, _, _ in held}
            assert chunks == set(range(min(chunks), max(chunks) + 1))
            for held in rnd:
                assert 1 <= len(held) <= ta.LATENT_SLOTS
                for c, lo, hi in held:
                    assert lo == keys and 0 < hi - lo <= ta.LATENT_PIECE
                    assert c * chunk <= lo and hi <= min((c + 1) * chunk, L)
                    keys, total = hi, total + 1
            # a round's chunks are whole: the next round starts a chunk
            assert keys == L or keys % chunk == 0
        assert keys == L
        assert (total <= 1) == (L <= min(ta.LATENT_PIECE, chunk))
    for D in range(128, 641, 128):
        for dtype, static in ta.LATENT_STATIC_SMEM.items():
            assert ta.latent_smem(D, dtype) + static <= ta.LATENT_CTA_SMEM
        assert 4 * 16 * (D + 1) <= ta.LATENT_PIECE * D  # a chunk's partial over its rows
