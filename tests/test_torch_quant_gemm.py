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
    tolerance. int8 weights with int8 activations above 256 rows take the
    reference's route, ``int8_dynamic_gemm``, on every device."""
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
    x300 = torch.from_numpy(rng.standard_normal((300, K)).astype(np.float32)).bfloat16()
    assert torch.equal(tb.qgemm(x300, pt, spec, (K, N), act_int8=True),
                       tb.int8_dynamic_gemm(x300, pt["data"], pt["scale"], torch.bfloat16))


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


# ---------------------------------------------------------------------------
# K1's decode tile: the A-fragment gather, the cluster's rank split, R
# ---------------------------------------------------------------------------
def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the 8 bytes y:x (x the low four)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4(w):
    """csrc/w4a8_gemm.cu dec::transpose4: words of k-rows k .. k + 3 (byte i
    column c + i) -> words of columns c .. c + 3 (byte j k-row k + j)."""
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[2], w[3], 0x5140)
    t2, t3 = _byte_perm(w[0], w[1], 0x7362), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _s8(word, j):
    return ((word >> (8 * j)) & 0xFF) - 256 * (((word >> (8 * j)) & 0xFF) >= 128)


def test_w4a8_decode_fragments_model(rng):
    """A numpy model of the decode tile's operand gather for one warp and one
    32-row step: each lane (g, t) loads the 32-bit words of columns
    4 g .. 4 g + 3 of the raw packed tile [32 k, 32 n] at k-rows 4 t + j and
    16 + 4 t + j, transposes them in registers (``__byte_perm``) and takes
    16 q_lo, 16 q_hi by its two logic ops; A tile i's registers are then
    those of mma.m16n8k32's A fragment (PTX: register 0 row g, k 4 t ..;
    1 row g + 8; 2 and 3 the same at k 16 + 4 t ..) with fragment rows g and
    g + 8 the columns 4 g + 2 i and 4 g + 2 i + 1. Checked against the packed
    layout's definition (quant/qtensor.py::pack_int4: low nibble q_lo + 8,
    high nibble q_hi in two's complement), and the product of the gathered
    fragments with x's B fragments (token g, k 4 t .. and 16 + 4 t ..) read
    back through the C fragment (row g / g + 8, token 2 t + e % 2) against
    16 x @ q per column and token."""
    q = rng.integers(-8, 8, (64, 32))                    # K = 64: K2 = 32 packed rows
    packed = tq.pack_int4(torch.from_numpy(q).to(torch.int32)).numpy().astype(np.int64)
    tile = packed                                        # [32 k, 32 n]
    x = rng.integers(-127, 128, (8, 64))                 # 8 tokens, both halves
    A = np.zeros((2, 2, 16, 32), np.int64)               # [tile][half][row][k]
    col_of = np.zeros((2, 16), np.int64)
    D = np.zeros((2, 2, 32, 4), np.int64)                # [tile][half][lane][c]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c0 = 4 * g
        word = lambda r: int(sum(int(tile[r, c0 + i]) << (8 * i) for i in range(4)))
        col = [_transpose4([word(4 * t + j) for j in range(4)]),
               _transpose4([word(16 + 4 * t + j) for j in range(4)])]
        for i in range(2):
            col_of[i, g], col_of[i, g + 8] = c0 + 2 * i, c0 + 2 * i + 1
            for h, op in enumerate((lambda w: (((w << 4) & 0xF0F0F0F0) ^ 0x80808080),
                                    lambda w: w & 0xF0F0F0F0)):
                regs = [op(col[0][2 * i]), op(col[0][2 * i + 1]),
                        op(col[1][2 * i]), op(col[1][2 * i + 1])]
                for r, (row, k0) in enumerate(((g, 4 * t), (g + 8, 4 * t),
                                               (g, 16 + 4 * t), (g + 8, 16 + 4 * t))):
                    A[i, h, row, k0:k0 + 4] = [_s8(regs[r], j) for j in range(4)]
    qlo, qhi = q[:32], q[32:]
    for i in range(2):
        np.testing.assert_array_equal(A[i, 0], 16 * qlo[:, col_of[i]].T)
        np.testing.assert_array_equal(A[i, 1], 16 * qhi[:, col_of[i]].T)
        for h in range(2):
            Dm = A[i, h] @ x[:, 32 * h:32 * h + 32].T    # [16 rows, 8 tokens]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    D[i, h, lane, e] = Dm[g + 8 * (e >> 1), 2 * t + (e & 1)]
    want = [x[:, :32] @ qlo, x[:, 32:] @ qhi]            # [8 tokens, 32 columns] per half
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(2):
            for e in range(4):
                c, m = 4 * g + 2 * i + (e >> 1), 2 * t + (e & 1)
                for h in range(2):
                    assert D[i, h, lane, e] == 16 * want[h][m, c]


def _w4a8_rank_split(xq, packed, scale, R):
    """K1's decode tile on a cluster of R CTAs, on the CPU: rank r takes the
    exact integer dots of its contiguous run of the 128-row blocks
    [r nblk / R, (r + 1) nblk / R), both halves, with the 16 q operands the
    kernel takes from each byte (int8 ((b << 4) & 0xF0) ^ 0x80 and b & 0xF0),
    and holds their products c (s / 16), each rounded alone in f32; then
    the recurrence's sums acc = (acc + p_lo) + p_hi replay over every block
    in block order, each block's products from the rank that holds it."""
    b = packed.to(torch.int64)
    lo16 = (((b << 4) & 0xF0) ^ 0x80).to(torch.uint8).view(torch.int8).to(torch.int64)
    hi16 = (b & 0xF0).to(torch.uint8).view(torch.int8).to(torch.int64)
    K2 = packed.shape[0]
    nblk = K2 // 128
    x = xq.to(torch.int64)
    held = {}
    for r in range(R):
        for blk in range(r * nblk // R, (r + 1) * nblk // R):
            rows = slice(128 * blk, 128 * blk + 128)
            clo = x[:, rows] @ lo16[rows]
            chi = x[:, K2 + 128 * blk:K2 + 128 * blk + 128] @ hi16[rows]
            assert clo.abs().max() < 2**24 and chi.abs().max() < 2**24  # exact in f32
            held[blk] = (r, clo.float() * (scale[blk] * 0.0625),
                         chi.float() * (scale[nblk + blk] * 0.0625))
    acc = torch.zeros(xq.shape[0], packed.shape[1])
    for blk in range(nblk):
        _, plo, phi = held[blk]
        acc = (acc + plo) + phi
    return acc


@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("M", [1, 8])
def test_w4a8_rank_split_matches_twin_and_pallas(rng, interp, M, R):
    """The decode tile's cluster split (exact integer dots and their rounded
    products per rank, the f32 block recurrence's sums replayed in block
    order, never an f32 sum across ranks) is the plain version bit for bit, and within
    ``test_w4a8_plain_matches_pallas``'s tolerance of the Pallas kernel in
    interpret mode."""
    K, N = 2048, 128                                     # 8 blocks: every R has one
    w = rng.standard_normal((K, N)).astype(np.float32)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    p = jq.quantize_int4(jnp.asarray(w), block=128)
    data, scale = (torch.from_numpy(np.array(p[k])) for k in ("data", "scale"))
    got = _w4a8_rank_split(torch.from_numpy(xq), data, scale, R)
    assert torch.equal(got, tk.w4a8_gemm_plain(torch.from_numpy(xq), data, scale))
    yj = np.asarray(jk.w4a8_gemm(jnp.asarray(xq), p["data"], p["scale"], block=128))
    np.testing.assert_allclose(got.numpy(), yj, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("M,N,K,want", [
    (8, 6144, 4096, 4),      # path A, Llama-3-8B fused qkv: 48 tiles of 128 columns
    (8, 4096, 4096, 8),      # o: 32 tiles
    (8, 28672, 4096, 1),     # fused gate_up: 224 tiles
    (8, 4096, 14336, 8),     # down: 56 blocks; R = 2 or 4 would hold 28 / 14 of them
    (8, 4096, 2048, 8),      # path B, Qwen3-30B-A3B q_proj: 8 blocks, one a rank
    (8, 512, 2048, 8),       # k_proj / v_proj: 4 tiles
    (8, 98304, 2048, 1),     # the folded experts' gate / up: 768 tiles
    (8, 2048, 4096, 8),      # o_proj: 16 tiles
    (8, 3072, 2048, 8),      # path D, DeepSeek-V2-Lite q_proj: 24 tiles
    (8, 576, 2048, 8),       # kv_a_proj: 4.5 tiles, the last of 64 columns
    (8, 2048, 2048, 8),      # o_proj
    (1, 4096, 4096, 8),      # any M up to 8 alike
    (9, 4096, 4096, 1),      # the wgmma tile takes no R
    (8, 64, 256, 1),         # one block: never more ranks than blocks
])
def test_w4a8_decode_cluster_ranks(M, N, K, want):
    """K1's decode-tile cluster size at paths A's, B's and D's decode
    shapes: the largest R in 1, 2, 4, 8 with at most BYTE_TARGET_CTAS CTAs
    (two an SM: the tile only draws weight bytes), a block for every rank,
    and a rank's held blocks (8 KB each: their f32 products; the last four
    wait in local memory, then in the ring) plus the 40 KB ring and the
    replay's table within the 227 KB of a CTA. At K = 14336, R = 2 would keep 24 of its 28 blocks in
    shared memory, 232 KB: past the limit, so never chosen."""
    R = tk._w4a8_ranks(M, N, K // 2)
    assert R == want
    blocks = K // 256
    assert R in (1, 2, 4, 8) and R <= max(blocks, 1)
    assert tk._w4a8_smem(blocks, R) <= tk.SMEM_LIMIT
    assert -(-N // 128) * R <= tk.BYTE_TARGET_CTAS or R == 1
    if K == 14336:  # 100 tiles: R = 2 keeps 200 CTAs, but not 24 held blocks and the ring
        assert tk._w4a8_smem(blocks, 2) == 40 * 1024 + 24 * 8192 + 4 * 56 > tk.SMEM_LIMIT
        assert tk._w4a8_smem(blocks, 8) == 64 * 1024 + 4 * 56  # three CTAs an SM
        assert tk._w4a8_ranks(M, 12800, K // 2) == 1
