"""Time the port's attention kernels and quantized GEMMs of one source tree on
the card, to compare two commits on one card. ``--gemms`` builds only the GEMM sources
and times only ``moe_kernels`` and ``fp_kernels`` (K6, K10, K11, K12, K7,
K8, K9, K13); the rows of K6 / K10 at straddle K and of K9 / K13 with a
64-row tail are left out for a tree whose kernels refuse those shapes
(one without ``nvfp4_gemm_ok``).

    python3 attention_ab.py TREE [--prefill]   # TREE: a checkout holding modelopt_tpu_torch/
    python3 attention_ab.py TREE --gemms       # the quantized GEMMs only

Builds the tree's ``decode_attention``, ``fused_decode_attention``,
``flash_attention``, ``flash_prefill_attention``, ``w4a8_gemm``,
``w4a16_gemm``, ``grouped_w4a8_gemm``, ``w8a16_gemm``, ``nvfp4_gemm``,
``kv_write`` and ``paged_kv_write`` sources, then times K3
dense_kv_write, K5 decode_attention, K2 fused_decode_attention, K1
w4a8_gemm, K4 flash_prefill_attention, K14 flash_attention, K6
w4a16_gemm, K10 grouped_w4a16_gemm, K7 w8a16_gemm, K8 wfp8_gemm, K9
nvfp4_gemm, K11 / K12 grouped_w4a8(_combine)_gemm, K13
grouped_nvfp4_gemm, K15 paged_decode_attention, K16 paged_kv_write and
K17 block_sparse_decode_attention at every case of ``chip_smoke.py``'s
``kv_write_kernels`` (K3 at a 544-row chunk, int8 and e4m3, and at a
decode step of one row a slot, 1024 and 640 bytes), ``mla_decode_kernel``
(K5 at MLA's geometry: lengths 1..1088, two chunks, 33..56 keys, and a
bf16 cache), ``fused_decode_kernels``, ``w4a8_kernels``,
``flash_prefill_kernels``, ``flash_kernels``, ``moe_kernels``,
``fp_kernels``, ``paged_kernels`` (K15 at E's, L's, F's and O's geometry,
F and O also at 33..56 keys), ``block_sparse_kernels`` and, where the tree
has them, ``kv_pair_kernels`` (K3's ``dense_kv_write_pair``),
``paged_rows_kernels`` (K16's ``paged_kv_write_rows``) and
``e4m3_branch_kernels`` (K5 on e4m3 caches at path N's latent rows and the
MHA decodes K2 turns away, K17 on e4m3 caches at J's rows), each held to the
tree's plain twin at the bar stated there (a tree without those entries
times, at the same cases, the calls its models made for a layer: two
one-cache K3 writes, and ``_page_slots``, the zero pad and one
``paged_kv_write`` a pool) (the K5 / K15 rows at MLA's geometry
also to the tree's one-CTA body, which runs where V is a second buffer;
``chip_smoke.py``'s one-launch checks and K12's shared-memory count are
left to it, since a parent tree may sum K splits in a second launch or
lack the count), with its timer: CUDA events, median of 25 launches, the
50 MB L2 flushed and the stream spun before each; and the host time
of one call of the K2 and K1 wrappers (K2 at S = 2176, K1 at 4096 x 4096,
M = 8 and 544; calls enqueued behind a spin of the stream), and
``chip_smoke.py``'s ``write_census`` without its checks (host launch calls
and device kernels of one paged decode forward). Inputs
are seeded, the same in every tree. ``--prefill`` also builds path A's
model (Llama-3-8B W4A8 + int8 KV, random weights, seed 0, KV scales from one
64-token forward), then path C's (Qwen3-30B-A3B, 24 of 48 layers, W4A16 +
bf16 KV) in the tree and runs ``chip_smoke.py``'s prefill window on each:
one 1024-token prompt prefilled in the engine's chunks to its first token's
logits, wall and device busy time by kernel. Prints the card's name and
power limit, then one line per tree. Run
it for each tree in turns (parent, change, change, parent) in one call, one
process a tree: the package names collide. The functions of
``chip_smoke.py`` come from this file's directory, the package from TREE."""
import importlib.util
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_ab", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from modelopt_tpu_torch.kernels import _build  # noqa: E402
from modelopt_tpu_torch.kernels import attention as ka  # noqa: E402

prefill = "--prefill" in sys.argv[2:]
gemms = "--gemms" in sys.argv[2:]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all(("w4a16_gemm", "grouped_w4a8_gemm", "w8a16_gemm", "nvfp4_gemm") if gemms else
                 ("decode_attention", "fused_decode_attention", "flash_attention",
                  "flash_prefill_attention", "w4a8_gemm", "w4a16_gemm", "grouped_w4a8_gemm",
                  "w8a16_gemm", "nvfp4_gemm", "kv_write", "paged_kv_write"))
cs.one_launch = lambda *args: None  # the tree's own chip_smoke.py checks its launch counts
cs.combine_smem_agrees = lambda *args: None  # and K12's shared-memory count
from modelopt_tpu_torch.kernels import quant_gemm as kq  # noqa: E402

if not hasattr(kq, "nvfp4_gemm_ok"):  # a tree before straddle K in K6 / K10 and K9 / K13's tail
    cs.w4a16_straddle_rows = cs.nvfp4_tail_rows = lambda *args: None
# a tree before K1's decode-tile redesign names that tile w4a8_kernel
cs.PREFILL_SPLIT["A"] = (("K1", ("w4a8_dec_kernel", "w4a8_wg_kernel", "::w4a8_kernel<")),
                         *cs.PREFILL_SPLIT["A"][1:])
timer = cs.Timer(torch)
print(f"{os.path.basename(tree) or tree}: card {cs.card_line()}", flush=True)
dev = "cuda"
gen = torch.Generator(device=dev).manual_seed(0)
out = {}

# every kernel at chip_smoke's cases, each against the tree's twin
rows: dict = {}
from modelopt_tpu_torch.kernels import paged_attention as kp  # noqa: E402

one_launch_writes = hasattr(kp, "paged_kv_write_rows")
# a tree with K5's and K17's e4m3 branches also times their rows
e4m3_branches = hasattr(ka, "e4m3_pair_decode")
phases = (cs.kv_write_kernels, cs.mla_decode_kernel, cs.fused_decode_kernels,
          cs.flash_prefill_kernels, cs.flash_kernels, cs.w4a8_kernels, cs.moe_kernels,
          cs.fp_kernels, cs.paged_kernels, cs.block_sparse_kernels) + (
              (cs.kv_pair_kernels, cs.paged_rows_kernels) if one_launch_writes else ()) + (
              (cs.e4m3_branch_kernels,) if e4m3_branches else ())
for phase in (cs.moe_kernels, cs.fp_kernels) if gemms else phases:
    phase(torch, torch.Generator(device=dev).manual_seed(0), timer, cs.recorder(rows))
if not one_launch_writes and not gemms:
    # a tree before the one-launch layer writes: the calls its models made
    # for a layer, at the same cases
    import torch.nn.functional as F  # noqa: E402

    from modelopt_tpu_torch.models import transformer as tt  # noqa: E402

    g = torch.Generator(device=dev).manual_seed(0)
    for label, caches, vals, start in cs.kv_pair_cases(torch, g):
        out[f"K3 {label}"] = timer(
            lambda: [ka.dense_kv_write(c, v, start) for c, v in zip(caches, vals)])
    for label, pools, prow, pt, pos, _ in cs.paged_rows_cases(torch, g):
        def layer_write():
            pids, offs = tt._page_slots(pt, pos, pools[0].shape[1])
            for p, v in zip(pools, prow):
                pad = p.shape[-1] - v.shape[-1]
                kp.paged_kv_write(p, F.pad(v, (0, pad)) if pad else v, pids, offs)
        out[f"K16 {label}"] = timer(layer_write)
for model, counts in ({} if gemms else cs.write_census(torch, strict=False)).items():
    for what, n in zip(("host launch calls", "device kernel records"), counts):
        out[f"census {model} {what}"] = n
for name, tag in (("dense_kv_write", "K3"), ("decode_attention", "K5"),
                  ("fused_decode_attention", "K2"), ("flash_prefill_attention", "K4"),
                  ("flash_attention", "K14"), ("w4a8_gemm", "K1"), ("w4a16_gemm", "K6"),
                  ("grouped_w4a16_gemm", "K10"), ("w8a16_gemm", "K7"), ("wfp8_gemm", "K8"),
                  ("nvfp4_gemm", "K9"), ("grouped_nvfp4_gemm", "K13"),
                  ("grouped_w4a8_gemm", "K11"), ("grouped_w4a8_combine_gemm", "K12"),
                  ("paged_decode_attention", "K15"), ("paged_kv_write", "K16"),
                  ("block_sparse_decode_attention", "K17")):
    for r in rows.get(name, ()):
        out[f"{tag} {r['shape']}"] = r["ms"]


def host_us(fn, n: int = 100) -> float:
    """Host time of one wrapper call (us): n calls enqueued behind a ~20 ms
    spin of the stream, so that no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


if gemms:
    print(f"{os.path.basename(tree) or tree}: "
          + " | ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    sys.exit(0)
pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0], dtype=torch.int32, device=dev)
ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
q = torch.randn(8, 8, 4, 128, generator=gen, device=dev).to(torch.bfloat16)
kc, vc = (torch.randint(-127, 128, (8, 2176, 1024), generator=gen, device=dev,
                        dtype=torch.int8) for _ in range(2))
kn, vn = (torch.randint(-127, 128, (8, 1, 1024), generator=gen, device=dev,
                        dtype=torch.int8) for _ in range(2))
out["K2 host us"] = host_us(lambda: ka.fused_decode_attention(q, kn, vn, kc, vc, pos, ks, vs))
packed = torch.randint(0, 256, (2048, 4096), generator=gen, device=dev, dtype=torch.uint8)
scale = torch.rand(32, 4096, generator=gen, device=dev) * 0.01
for M in (8, 544):
    xq = torch.randint(-127, 128, (M, 4096), generator=gen, device=dev, dtype=torch.int8)
    out[f"K1 M={M} host us"] = host_us(lambda: kq.w4a8_gemm(xq, packed, scale))
del kc, vc
print(f"{os.path.basename(tree) or tree}: " + " | ".join(f"{k} {v:.4f}" for k, v in out.items()),
      flush=True)

if prefill:
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.quant.api import calibrate

    cfg = cs.path_config(torch, "llama3_8b")
    bundle = build_compressed_bundle(cfg, "W4A8_INT8KV_CFG", seed=0, device=dev)
    ids = torch.randint(1, cfg.vocab_size, (1, 64), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    calibrate(bundle, "max", lambda f: f(ids, make_cache(cfg, 1, 64, device=dev)))
    print(f"{os.path.basename(tree) or tree}: path A prefill window", flush=True)
    cs.prefill_window(torch, bundle, cfg, torch.int8, "A")
    del bundle
    torch.cuda.empty_cache()
    # path C: Qwen3-30B-A3B (24 of 48 layers) under W4A16, bf16 KV (K6, K10)
    cfg = cs.path_config(torch, "qwen3_moe")
    bundle = build_compressed_bundle(cfg, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", seed=0, device=dev)
    print(f"{os.path.basename(tree) or tree}: path C prefill window", flush=True)
    cs.prefill_window(torch, bundle, cfg, torch.bfloat16, "C")
