"""Time the port's decode-attention kernels of one source tree on the card,
to compare two commits on one card.

    python3 decode_attention_ab.py TREE     # TREE: a checkout holding modelopt_tpu_torch/

Builds the tree's ``decode_attention`` and ``fused_decode_attention``
sources, then times K2 fused_decode_attention, K5 decode_attention, K15
paged_decode_attention and K17 block_sparse_decode_attention at
``chip_smoke.py``'s kernel-phase shapes (int8 and bf16 caches; seeded
inputs, the same in every tree) with its timer: CUDA events, median of 25
launches, the 50 MB L2 flushed and the stream spun before each. Prints one
line per tree. Run it for each tree in turns (parent, change, change,
parent) in one call, one process a tree."""
import os, sys, statistics
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch
from modelopt_tpu_torch.kernels import _build
from modelopt_tpu_torch.kernels import attention as ka
from modelopt_tpu_torch.kernels import paged_attention as kp
from modelopt_tpu_torch.kernels import block_sparse_attention as kb
_build.build_all(("decode_attention", "fused_decode_attention"))
flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

def timer(fn, repeats=25):
    fn(); torch.cuda.synchronize()
    ts = []
    for _ in range(repeats):
        flush.zero_(); torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ts.append(a.elapsed_time(b))
    return statistics.median(ts)

dev = "cuda"
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
B, D = 8, 640
for S, top in ((2176, 1088), (512, 512)):
    q = (torch.randn(B, 1, 16, D, generator=gen, device=dev) * 2).to(torch.bfloat16)
    lat = torch.randint(-127, 128, (B, S, D), generator=gen, device=dev, dtype=torch.int8)
    lengths = torch.linspace(1, top, B, device=dev).round().to(torch.int32)
    sc = torch.tensor(0.03, device=dev)
    out[f"K5 int8 S={S}"] = timer(lambda: ka.decode_attention(q, lat, lat, lengths, sc, sc))
lat = torch.randn(B, 2176, D, generator=gen, device=dev).to(torch.bfloat16)
lengths = torch.linspace(1, 1088, B, device=dev).round().to(torch.int32)
out["K5 bf16"] = timer(lambda: ka.decode_attention(q, lat, lat, lengths))
ps, pmax, P = 64, 34, 145
lens = torch.tensor([1024, 1501, 8, 2176, 301, 1025, 2001, 1], dtype=torch.int32, device=dev)
perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0)) + 1
pt = torch.zeros(8, pmax, dtype=torch.int32); used = 0
for b, L in enumerate(lens.tolist()):
    n = -(-L // ps); pt[b, :n] = perm[used:used + n]; used += n
pt = pt.to(dev)
q = (torch.randn(8, 8, 4, 128, generator=gen, device=dev) * 2).to(torch.bfloat16)
for kind in ("int8", "bf16"):
    if kind == "int8":
        kpool, vpool = (torch.randint(-127, 128, (P, ps, 1024), generator=gen, device=dev, dtype=torch.int8) for _ in range(2))
        ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
    else:
        kpool, vpool = (torch.randn(P, ps, 1024, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    out[f"K15 {kind}"] = timer(lambda: kp.paged_decode_attention(q, kpool, vpool, pt, lens, ks, vs))
pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0], dtype=torch.int32, device=dev)
q = torch.randn(8, 8, 4, 128, generator=gen, device=dev).to(torch.bfloat16)
for kind in ("int8", "bf16"):
    if kind == "int8":
        kc, vc, kn, vn = (torch.randint(-127, 128, sh, generator=gen, device=dev, dtype=torch.int8) for sh in [(8, 2176, 1024)] * 2 + [(8, 1, 1024)] * 2)
        ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
    else:
        kc, vc, kn, vn = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16) for sh in [(8, 2176, 1024)] * 2 + [(8, 1, 1024)] * 2)
        ks = vs = None
    out[f"K2 {kind}"] = timer(lambda: ka.fused_decode_attention(q, kn, vn, kc, vc, pos, ks, vs))
lengths = torch.tensor([1025, 1041, 1057, 1073, 1088, 1029, 1064, 1087], dtype=torch.int32, device=dev)
nvalid = torch.tensor([9, 5, 7, 4, 9, 6, 8, 3], dtype=torch.int32, device=dev)
sel = torch.zeros(8, 17, dtype=torch.int32)
for b, n in enumerate(nvalid.tolist()):
    sel[b, :n] = torch.tensor([0, 7, 8, 1, 2, 3, 4, 5, 6][:n], dtype=torch.int32)
sel = sel.to(dev)
kc, vc = (torch.randint(-127, 128, (8, 2176, 1024), generator=gen, device=dev, dtype=torch.int8) for _ in range(2))
ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
out["K17 int8"] = timer(lambda: kb.block_sparse_decode_attention(q, kc, vc, sel, nvalid, lengths, ks, vs, block_size=128))
print(os.path.basename(tree) or tree, " | ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
