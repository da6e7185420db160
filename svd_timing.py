"""Time SVDQuant's low-rank step on the card at path S's projection shapes
(Llama-3-8B's fused q / k / v [4096, 6144], o [4096, 4096], fused gate /
up [4096, 28672] and down [14336, 4096], f32): ``svdquant.low_rank`` (an
f64 eigensolve of the smaller Gram matrix) against ``torch.linalg.svd`` in
f32 (the reference's thin SVD), both held to ``torch.linalg.svd`` in f64
(cuSOLVER's QR-based ``gesvd``).
Each weight is seeded noise N(0, 1/in) plus a planted rank-32 part whose
singular values stand well above the rest, so the top-32 subspace is well
posed and every method must return the same product L1 @ L2. Per shape:
each f32-input method's seconds (the card synchronized around one call,
after one warm-up call), the f64 SVD's (one call), and each product's max
|diff| from the f64 SVD's over its max |value|.

    python3 svd_timing.py

Prints the card's name and power limit, one line per shape, and a JSON
line of all rows last. Needs a CUDA card."""
import json
import subprocess
import sys
import time

import torch

SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
RANK = 32


def thin_svd(w, r, driver=None):
    U, S, Vh = torch.linalg.svd(w, full_matrices=False, driver=driver)
    return U[:, :r] * S[:r], Vh[:r]


def planted(shape, gen):
    k, n = shape
    u = torch.linalg.qr(torch.randn(k, RANK, device="cuda", generator=gen))[0]
    v = torch.linalg.qr(torch.randn(n, RANK, device="cuda", generator=gen))[0]
    sigma = torch.linspace(24.0, 12.0, RANK, device="cuda") * (max(shape) / k) ** 0.5
    return torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5 + (u * sigma) @ v.T


def timed(fn, *args):
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.time() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("svd_timing.py needs a CUDA card", file=sys.stderr)
        return 1
    from modelopt_tpu_torch.quant.algorithms.svdquant import low_rank

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        w = planted(shape, gen)
        t0 = time.time()
        a, b = thin_svd(w.double(), RANK, driver="gesvd")
        torch.cuda.synchronize()
        row = {"shape": list(shape), "svd_f64_s": time.time() - t0}
        want = a @ b
        for name, fn in (("low_rank", low_rank), ("svd_f32", thin_svd)):
            (a, b), row[f"{name}_s"] = timed(fn, w, RANK)
            row[f"{name}_err"] = ((a.double() @ b.double() - want).abs().max()
                                  / want.abs().max()).item()
        rows.append(row)
        print(f"{shape[0]}x{shape[1]}: low_rank (f64 Gram eigh) {row['low_rank_s']:.4f} s, "
              f"off by {row['low_rank_err']:.3g}; torch.linalg.svd f32 {row['svd_f32_s']:.4f} s, "
              f"off by {row['svd_f32_err']:.3g}; the f64 SVD's top-{RANK} product "
              f"({row['svd_f64_s']:.2f} s) the reference", flush=True)
        del w, a, b, want
    print(json.dumps({"svd_timing": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
