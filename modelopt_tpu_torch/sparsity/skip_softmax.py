"""Calibrated data-dependent attention sparsity (skip-softmax).

Port of ``modelopt_tpu/sparsity/skip_softmax.py``. Per-block K min/max
summaries give Quest-style per-block score upper bounds; a decode step
keeps a block iff

    ub(block) >= max_block ub - tau        (+ forced sink / recent blocks)

and attends only the kept blocks (``kernels/block_sparse_attention.py``).
The post-softmax mass of a dropped block is at most ``block_size *
exp(-tau)`` of the winning block's, so tau maps onto a softmax-mass recall
target; ``calibrate_skip_softmax`` measures the retained mass on RULER-style
needle sequences and picks the smallest tau meeting the target.

Summaries are written in place: ``update_block_summaries`` folds new keys
into the tensors it is given (the reference returns updated arrays).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.mode import ModeDescriptor
from .sparsification import SparsityModeRegistry


@dataclasses.dataclass(frozen=True)
class SkipSoftmaxConfig:
    """Static knobs; hashable so a DecoderConfig holding one stays frozen.

    budget bounds the worst-case block count (compute / HBM guarantee); tau
    does the data-dependent skipping below that bound.
    """

    block_size: int = 128
    tau: float = 8.0
    budget: float = 0.5          # max fraction of blocks attended
    sink_blocks: int = 1         # always keep the first blocks
    recent_blocks: int = 2       # always keep the newest blocks

    def num_selected(self, num_blocks: int) -> int:
        n = self.sink_blocks + self.recent_blocks + int(
            np.ceil(self.budget * num_blocks))
        return int(min(num_blocks, max(1, n)))


def init_block_summaries(batch: int, max_len: int, kv_heads: int, head_dim: int,
                         block_size: int, device="cuda"):
    """(kmax, kmin) [B, nb, KH, D] f32, initialised to -/+3e38 so untouched
    blocks bound to -inf scores."""
    nb = max_len // block_size
    shape = (batch, nb, kv_heads, head_dim)
    return (torch.full(shape, -3e38, dtype=torch.float32, device=device),
            torch.full(shape, 3e38, dtype=torch.float32, device=device))


def update_block_summaries(kmax, kmin, k_new, start, block_size: int):
    """Fold newly written keys into their blocks' summaries IN PLACE and
    return (kmax, kmin). k_new [B, T, KH, D] real values (dequantized if the
    cache holds codes); start [B] the first written position per slot. Keys
    of blocks past the summaries' end are dropped (the reference's
    ``mode="drop"``): they fold as -inf into kmax and +inf into kmin of the
    last block, which leaves it unchanged, so no index leaves the device."""
    B, T = k_new.shape[:2]
    nb = kmax.shape[1]
    dev = kmax.device
    blk = (start.long()[:, None] + torch.arange(T, device=dev)[None, :]) // block_size
    inside = (blk < nb)[:, :, None, None]
    rows = (torch.arange(B, device=dev)[:, None] * nb + blk.clamp(max=nb - 1)).reshape(-1)
    kf = k_new.float()
    KHD = kmax.shape[2] * kmax.shape[3]
    rows = rows[:, None].expand(B * T, KHD)
    inf = torch.tensor(float("inf"), device=dev)
    for summary, fill, how in ((kmax, -inf, "amax"), (kmin, inf, "amin")):
        vals = torch.where(inside, kf, fill).reshape(B * T, KHD)
        summary.view(B * nb, KHD).scatter_reduce_(0, rows, vals, how)
    return kmax, kmin


def block_upper_bounds(q, kmax, kmin):
    """Quest bound: ub[b, i] = max over heads and groups of
    sum_d max(q_d * kmax_d, q_d * kmin_d) / sqrt(D), q [B, KH, G, D] ->
    [B, nb] f32. Unwritten blocks' -/+3e38 summaries overflow to -inf."""
    D = q.shape[-1]
    qf = q.float()
    # max(q*kmax, q*kmin) = relu(q)*kmax + min(q,0)*kmin: exact, two einsums
    qp = qf.clamp_min(0.0)
    qn = qf.clamp_max(0.0)
    ub = (torch.einsum("bhgd,bihd->bhgi", qp, kmax)
          + torch.einsum("bhgd,bihd->bhgi", qn, kmin))
    return ub.amax(dim=(1, 2)) / torch.sqrt(torch.tensor(float(D), device=q.device))


def select_blocks(q, kmax, kmin, lengths, cfg: SkipSoftmaxConfig):
    """-> (sel [B, NSEL] int32, nvalid [B] int32): forced blocks first (in
    index order), then kept blocks by descending bound, ties to the lower
    index as ``jax.lax.top_k`` breaks them (the order sets where the
    block-sparse kernel rounds its 7-bit codes). Invalid tail entries of
    sel alias block 0."""
    B, nb = kmax.shape[:2]
    dev = kmax.device
    bs = cfg.block_size
    NSEL = cfg.num_selected(nb)
    ub = block_upper_bounds(q, kmax, kmin)                       # [B, nb]
    bidx = torch.arange(nb, device=dev)[None, :]
    n_blocks = (lengths.long()[:, None] + bs - 1) // bs           # blocks holding tokens
    in_range = bidx < n_blocks
    ninf = torch.tensor(float("-inf"), device=dev)
    ub = torch.where(in_range, ub, ninf)
    forced = ((bidx < cfg.sink_blocks) | (bidx >= n_blocks - cfg.recent_blocks)) & in_range
    m = ub.amax(dim=1, keepdim=True)
    keep = forced | (ub >= m - cfg.tau)
    order = torch.where(forced, -ninf, ub)
    order = torch.where(keep, order, ninf)
    sel = torch.sort(order, dim=1, descending=True, stable=True).indices[:, :NSEL]
    nvalid = torch.clamp(keep.sum(dim=1), max=NSEL).to(torch.int32)
    slot_ok = torch.arange(NSEL, device=dev)[None, :] < nvalid[:, None]
    sel = torch.where(slot_ok, sel, 0).to(torch.int32)
    return sel, nvalid


# ---------------------------------------------------------------------------
# Mode plumbing: the decoder with skip-softmax decode attention
# ---------------------------------------------------------------------------
def _with_config(module: nn.Module, cfg) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer
    tensor with ``module`` (nothing of the weights is copied), with ``cfg``
    on each submodule that holds a config. Buffers reassigned later (a
    calibrated amax) stay the copy's own, as the reference's functional
    variables would."""
    new = type(module).__new__(type(module))
    new.__dict__.update({k: copy.copy(v) if isinstance(v, dict) else v
                         for k, v in module.__dict__.items()})
    for name, child in module._modules.items():
        new._modules[name] = None if child is None else _with_config(child, cfg)
    if hasattr(module, "cfg"):
        new.cfg = cfg
    return new


@SparsityModeRegistry.register
class SkipSoftmaxMode(ModeDescriptor):
    """config keys = SkipSoftmaxConfig fields."""

    name = "skip_softmax"

    def convert(self, bundle, config):
        cfg = dataclasses.replace(bundle.module.cfg,
                                  skip_softmax=SkipSoftmaxConfig(**(config or {})))
        return bundle.replace(module=_with_config(bundle.module, cfg)), {}


def sparsify_attention_dynamic(bundle, block_size=128, tau=8.0, budget=0.5, sink_blocks=1,
                               recent_blocks=2):
    """Return a bundle whose decode steps attend only calibrated-relevant KV
    blocks (a replayable ``skip_softmax`` mode record)."""
    from ..core.bundle import apply_mode

    return apply_mode(bundle, "skip_softmax", {
        "block_size": block_size, "tau": tau, "budget": budget,
        "sink_blocks": sink_blocks, "recent_blocks": recent_blocks,
    })


# ---------------------------------------------------------------------------
# RULER-style synthetic long-context calibration data
# ---------------------------------------------------------------------------
def ruler_needle_batches(vocab_size: int, num_batches: int = 4, batch_size: int = 2,
                         seq_len: int = 1024, num_needles: int = 4, needle_len: int = 8,
                         seed: int = 0, device="cuda"):
    """Needle-in-a-haystack sequences: random filler with (key, value)
    needle spans planted at random depths and the needle keys replayed near
    the end, so attention from the tail must reach the planted spans. The
    same numpy draws as the reference, so the same ids from the same seed;
    a list of int32 [batch_size, seq_len] tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_batches):
        ids = rng.integers(0, vocab_size, (batch_size, seq_len))
        for b in range(batch_size):
            tail = seq_len - num_needles * needle_len - 1
            for n in range(num_needles):
                span = rng.integers(0, vocab_size, needle_len)
                depth = rng.integers(0, max(1, tail - needle_len))
                ids[b, depth:depth + needle_len] = span
                qpos = tail + n * needle_len
                ids[b, qpos:qpos + needle_len] = span
        out.append(torch.from_numpy(ids.astype(np.int32)).to(device))
    return out


def calibrate_skip_softmax(bundle, token_batches, recall_target: float = 0.99,
                           block_size: int = 128,
                           tau_grid=(2.0, 4.0, 6.0, 8.0, 12.0, 16.0), budget: float = 1.0):
    """Pick the smallest tau whose retained softmax mass meets
    ``recall_target`` on the worst (layer, batch), then return the bundle
    with skip-softmax at that tau and a report (tau, recalls, per-head
    recalls, the worst head).

    q and k come from the q / k quantizers' capture points: one uncached
    forward per batch in CAPTURE phase (on long batches its attention runs
    ``flash_attention``)."""
    from ..core.bundle import PHASE_CAPTURE
    from ..nn.quantizer import capture_filter

    recalls = {tau: 1.0 for tau in tau_grid}
    # per-(layer, head) retained-mass minima over the calibration stream:
    # the shared block table is governed by the worst head
    head_stats: dict = {}
    for ids in token_batches:
        with capture_filter("*attn/[qk]_quantizer"):
            _, records = bundle.apply(ids, phase=PHASE_CAPTURE, capture=True)
        layers: dict = {}
        for path, xs in records.items():
            lname, _, rest = path.partition("/")
            if lname.startswith("layers_"):
                layers.setdefault(lname, {})[rest.rsplit("/", 1)[-1]] = xs[0]
        B, T = ids.shape
        for lname, cap in layers.items():
            qx, kx = cap["q_quantizer"], cap["k_quantizer"]
            D = qx.shape[-1]
            q = qx.float().cpu().numpy().reshape(B, T, -1, D)
            k = kx.float().cpu().numpy().reshape(B, T, -1, D)
            r, heads = _tail_recall_curve(q, k, block_size, tau_grid, return_heads=True)
            hs = head_stats.setdefault(lname, {})
            for tau in tau_grid:
                recalls[tau] = min(recalls[tau], r[tau])
                prev = hs.get(tau)
                hs[tau] = heads[tau] if prev is None else np.minimum(prev, heads[tau])
    chosen: Optional[float] = None
    for tau in sorted(tau_grid):
        if recalls[tau] >= recall_target:
            chosen = tau
            break
    if chosen is None:
        chosen = max(tau_grid)
    worst = None
    if head_stats:
        worst = min(((ln, int(np.argmin(hs[chosen])), float(hs[chosen].min()))
                     for ln, hs in head_stats.items() if chosen in hs),
                    key=lambda t: t[2], default=None)
    b = sparsify_attention_dynamic(bundle, block_size=block_size, tau=chosen, budget=budget)
    return b, {
        "tau": chosen,
        "recalls": {str(t): float(r) for t, r in recalls.items()},
        "per_head_recalls": {ln: {str(t): [float(x) for x in hs[t]] for t in tau_grid}
                             for ln, hs in head_stats.items()},
        "worst_head": (None if worst is None else
                       {"layer": worst[0], "head": worst[1], "recall": worst[2]}),
    }


def _tail_recall_curve(q, k, block_size, tau_grid, return_heads=False):
    """Retained softmax mass for the LAST query position (the decode
    regime) per tau, in numpy as the reference computes it. q / k
    [B, T, H(kv), D]. With ``return_heads`` also per-head minima over the
    batch ({tau: [H] array})."""
    B, T, KH, D = k.shape
    nb = T // block_size
    if nb < 2:
        flat = {tau: 1.0 for tau in tau_grid}
        if return_heads:
            H = q.shape[2]
            return flat, {tau: np.ones(H) for tau in tau_grid}
        return flat
    Tb = nb * block_size
    kb = k[:, :Tb].reshape(B, nb, block_size, KH, D)
    kmax = kb.max(axis=2)
    kmin = kb.min(axis=2)
    G = q.shape[2] // KH
    qlast = q[:, Tb - 1].reshape(B, KH, G, D)  # last in-block query
    ub = block_upper_bounds(torch.from_numpy(np.ascontiguousarray(qlast)),
                            torch.from_numpy(kmax), torch.from_numpy(kmin)).numpy()
    # true per-block mass at the last position
    s = np.einsum("bhgd,btkd->bhgt", qlast, k[:, :Tb].reshape(B, Tb, KH, D)) / np.sqrt(D)
    # collapse kv-head groups as select_blocks does (the worst case over
    # heads is what the shared block table serves)
    s = s.reshape(B, KH * G, Tb)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=-1, keepdims=True)
    pb = p.reshape(B, KH * G, nb, block_size).sum(-1)  # [B, H, nb]
    m = ub.max(axis=1, keepdims=True)  # [B, 1]
    out = {}
    heads = {}
    for tau in tau_grid:
        keep = ub >= m - tau  # [B, nb]
        kept_mass = (pb * keep[:, None, :]).sum(-1)  # [B, H]
        out[tau] = float(kept_mass.min())
        heads[tau] = kept_mass.min(axis=0)  # [H] worst over batch
    if return_heads:
        return out, heads
    return out
