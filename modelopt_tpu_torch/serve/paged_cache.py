"""Paged KV cache: device page pools and a host page-table allocator.

Port of ``modelopt_tpu/serve/paged_cache.py``. Pages are a global pool per
layer ``[n_pages, page_size, KH*D]`` (heads merged into the last dim, as
the dense cache) shared by every slot; a per-slot page table
``[max_batch, PMAX]`` maps a slot-local page index to a pool page id. KV
memory scales with the pages in use, not with ``max_batch * max_seq_len``,
and the pool can be smaller than the worst case.

Allocation is host bookkeeping; page ids are data, so the forward never
changes shape as pages move. Writes go through the page table with
``paged_kv_write_rows`` (K16, one launch a layer); decode reads through
``paged_decode_attention`` (K15), prefill gathers the pages dense
(``kernels/paged_attention.py``).

Page 0 is RESERVED as the null page: unused page-table entries point at it
so every routed read and write has a valid target, and the lengths mask
keeps it out of every live slot's attention.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PagedCacheConfig:
    page_size: int = 64
    n_pages: int = 256  # pool size INCLUDING the reserved null page
    max_pages_per_slot: int = 8  # PMAX: page-table width


class PagedAllocator:
    """Host-side free-list allocator over the page pool (page 0 reserved).
    The free list is the reference's stack, so the same calls hand out the
    same page ids."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # stack; 0 reserved
        self.owned: dict[int, list[int]] = {}  # slot -> page ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int):
        """Allocate n pages for slot; None (and no change) if unavailable."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.owned.setdefault(slot, []).extend(pages)
        return pages

    def free_slot(self, slot: int) -> None:
        self._free.extend(reversed(self.owned.pop(slot, [])))


def make_paged_cache(cfg, max_batch: int, pcfg: PagedCacheConfig, dtype=None,
                     device="cuda") -> dict:
    """Device state of a paged cache for a DecoderConfig ``cfg``: the dense
    cache's dict (``make_cache``) with pools in place of per-slot caches,
    plus an int32 ``page_table [max_batch, PMAX]``; the Decoder detects the
    key and takes the paged path. MLA: one padded latent pool per layer in
    "k" and a ``[n_pages, page_size, 0]`` placeholder in "v"."""
    dtype = dtype or cfg.dtype
    if cfg.attention_type == "mla":
        dc = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        kshape = (pcfg.n_pages, pcfg.page_size, -(-dc // 128) * 128)
        vshape = (pcfg.n_pages, pcfg.page_size, 0)
    else:
        kshape = vshape = (pcfg.n_pages, pcfg.page_size, cfg.kv_heads * cfg.dims_per_head)
    return {
        "k": tuple(torch.zeros(kshape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "v": tuple(torch.zeros(vshape, dtype=dtype, device=device)
                   for _ in range(cfg.num_layers)),
        "lengths": torch.zeros(max_batch, dtype=torch.int32, device=device),
        "page_table": torch.zeros(max_batch, pcfg.max_pages_per_slot, dtype=torch.int32,
                                  device=device),
    }


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def write_page_table(cache: dict, slot: int, pages: list) -> dict:
    """Replace one slot's page-table row (unused tail -> null page 0) in
    place: one host-to-device row copy."""
    pt = cache["page_table"]
    row = torch.zeros(pt.shape[1], dtype=torch.int32)
    row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
    pt[slot].copy_(row)
    return cache
