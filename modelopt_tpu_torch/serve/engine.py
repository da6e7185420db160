"""Continuous-batching serving engine for quantized decoders.

Port of ``modelopt_tpu/serve/engine.py`` (dense or paged KV cache, plain
decode):

  * a fixed slot count and a static [B, S, KH*D] KV cache with per-slot
    ``lengths``; slots admit new requests as others finish;
  * ``paged=True``: page pools shared by all slots instead
    (``serve/paged_cache.py``); a request gets pages for its prompt when it
    is admitted (it waits in the queue while the pool is short), decoding
    slots grow by the tokens a tick or burst can write, and a finished
    request's pages go back to the pool;
  * every tick admits up to ``max_admit`` queued requests and runs one
    decode for all decoding slots; prompts longer than the largest prefill
    bucket stream in bucket-size chunks, one chunk per tick;
  * a slot's prefill runs through the views ``cache[l][slot:slot+1]`` (paged:
    the whole pools and the slot's page-table row), so the kernels write
    the engine's cache in place (the reference slices and re-inserts it
    with dynamic_slice / dynamic_update_slice);
  * decode ticks write every slot's KV at ``lengths[b]`` — idle and
    prefilling slots too, at a row that is overwritten before it is read —
    and advance only the decoding slots;
  * ``multi_step=n`` runs n decode ticks per host sync when nothing else
    is pending; eos / max_new_tokens / cache-cap stopping happen on the
    device, stop sequences on the host;
  * sampling is greedy or temperature (the Gumbel trick) per slot, from a
    ``torch.Generator`` on the engine's device; every emitted token carries
    its log-probability under the unfiltered, untempered distribution.

Speculative modes, a device mesh, and the top-k / top-p / min-p filters
and penalties are not ported: the engine and ``submit`` raise
NotImplementedError for them. So does a skip-softmax bundle, which the
reference engine cannot serve either (its shared block summaries fail the
donating prefill, and its prefill never writes them).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

import torch

from ..core.bundle import ModelBundle
from ..models.transformer import make_cache
from .paged_cache import (PagedAllocator, PagedCacheConfig, make_paged_cache, pages_needed,
                          write_page_table)


@dataclasses.dataclass
class Request:
    id: int
    prompt: list
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # token-id stop sequences: generation ends when the output tail matches
    # one; the matched tail is trimmed from out_tokens
    stop_sequences: tuple = ()
    out_tokens: list = dataclasses.field(default_factory=list)
    out_logprobs: list = dataclasses.field(default_factory=list)
    stop_reason: Optional[str] = None  # "eos" | "stop" | "length"
    done: bool = False
    slot: Optional[int] = None
    prefill_pos: int = 0  # tokens of the prompt already ingested


def _sample_lp(logits: torch.Tensor, temps: torch.Tensor, gen: torch.Generator):
    """logits [B, V], temps [B] -> (tokens int32 [B], logprobs f32 [B]):
    argmax where temp <= 0, else argmax(logits/temp + Gumbel noise); the
    logprob is under the untempered distribution."""
    f32 = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    u = torch.rand(f32.shape, generator=gen, device=f32.device)
    gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
    t = temps.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(f32 / t + gumbel, dim=-1)
    tok = torch.where(temps <= 0.0, greedy, sampled)
    lp = torch.log_softmax(f32, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok.to(torch.int32), lp


class ServingEngine:
    def __init__(self, bundle: ModelBundle, max_batch: int = 8,
                 max_seq_len: int = 512, prefill_buckets=(64, 256),
                 kv_dtype=None, seed: int = 0, speculative: int = 0,
                 paged: bool = False, page_size: int = 64, kv_pages: Optional[int] = None,
                 max_admit: int = 2, multi_step: int = 1, spec_sampling: bool = False,
                 spec_tree=None, mesh=None, device="cuda"):
        """``paged=True`` switches to the paged KV cache of ``page_size``-row
        pages; ``kv_pages`` sizes the pool, the null page included (default:
        the worst case ``max_batch * max_seq_len / page_size + 1``; pass less
        to oversubscribe)."""
        if speculative or spec_sampling or spec_tree is not None:
            raise NotImplementedError("speculative decoding is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported yet")
        if multi_step < 1:
            raise ValueError("multi_step must be >= 1")
        if getattr(bundle.module.cfg, "skip_softmax", None) is not None:
            raise NotImplementedError(
                "skip-softmax bundles are not served: the reference engine cannot serve "
                "them either. Its make_cache gives every layer the same kmax / kmin "
                "array, so its donating prefill fails ('Attempt to donate the same buffer "
                "twice'), and its prefill builds the chunk's sub-cache without the "
                "summaries, so prompt blocks keep their -3e38 bounds. Prefill and decode "
                "such a bundle through bundle.apply with a make_cache cache instead")
        self.bundle = bundle
        self.cfg = bundle.module.cfg
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.max_admit = max_admit
        self.multi_step = int(multi_step)
        # buckets clamped to the cache, each dividing max_seq_len and every
        # larger bucket (chunk starts stay bucket-aligned inside the cache)
        self.prefill_buckets = tuple(sorted({min(b, max_seq_len)
                                             for b in prefill_buckets}))
        for i, small in enumerate(self.prefill_buckets):
            if max_seq_len % small:
                raise ValueError(
                    f"max_seq_len ({max_seq_len}) must be a multiple of every "
                    f"prefill bucket (got {self.prefill_buckets}); pass "
                    "compatible prefill_buckets")
            for big in self.prefill_buckets[i + 1:]:
                if big % small:
                    raise ValueError(
                        "each prefill bucket must divide every larger one "
                        "(chunked-prefill starts must stay bucket-aligned)")
        self.paged = paged
        if paged:
            if max_seq_len % page_size:
                raise ValueError("max_seq_len must be a page_size multiple")
            pmax = max_seq_len // page_size
            n_pages = kv_pages or (max_batch * pmax + 1)
            self.pcfg = PagedCacheConfig(page_size=page_size, n_pages=n_pages,
                                         max_pages_per_slot=pmax)
            self.cache = make_paged_cache(self.cfg, max_batch, self.pcfg, dtype=kv_dtype,
                                          device=self.device)
            self.allocator = PagedAllocator(n_pages)
        else:
            self.cache = make_cache(self.cfg, max_batch, max_seq_len, dtype=kv_dtype,
                                    device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._slots: list[Optional[Request]] = [None] * max_batch
        self._queue: deque[Request] = deque()
        self._pending_prefills: list = []  # (req, packed) awaiting the host
        self._prefilling: set[int] = set()
        self._ids = itertools.count()
        dev = self.device
        self._tokens = torch.zeros(max_batch, 1, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(max_batch, dtype=torch.float32, device=dev)
        self._eos = torch.full((max_batch,), -1, dtype=torch.int32, device=dev)
        self.stats = {"prefill_chunks": 0, "prefill_tokens": 0,
                      "decode_forwards": 0, "decode_slot_steps": 0,
                      "tokens_emitted": 0}

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens: int = 64,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               min_p: float = 0.0, repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
               eos_id=None, stop_sequences=None) -> Request:
        if (top_k, top_p, min_p) != (0, 1.0, 0.0):
            raise NotImplementedError("top-k / top-p / min-p filters are not ported yet")
        if (repetition_penalty, presence_penalty, frequency_penalty) != (1.0, 0.0, 0.0):
            raise NotImplementedError("sampling penalties are not ported yet")
        prompt = list(map(int, prompt_tokens))
        if len(prompt) >= self.max_seq_len:
            raise ValueError("prompt exceeds max_seq_len")
        req = Request(
            id=next(self._ids), prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), eos_id=eos_id,
            stop_sequences=tuple(tuple(map(int, ss)) for ss in (stop_sequences or ())),
        )
        self._queue.append(req)
        return req

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_decoding(self) -> int:
        return sum(r is not None and i not in self._prefilling
                   for i, r in enumerate(self._slots))

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]  # longer prompts stream in chunks

    # ------------------------------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        req.slot = slot
        self._slots[slot] = req
        self._prefilling.add(slot)
        if self.paged:
            n = pages_needed(len(req.prompt) + 1, self.pcfg.page_size)
            pages = self.allocator.alloc(slot, n)
            if pages is None:  # pool exhausted: requeue and leave the slot
                self._slots[slot] = None
                self._prefilling.discard(slot)
                req.slot = None
                self._queue.appendleft(req)
                return
            write_page_table(self.cache, slot, pages)

    def _prefill_chunk(self, req: Request) -> int:
        """Ingest the next chunk of req's prompt; returns tokens emitted."""
        slot, start = req.slot, req.prefill_pos
        bucket = self._bucket(len(req.prompt) - start)
        chunk = req.prompt[start:start + bucket]
        ids = torch.zeros(1, bucket, dtype=torch.int32)
        ids[0, :len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
        final = start + len(chunk) >= len(req.prompt)
        self.stats["prefill_chunks"] += 1
        lengths = torch.full((1,), start, dtype=torch.int32, device=self.device)
        if self.paged:
            sub = {"k": self.cache["k"], "v": self.cache["v"], "lengths": lengths,
                   "page_table": self.cache["page_table"][slot:slot + 1]}
        else:
            sub = {"k": tuple(a[slot:slot + 1] for a in self.cache["k"]),
                   "v": tuple(a[slot:slot + 1] for a in self.cache["v"]),
                   "lengths": lengths}
        # logits only at the chunk's last true token
        logits, _ = self.bundle.apply(
            ids.to(self.device), sub,
            logits_index=torch.full((1,), len(chunk) - 1, device=self.device))
        self.cache["lengths"][slot] = start + len(chunk)
        req.prefill_pos = start + len(chunk)
        if not final:
            return 0
        self._prefilling.discard(slot)
        temp = torch.full((1,), req.temperature, device=self.device)
        tok, lp = _sample_lp(logits, temp, self._gen)
        # the slot's fed-back token stays on the device; the host reads the
        # (token, logprob) pair after the next decode is queued
        self._tokens[slot, 0] = tok[0]
        self._temps[slot] = req.temperature
        self._eos[slot] = -1 if req.eos_id is None else int(req.eos_id)
        self._pending_prefills.append((req, torch.stack([tok[0].float(), lp[0]])))
        return 1

    def _drain_prefills(self) -> None:
        for req, packed in self._pending_prefills:
            tok, lp = packed.tolist()
            req.out_tokens.append(int(tok))
            req.out_logprobs.append(float(lp))
            self.stats["prefill_tokens"] += 1
            self._finish_if_done(req)
        self._pending_prefills.clear()

    def _active_mask(self) -> torch.Tensor:
        return torch.tensor([r is not None and i not in self._prefilling
                             for i, r in enumerate(self._slots)], device=self.device)

    def _grow_pages(self, lookahead: int = 1) -> None:
        """Give each decoding slot pages for its next ``lookahead`` tokens (a
        burst writes up to that many before the host regains control)."""
        for slot, req in enumerate(self._slots):
            if req is None or slot in self._prefilling:
                continue
            cur_len = len(req.prompt) + len(req.out_tokens)
            # the device deactivates a slot at the cache cap, so never ask
            # the allocator for pages past max_seq_len
            need = pages_needed(min(cur_len + lookahead, self.max_seq_len),
                                self.pcfg.page_size)
            have = len(self.allocator.owned.get(slot, []))
            if need > have:
                if self.allocator.alloc(slot, need - have) is None:
                    raise RuntimeError("KV page pool exhausted; raise kv_pages or lower load")
                write_page_table(self.cache, slot, self.allocator.owned[slot])

    def _decode_tick(self, tokens, active):
        """One decode forward over all slots; lengths advance where active."""
        old = self.cache["lengths"]
        logits, cache = self.bundle.apply(tokens, self.cache)
        self.cache = {**cache, "lengths": old + active.to(torch.int32)}
        return _sample_lp(logits[:, -1], self._temps, self._gen)

    def step(self) -> int:
        """One scheduler tick: prefill chunks and admissions, then decode.
        Returns the number of tokens produced."""
        produced = 0
        for slot in sorted(self._prefilling):
            req = self._slots[slot]
            if req is not None:
                produced += self._prefill_chunk(req)
        admitted = 0
        while self._queue and admitted < self.max_admit:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                break
            req = self._queue.popleft()
            self._admit(req, free[0])
            if req.slot is None:
                break  # page pool full: stop admitting this tick
            produced += self._prefill_chunk(req)
            admitted += 1
        if self.num_decoding == 0:
            self._drain_prefills()
            return produced
        n = self.multi_step if (not self._queue and not self._prefilling) else 1
        if n > 1:
            # the burst counts host-side emissions: settle deferred prefill
            # tokens before the pages are sized
            self._drain_prefills()
        if self.paged:
            self._grow_pages(lookahead=n)
        if n > 1:
            return produced + self._burst(n)
        toks, lps = self._decode_tick(self._tokens, self._active_mask())
        self.stats["decode_forwards"] += 1
        self._tokens = toks[:, None]
        self._drain_prefills()
        packed = torch.stack([toks.float(), lps], dim=1).cpu()  # one host sync
        decoded = 0
        for slot, req in enumerate(self._slots):
            if req is None or req.done or slot in self._prefilling:
                continue
            req.out_tokens.append(int(packed[slot, 0]))
            req.out_logprobs.append(float(packed[slot, 1]))
            decoded += 1
            self._finish_if_done(req)
        self.stats["tokens_emitted"] += decoded
        self.stats["decode_slot_steps"] += decoded
        return produced + decoded

    def _burst(self, n: int) -> int:
        """n decode ticks with one host sync; per-slot stopping on device
        (``step`` drains the deferred prefill tokens first)."""
        dev = self.device
        active = self._active_mask()
        remaining = torch.tensor(
            [0 if (r is None or r.done) else max(0, r.max_new_tokens - len(r.out_tokens))
             for r in self._slots], dtype=torch.int32, device=dev)
        tokens = self._tokens
        rows = []
        for _ in range(n):
            act = active.to(torch.int32)
            toks, lps = self._decode_tick(tokens, active)
            emit = active
            remaining = remaining - act
            active = (active & (toks != self._eos) & (remaining > 0)
                      & (self.cache["lengths"] < self.max_seq_len))
            rows.append(torch.stack([toks.float(), lps, emit.float()], dim=1))
            tokens = toks[:, None]
        self._tokens = tokens
        self.stats["decode_forwards"] += n
        packed = torch.stack(rows).cpu()  # [n, B, 3] — one host sync
        decoded = 0
        for i in range(n):
            for slot, req in enumerate(self._slots):
                if req is None or req.done or not packed[i, slot, 2] > 0:
                    continue
                req.out_tokens.append(int(packed[i, slot, 0]))
                req.out_logprobs.append(float(packed[i, slot, 1]))
                decoded += 1
                self._finish_if_done(req)
        self.stats["tokens_emitted"] += decoded
        self.stats["decode_slot_steps"] += decoded
        return decoded

    def _finish_if_done(self, req: Request) -> None:
        hit_eos = (req.eos_id is not None and req.out_tokens
                   and req.out_tokens[-1] == req.eos_id)
        hit_stop = None
        for ss in req.stop_sequences:
            if len(req.out_tokens) >= len(ss) and tuple(req.out_tokens[-len(ss):]) == ss:
                hit_stop = ss
                break
        total_len = len(req.prompt) + len(req.out_tokens)
        if (len(req.out_tokens) >= req.max_new_tokens or hit_eos
                or hit_stop is not None or total_len >= self.max_seq_len):
            req.stop_reason = ("eos" if hit_eos else "stop" if hit_stop is not None
                               else "length")
            if hit_stop is not None:
                req.out_tokens = req.out_tokens[:-len(hit_stop)]
                req.out_logprobs = req.out_logprobs[:-len(hit_stop)]
            req.done = True
            if req.slot is not None:
                if self.paged:
                    self.allocator.free_slot(req.slot)
                    write_page_table(self.cache, req.slot, [])
                self._slots[req.slot] = None
                self._prefilling.discard(req.slot)
                req.slot = None

    def run(self, max_ticks: int = 100000) -> None:
        """Drive until queue and slots drain."""
        for _ in range(max_ticks):
            if not self._queue and self.num_active == 0:
                return
            self.step()
        raise RuntimeError("run() exceeded max_ticks")
