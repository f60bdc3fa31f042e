"""Continuous batching over the KVNAND engine (port of
`repro.serving.scheduler`: `ContinuousBatcher`, synchronous, and the
`SpliceBatcher` baseline).

  * a fixed decode batch of B slots; empty slots are refilled from the
    queue between steps, by (priority, deadline, submit order);
  * an admitted prompt is prefilled chunk by chunk (page-aligned chunks
    of `prefill_chunk_tokens`) straight into its slot's stripe
    (`engine.prefill_chunk`);
  * every step spends a token budget: the decode batch (one token per
    decoding slot) is funded first, the remainder funds prefill chunks,
    and at least one chunk always runs;
  * the decode step carries an `active` mask, so slots that are empty or
    mid-prefill get no append and no length advance;
  * each request samples from its own (seed, tokens emitted) stream.

Shared-pool mode (``EngineConfig.shared_pool``, the paper's §IV-D
page-level mapping) replaces the per-slot stripes with ONE physical page
pool and moves allocation policy to this host scheduler, as in the
reference:

  * admission is by FREE-PAGE COUNT: a request is admitted when its
    worst-case footprint ceil((prompt + max_new) / T) pages fits the
    pool's free + cache-evictable pages net of outstanding reservations;
  * pages are allocated lazily as prefill chunks and decode appends land
    (`_ensure_page`), and the host tables are mirrored into the device
    table before the device work that reads them (`_push_tables`);
  * a prefix cache (`core/page_alloc.PrefixCache`) maps a new prompt's
    already-computed full-page prefixes read-only into its table, and a
    whole-prompt repeat skips prefill (its first token is sampled from
    the cached last-token logits); the first write into a shared page
    copies it on write: the allocator hands the slot a private page and
    the device copies the bytes, and a kv8/kv4 page its scales
    (`paged_kv.copy_page_shared`, on the same stream as the decode step
    that then appends into it); a prefix hit maps the physical page, so
    its scales come with it;
  * completion drops the slot's references; pages the prefix cache still
    names survive until LRU eviction reclaims them under pressure;
  * a window arch's rings draw from a second allocator: a slot's ring
    pages (at most NPw) are allocated whole at admission, reached through
    `page_table_w`, recycled in place and freed at completion; no prefix
    cache is kept, since a ring rewrites its pages.

An RWKV6 (`ssm`) model carries recurrent state, which padding would
pollute: its prompt is prefilled as ONE exact-length chunk (whatever
`prefill_chunk_tokens` says; the budget charges its full length), the
splice baseline prefills it unbucketed, and a shared-pool config builds
no allocator and no prefix cache (there is no page pool), as in the
reference.

Speculative draft-and-verify (``speculation_k`` > 0): every decode step
becomes a verify step.  Each decoding slot drafts up to k tokens by
prompt lookup over its own history (`serving/draft.py`), capped by its
request's `SamplingParams.speculation` and by what its max_new budget and
slot capacity leave; the engine scores the span in one pass
(`engine.verify_step`) and `speculative_accept` samples every position
from the request's own per-position stream, so the emitted tokens equal
sequential decode's.  Rejected positions are never written; on the shared
pool the pages backed for them go back to the allocator with the slot's
reservation restored.  A step in which no slot may draft runs as a plain
decode step.

`step()` is the reference's synchronous schedule (dispatch, then
collect, back to back).  `SpliceBatcher` is the reference's measured
baseline: each admit prefills the whole (bucketed) prompt in one shot
(`engine.prefill`, a ring filled from the true length) and splices the
one-row cache into its slot.  Not
ported yet, and refused at construction: the tiered pool and the
overlapped dispatch/collect pipeline (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import paged_kv
from repro_torch.core.engine import KVNANDEngine
from repro_torch.core.page_alloc import (CacheHit, OutOfPages, PageAllocator,
                                         PrefixCache)
from repro_torch.models.transformer import Runtime
from repro_torch.serving.draft import propose_draft
from repro_torch.serving.sampler import (SamplingParams, request_noise,
                                         sample_with_logprobs,
                                         speculative_accept)

MIN_PROMPT_BUCKET = 16


@dataclasses.dataclass
class Request:
    """One in-flight request; timing marks feed `RequestOutput`."""
    uid: int
    prompt: List[int]
    max_new: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    params: Optional[SamplingParams] = None
    logprobs: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None   # stop|length|capacity|aborted|deadline
    priority: int = 0
    deadline_ts: Optional[float] = None
    order: int = 0
    submit_ts: Optional[float] = None
    first_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    spec_steps: int = 0       # verify steps this request offered drafts in
    spec_drafted: int = 0     # draft tokens offered for verification
    spec_accepted: int = 0    # draft tokens accepted (and emitted)


def bucket_length(n: int, lo: int = MIN_PROMPT_BUCKET,
                  hi: Optional[int] = None) -> int:
    """Smallest power-of-two bucket (>= lo) holding n tokens, clamped to
    `hi` — near-capacity prompts must not round up past the slot stripe
    (the caller rejects n > hi at submit)."""
    b = lo
    while b < n:
        b *= 2
    if hi is not None:
        b = min(b, hi)
    return b


@dataclasses.dataclass
class _PrefillState:
    """Host-side carry-over of one slot's in-progress chunked prefill."""
    req: Request
    tokens: np.ndarray      # prompt, padded to the chunk grid
    n: int                  # true prompt length
    pos: int = 0            # next chunk's first token
    order: int = 0          # admission order (FIFO chunk scheduling)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_context: int = 512, eng: Optional[EngineConfig] = None,
                 rt: Optional[Runtime] = None, seed: int = 0,
                 bucket_prompts: bool = True,
                 prefill_chunk_tokens: int = 64,
                 step_token_budget: Optional[int] = None,
                 speculation_k: int = 0, device="cuda"):
        eng = eng or EngineConfig(page_tokens=16, uniform_lengths=False)
        if eng.uniform_lengths:
            raise ValueError(
                "continuous batching needs the ragged append path: pass "
                "an EngineConfig with uniform_lengths=False")
        if prefill_chunk_tokens % eng.page_tokens:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens} must be a "
                f"multiple of page_tokens={eng.page_tokens} so chunk "
                "starts stay page-aligned")
        if speculation_k < 0:
            raise ValueError(f"speculation_k must be >= 0, "
                             f"got {speculation_k}")
        if speculation_k > 0 and (cfg.family in ("ssm", "hybrid")
                                  or cfg.is_encoder_decoder):
            raise ValueError(
                f"{cfg.name}: speculative decoding needs rollback-able "
                "paged KV; recurrent/encoder-decoder state cannot roll "
                "back — run with speculation_k=0")
        self.spec_k = speculation_k
        self.cfg = cfg
        self.device = torch.device(device)
        self.engine = KVNANDEngine(cfg, eng, rt or Runtime(),
                                   device=self.device)
        self.params = params
        self.B = batch_slots
        self.max_context = max_context
        # pad one-shot prefills to power-of-two buckets (SpliceBatcher);
        # recurrent prefill would fold padding into state -> exact length
        recurrent = cfg.family == "ssm"
        self.bucket_prompts = bucket_prompts and not recurrent
        # ... and, chunked, prefills the whole prompt as one exact chunk
        self._whole_prompt = recurrent
        self.chunk_tokens = prefill_chunk_tokens
        self.step_token_budget = (step_token_budget
                                  or prefill_chunk_tokens + batch_slots)
        self.seed = seed
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.cache = self.engine.init_cache(batch_slots, max_context)
        self._lengths = np.zeros(batch_slots, np.int64)
        self._prefill_live: Dict[int, _PrefillState] = {}
        self._admit_seq = 0
        self._submit_seq = 0
        # per-slot sampling params (host arrays, staged each decode step)
        self._temps = np.zeros(batch_slots, np.float32)
        self._topk = np.zeros(batch_slots, np.int64)
        self._topp = np.ones(batch_slots, np.float32)
        self._seeds = np.zeros(batch_slots, np.uint32)
        self.completed: Dict[int, Request] = {}
        self.stats = {"steps": 0, "admits": 0, "prefill_chunks": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "decode_stall_tokens": 0,
                      "deadline_drops": 0, "prefix_hit_pages": 0,
                      "prompt_pages": 0, "cow_copies": 0,
                      "pool_peak_pages": 0, "pool_total_pages": 0,
                      "verify_steps": 0, "spec_steps": 0, "spec_drafted": 0,
                      "spec_accepted": 0}
        self.shared = eng.shared_pool
        self.alloc: Optional[PageAllocator] = None
        self.alloc_w: Optional[PageAllocator] = None     # window rings
        self.prefix_cache: Optional[PrefixCache] = None
        if self.shared:
            self._start_shared_pool()

    # -- shared-pool bookkeeping (allocator, tables, prefix cache) -----
    def _start_shared_pool(self):
        """The reference's `_init_shared_pool`, without the tier branch
        (not ported): an allocator over the global pool's pages and one
        over the window rings' pages, zeroed host tables, per-slot maps,
        and the prefix cache — for a global-pool-only dense arch, which
        is what prefix sharing needs (a ring recycles its pages in place,
        so a window arch shares none).  An RWKV6 cache has no pool: no
        allocator, no tables, no prefix cache."""
        c = self.cache
        self._table_np = None
        self._table_w_np = None
        if c.k_pages_g is not None:
            self._NPg = c.page_table_g.shape[1]
            self.alloc = PageAllocator(c.k_pages_g.shape[2])
            self._table_np = np.zeros((self.B, self._NPg), np.int32)
            self.stats["pool_total_pages"] = self.alloc.total
        if c.k_pages_w is not None:
            self._NPw = c.page_table_w.shape[1]
            self.alloc_w = PageAllocator(c.k_pages_w.shape[2])
            self._table_w_np = np.zeros((self.B, self._NPw), np.int32)
        # per-slot maps: logical page -> physical; shared = mapped with
        # refcount > 1 (read-only until copied on write); ring pages are
        # owned outright
        self._slot_pages: List[Dict[int, int]] = [{} for _ in range(self.B)]
        self._slot_shared: List[Set[int]] = [set() for _ in range(self.B)]
        self._slot_ring: List[List[int]] = [[] for _ in range(self.B)]
        self._resv = np.zeros(self.B, np.int64)   # reserved, not yet alloc'd
        self._outstanding = 0
        if self.alloc is not None and self.alloc_w is None:
            self.prefix_cache = PrefixCache(self.alloc,
                                            self.engine.eng.page_tokens)
        self._tables_dirty = True
        self._push_tables()

    def _push_tables(self):
        """Mirror the host page tables into the device tables, only when a
        mapping changed (a blocking copy: see `paged_kv.write_page_table`)."""
        if not self._tables_dirty:
            return
        if self._table_np is not None:
            paged_kv.write_page_table(self.cache.page_table_g,
                                      self._table_np)
        if self._table_w_np is not None:
            paged_kv.write_page_table(self.cache.page_table_w,
                                      self._table_w_np)
        self._tables_dirty = False

    def _alloc_g(self, logical: int) -> int:
        """One pool page, evicting prefix-cache LRU entries under pressure
        (their pages are the only reclaimable slack)."""
        while True:
            try:
                p = self.alloc.alloc_for_logical(logical)
                self.stats["pool_peak_pages"] = max(
                    self.stats["pool_peak_pages"], self.alloc.live_count)
                return p
            except OutOfPages:
                if not self.prefix_cache.evict_lru():
                    raise RuntimeError(
                        "shared page pool exhausted despite admission "
                        "reservations — allocator accounting bug") from None

    def _ensure_page(self, i: int, lp: int):
        """Slot i is about to WRITE logical page lp: allocate it fresh if
        unmapped, copy it on write if currently shared (refcount > 1)."""
        pages = self._slot_pages[i]
        if lp not in pages:
            p = self._alloc_g(lp)
            pages[lp] = p
            self._table_np[i, lp] = p
            self._tables_dirty = True
            self._resv[i] -= 1
            self._outstanding -= 1
            return
        if lp in self._slot_shared[i]:
            old = pages[lp]
            fresh = self.alloc.cow(old)
            if fresh != old:
                # one copy per pool leaf (kv8/kv4 scales too), on the
                # stream the next decode step runs on, so the bytes land
                # before its append
                c = self.cache
                for leaf in (c.k_pages_g, c.v_pages_g, c.k_scale_g,
                             c.v_scale_g):
                    if leaf is not None:
                        paged_kv.copy_page_shared(leaf, old, fresh)
                self._table_np[i, lp] = fresh
                pages[lp] = fresh
                self._tables_dirty = True
                self.stats["cow_copies"] += 1
                self._resv[i] -= 1
                self._outstanding -= 1
            self._slot_shared[i].discard(lp)
            self.stats["pool_peak_pages"] = max(
                self.stats["pool_peak_pages"], self.alloc.live_count)

    def _free_slot_pages(self, i: int):
        if not self.shared:
            return
        if self.alloc is not None and self._slot_pages[i]:
            self.alloc.free(list(self._slot_pages[i].values()))
        if self.alloc_w is not None and self._slot_ring[i]:
            self.alloc_w.free(self._slot_ring[i])
        self._slot_pages[i] = {}
        self._slot_shared[i] = set()
        self._slot_ring[i] = []
        self._outstanding -= int(self._resv[i])
        self._resv[i] = 0

    def _pages_needed(self, req: Request) -> int:
        total = min(len(req.prompt) + req.max_new, self.max_context)
        return -(-total // self.engine.eng.page_tokens)

    def _map_cached_pages(self, i: int, pages) -> int:
        """Map cached pages read-only into slot i's logical pages 0..len:
        one allocator reference each, marked shared (copy before write)."""
        for j, p in enumerate(pages):
            self.alloc.share([p])
            self._slot_pages[i][j] = p
            self._slot_shared[i].add(j)
            self._table_np[i, j] = p
        return len(pages)

    def _register_prefix(self, i: int, ps: "_PrefillState",
                         logits: np.ndarray):
        """Publish a freshly prefilled prompt's pages into the prefix
        cache.  Full pages are always safe to share (the slot never
        rewrites them).  The trailing PARTIAL page becomes shared too —
        making this slot's own first decode append copy it on write — but
        only when the pool has a free page of slack to fund that copy
        (the reservation grows by one to keep admission accounting
        exact)."""
        T = self.engine.eng.page_tokens
        n_pages = -(-ps.n // T)
        pages = [self._slot_pages[i][j] for j in range(n_pages)]
        partial = ps.n % T != 0
        slack = self.alloc.free_count - self._outstanding
        include_exact = (not partial) or slack >= 1
        added = self.prefix_cache.register(
            ps.req.prompt, pages, logits, include_exact=include_exact)
        if added and partial and include_exact:
            self._resv[i] += 1
            self._outstanding += 1
        for j, p in enumerate(pages):
            if self.alloc.refcount[p] > 1:
                self._slot_shared[i].add(j)

    # -- per-request sampling / lifecycle ------------------------------
    def _seed_of(self, req: Request) -> np.uint32:
        """The request's stream seed: its explicit `params.seed`, or a
        (batcher seed, uid) hash — independent of batch composition."""
        if req.params is not None and req.params.seed is not None:
            return np.uint32(req.params.seed & 0xFFFFFFFF)
        return np.uint32((self.seed * 0x9E3779B1 + req.uid * 0x85EBCA77
                          + 0x165667B1) & 0xFFFFFFFF)

    def _set_slot_params(self, i: int, req: Request):
        p = req.params
        self._temps[i] = p.temperature
        self._topk[i] = p.top_k
        self._topp[i] = p.top_p
        self._seeds[i] = self._seed_of(req)

    def _sample(self, logits: torch.Tensor, rows: List[int],
                positions: List[int]):
        """Sample `rows` (slot indices, one per logits row) through their
        own params and (seed, position) streams -> host (toks, lps)."""
        V = logits.shape[-1]
        idx = np.asarray(rows)
        temps = self._temps[idx]
        noise = None
        if (temps > 0).any():
            noise = request_noise(self._seeds[idx], positions, V,
                                  logits.device)
        dev = logits.device
        toks, lps = sample_with_logprobs(
            logits, noise, true_vocab=self.cfg.vocab_size,
            temperature=torch.as_tensor(temps, device=dev),
            top_k=torch.as_tensor(self._topk[idx], device=dev),
            top_p=torch.as_tensor(self._topp[idx], device=dev))
        return toks.cpu().numpy(), lps.cpu().numpy()

    def _finish(self, i: int, reason: str):
        """Retire slot i's request: a stripe is overwritten in place by
        the next occupant; a shared pool gets the slot's page references
        and reservations back."""
        req = self.slots[i]
        req.done = True
        req.finish_reason = reason
        req.finish_ts = time.monotonic()
        self.completed[req.uid] = req
        self.slots[i] = None
        self._lengths[i] = 0
        self._free_slot_pages(i)

    def _emit_token(self, i: int, req: Request, tok: int, lp: float):
        """Append one sampled token and apply the finish rules (stop
        token beats length; capacity is checked by the decode sweep)."""
        req.output.append(tok)
        if req.params.logprobs:
            req.logprobs.append(lp)
        if req.first_ts is None:
            req.first_ts = time.monotonic()
        if tok in req.params.stop_token_ids:
            self._finish(i, "stop")
        elif len(req.output) >= req.max_new:
            self._finish(i, "length")

    def abort(self, uid: int) -> bool:
        """Cancel a request wherever it is: queued, mid-chunked-prefill,
        or decoding.  A running request releases its shared-pool pages
        (prefix-cache references survive) and frees the slot at once.
        Returns False for unknown/finished uids."""
        for r in self.queue:
            if r.uid == uid:
                self.queue.remove(r)
                r.done = True
                r.finish_reason = "aborted"
                r.finish_ts = time.monotonic()
                self.completed[uid] = r
                return True
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._prefill_live.pop(i, None)
                self._finish(i, "aborted")
                return True
        return False

    def submit(self, req: Request):
        if req.params is None:
            req.params = SamplingParams(max_new_tokens=req.max_new)
        else:
            req.max_new = req.params.max_new_tokens
        if req.submit_ts is None:
            req.submit_ts = time.monotonic()
        req.order = self._submit_seq
        self._submit_seq += 1
        n = len(req.prompt)
        cap = self.max_context - 1
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if n > cap:
            raise ValueError(
                f"request {req.uid}: prompt of {n} tokens exceeds the slot "
                f"capacity of {cap} (max_context={self.max_context} minus "
                "1 decode token); truncate the prompt or enlarge "
                "max_context")
        if self.shared and self.alloc is not None:
            need = self._pages_needed(req)
            if need > self.alloc.total:
                raise ValueError(
                    f"request {req.uid}: worst-case footprint of {need} "
                    f"pages exceeds the shared pool of {self.alloc.total} "
                    "pages; shrink the prompt/max_new or grow "
                    "EngineConfig.total_pages")
        self.queue.append(req)

    @staticmethod
    def _admission_key(r: Request):
        return (r.priority,
                r.deadline_ts if r.deadline_ts is not None else float("inf"),
                r.order)

    def _queue_pick(self) -> Optional[Request]:
        """Sweep queued requests whose deadline passed (they finish as
        "deadline"), then return the best admission candidate."""
        now = time.monotonic()
        for r in [r for r in self.queue
                  if r.deadline_ts is not None and now >= r.deadline_ts]:
            self.queue.remove(r)
            r.done = True
            r.finish_reason = "deadline"
            r.finish_ts = now
            self.completed[r.uid] = r
            self.stats["deadline_drops"] += 1
        if not self.queue:
            return None
        return min(self.queue, key=self._admission_key)

    def _admit(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self._queue_pick()
                if req is None:
                    break
                if self.shared:
                    if not self._admit_shared(i, req):
                        break          # best candidate waits for pages
                    continue
                self.queue.remove(req)
                self.slots[i] = req
                self._set_slot_params(i, req)
                self._start_prefill(i, req)
                self.stats["admits"] += 1

    def _start_prefill(self, i: int, req: Request, pos: int = 0):
        n = len(req.prompt)
        if self._whole_prompt:
            toks = np.asarray(req.prompt, np.int64)
        else:
            C = self.chunk_tokens
            toks = np.zeros(-(-n // C) * C, np.int64)
            toks[:n] = req.prompt
        self._prefill_live[i] = _PrefillState(req, toks, n, pos=pos,
                                              order=self._admit_seq)
        self._admit_seq += 1

    def _admit_shared(self, i: int, req: Request) -> bool:
        """Admission by KV footprint: reserve the request's worst-case
        pages against the pool; map any cached prefix read-only; admit
        only if the remainder fits free + evictable pages."""
        n = len(req.prompt)
        T = self.engine.eng.page_tokens
        need = self._pages_needed(req) if self.alloc is not None else 0
        # a window ring is allocated whole at admission: the pages its
        # positions can reach, at most NPw (bounded, recycled in place)
        need_w = 0
        if self.alloc_w is not None:
            need_w = min(self._pages_needed(req), self._NPw)
        hit = CacheHit()
        if self.prefix_cache is not None:
            hit = self.prefix_cache.lookup(req.prompt)
        if self.alloc is not None:
            hit_pages = (hit.exact.pages if hit.exact is not None
                         else hit.full_pages)
            evictable = (self.prefix_cache.evictable_pages()
                         if self.prefix_cache is not None else 0)
            # mapping the hit PINS its pages: whatever part of the
            # evictable pages they are stops being reclaimable once this
            # request is admitted, so discount them all (conservative)
            avail = (self.alloc.free_count
                     + max(0, evictable - len(hit_pages))
                     - self._outstanding)
            # fresh pages this slot may still allocate: decode growth,
            # plus the copy of an exact hit's shared partial page
            resv_needed = need - (n // T if hit.exact is not None
                                  else len(hit.full_pages))
            if resv_needed > avail:
                return False
        if self.alloc_w is not None and need_w > self.alloc_w.free_count:
            return False

        self.queue.remove(req)
        self.slots[i] = req
        self._set_slot_params(i, req)
        self.stats["admits"] += 1
        self.stats["prompt_pages"] += -(-n // T)
        if self.alloc_w is not None:
            for j in range(need_w):
                p = self.alloc_w.alloc_for_logical(j)
                self._slot_ring[i].append(p)
                self._table_w_np[i, j] = p
            self._tables_dirty = self._tables_dirty or need_w > 0
        if hit.exact is not None:
            # whole-prompt repeat: map EVERY page (the trailing partial
            # one too) read-only and skip prefill; the first decode
            # append into the partial page copies it on write
            mapped = self._map_cached_pages(i, hit.exact.pages)
            self._resv[i] = need - (n // T)
            self._lengths[i] = n
            self.cache.lengths[i] = n
        else:
            mapped = self._map_cached_pages(i, hit.full_pages)
            self._resv[i] = need - mapped   # full pages never rewritten
            self._start_prefill(i, req, pos=mapped * T)
        self._outstanding += int(self._resv[i])
        self.stats["prefix_hit_pages"] += mapped
        self._tables_dirty = self._tables_dirty or mapped > 0
        self._push_tables()
        if hit.exact is not None:
            # first token from the cached float32 last-token logits,
            # through the request's own params and stream (the accounting
            # above is final, so a stop/length finish frees cleanly)
            logits = torch.as_tensor(hit.exact.logits,
                                     device=self.device)[None]
            toks, lps = self._sample(logits, [i], [len(req.output)])
            self._emit_token(i, req, int(toks[0]), float(lps[0]))
        return True

    def _prefill_tick(self, i: int, ps: _PrefillState):
        """Process ONE chunk of slot i's prompt into the cache."""
        if self._whole_prompt:
            chunk, c0, cl = ps.tokens, 0, ps.n
        else:
            c0 = ps.pos
            chunk = ps.tokens[c0:c0 + self.chunk_tokens]
            cl = min(self.chunk_tokens, ps.n - c0)
        if self.shared and self.alloc is not None:
            # lazy page allocation: back every page this chunk will write
            T = self.engine.eng.page_tokens
            for lp in range(c0 // T, -(-(c0 + cl) // T)):
                self._ensure_page(i, lp)
            self._push_tables()
        logits, self.cache = self.engine.prefill_chunk(
            self.params, self.cache,
            {"tokens": torch.as_tensor(chunk, device=self.device)[None]},
            i, c0, cl, first=(c0 == 0))
        ps.pos = c0 + len(chunk)
        self.stats["prefill_chunks"] += 1
        if ps.pos >= ps.n:                         # prompt fully prefilled
            del self._prefill_live[i]
            self._lengths[i] = ps.n
            if self.prefix_cache is not None:
                self._register_prefix(
                    i, ps, logits[0].float().cpu().numpy())
            toks, lps = self._sample(logits, [i], [len(ps.req.output)])
            self._emit_token(i, ps.req, int(toks[0]), float(lps[0]))

    def step(self) -> int:
        """One interleaved step: admissions, budgeted prefill chunks,
        then one decode step over every decoding slot.  Returns the
        number of prefill chunks plus tokens decoded."""
        self._admit()
        decoding = [i for i, r in enumerate(self.slots)
                    if r is not None and i not in self._prefill_live]
        # a verify step computes spec_k + 1 query tokens a decoding slot:
        # charge the budget that, so chunk packing does not overshoot
        per_slot = self.spec_k + 1
        budget = self.step_token_budget - len(decoding) * per_slot
        chunks_done = 0
        for i, ps in sorted(self._prefill_live.items(),
                            key=lambda kv: kv[1].order):
            cost = ps.n if self._whole_prompt else self.chunk_tokens
            # always fund at least one chunk; extra chunks within budget
            if chunks_done and budget < cost:
                break
            self._prefill_tick(i, ps)
            budget -= cost
            chunks_done += 1
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and i not in self._prefill_live]
        self.stats["steps"] += 1
        return chunks_done + self._decode_batch(active)

    def _decode_batch(self, active: List[int]) -> int:
        """One synchronous decode step over `active` slots: a verify step
        under speculation (unless no slot may draft), else a sequential
        one."""
        if not active:
            return 0
        if self.spec_k > 0:
            spec = self._spec_dispatch(active)
            if spec is not None:
                return self._spec_collect(active, *spec)
        return self._collect_decode(active, *self._dispatch_sequential(active))

    def _dispatch_sequential(self, active: List[int]):
        """Run one masked decode over `active` slots and sample each
        row through its own params and stream; returns device (toks,
        lps) for `_collect_decode`."""
        tokens = np.zeros((self.B, 1), np.int64)
        mask = np.zeros(self.B, bool)
        for i in active:
            tokens[i, 0] = self.slots[i].output[-1]
            mask[i] = True
        if self.shared and self.alloc is not None:
            # every active slot appends at its current position: make that
            # page exclusively writable (lazy allocation, or a copy off a
            # shared prefix/partial page) before the step runs
            T = self.engine.eng.page_tokens
            for i in active:
                self._ensure_page(i, int(self._lengths[i]) // T)
            self._push_tables()
        logits, self.cache = self.engine.decode_step(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            active=torch.as_tensor(mask, device=self.device))
        self.stats["decode_steps"] += 1
        self._lengths[active] += 1
        return self._sample(logits[active], active,
                            [len(self.slots[i].output) for i in active])

    def _collect_decode(self, active: List[int], toks, lps) -> int:
        """Emit one decode step's tokens through the finish rules."""
        for j, i in enumerate(active):
            req = self.slots[i]
            self._emit_token(i, req, int(toks[j]), float(lps[j]))
            self.stats["decode_tokens"] += 1
            if self.slots[i] is req and self._lengths[i] + 1 >= \
                    self.max_context:
                self._finish(i, "capacity")
        return len(active)

    # -- speculative draft-and-verify ----------------------------------
    def _spec_rollback(self, i: int):
        """Host half of the rollback (the reference's `_rollback_pages`):
        logical pages backed for the span but not reached by a kept token
        go back to the allocator and the slot's reservation is restored,
        as if they had never been handed out.  Their stale table entries
        sit past `lengths` and are never read as data."""
        if not self.shared or self.alloc is None:
            return
        last = (int(self._lengths[i]) - 1) // self.engine.eng.page_tokens
        for lp in [p for p in self._slot_pages[i] if p > last]:
            self.alloc.free([self._slot_pages[i].pop(lp)])
            self._slot_shared[i].discard(lp)
            self._resv[i] += 1
            self._outstanding += 1

    def _spec_dispatch(self, active: List[int]):
        """Draft and verify one step over `active` slots (the reference's
        `_dispatch_verify`): each slot drafts up to `spec_k` tokens by
        prompt lookup, capped so that its span never writes past what
        sequential decode would (its max_new budget less the correction
        token, and its slot capacity).  Returns host (toks [B, S], lps,
        acc [B], allowed [B]), or None when no slot may draft (the caller
        then runs a sequential step)."""
        S = self.spec_k + 1
        T = self.engine.eng.page_tokens
        tokens = np.zeros((self.B, S), np.int64)
        mask = np.zeros(self.B, bool)
        allowed = np.zeros(self.B, np.int64)
        positions = np.zeros(self.B, np.int64)
        for i in active:
            req = self.slots[i]
            cap = req.params.speculation
            k_eff = self.spec_k if cap is None else min(cap, self.spec_k)
            allowed[i] = max(0, min(
                k_eff, req.max_new - len(req.output) - 1,
                self.max_context - 2 - int(self._lengths[i])))
            draft = (propose_draft(req.prompt + req.output, self.spec_k)
                     if allowed[i] > 0 else [0] * self.spec_k)
            tokens[i, 0] = req.output[-1]
            tokens[i, 1:] = draft
            mask[i] = True
            positions[i] = len(req.output)
        if not allowed.any():
            return None
        if self.shared and self.alloc is not None:
            # back every page the span MAY write (positions up to lengths
            # + allowed), by lazy allocation or copy-on-write
            for i in active:
                lo = int(self._lengths[i]) // T
                hi = (int(self._lengths[i]) + int(allowed[i])) // T
                for lp in range(lo, hi + 1):
                    self._ensure_page(i, lp)
            self._push_tables()
        dev = self.device
        toks_d = torch.as_tensor(tokens, device=dev)

        def accept(logits):
            out = speculative_accept(
                logits, toks_d[:, 1:], self._seeds, positions,
                torch.as_tensor(allowed, device=dev),
                true_vocab=self.cfg.vocab_size, temperature=self._temps,
                top_k=self._topk, top_p=self._topp)
            return out[2], out

        (toks, lps, acc), self.cache = self.engine.verify_step(
            self.params, self.cache, toks_d, accept=accept,
            active=torch.as_tensor(mask, device=dev))
        self.stats["verify_steps"] += 1
        return (toks.cpu().numpy(), lps.cpu().numpy(), acc.cpu().numpy(),
                allowed)

    def _spec_collect(self, active: List[int], toks, lps, acc,
                      allowed) -> int:
        """Emit one verify step (the reference's `_collect_verify`): each
        slot emits its accepted drafts and the correction / bonus token
        through `_emit_token`, then advances by what the device appended
        and rolls back the pages its span did not reach."""
        emitted = 0
        for i in active:
            req = self.slots[i]
            n = int(acc[i]) + 1               # tokens the device appended
            # spec counters count row-steps that offered a draft
            if allowed[i] > 0:
                req.spec_steps += 1
                req.spec_drafted += int(allowed[i])
                self.stats["spec_steps"] += 1
                self.stats["spec_drafted"] += int(allowed[i])
            emitted_i = 0
            for j in range(n):
                if self.slots[i] is not req:
                    break                     # stop token finished mid-span
                self._emit_token(i, req, int(toks[i, j]), float(lps[i, j]))
                emitted_i += 1
            emitted += emitted_i
            # only EMITTED accepted drafts count (a stop finish truncates)
            if allowed[i] > 0:
                req.spec_accepted += emitted_i - 1
                self.stats["spec_accepted"] += emitted_i - 1
            if self.slots[i] is req:
                self._lengths[i] += n
                self._spec_rollback(i)
                if self._lengths[i] + 1 >= self.max_context:
                    self._finish(i, "capacity")
        self.stats["decode_tokens"] += emitted
        return emitted

    def run_to_completion(self, max_steps: int = 10_000):
        steps = 0
        while self.queue or any(r is not None for r in self.slots):
            if steps >= max_steps:
                stuck = sorted([r.uid for r in self.queue]
                               + [r.uid for r in self.slots if r is not None])
                raise RuntimeError(
                    f"run_to_completion: max_steps={max_steps} exhausted "
                    f"with requests still pending (uids {stuck})")
            self.step()
            steps += 1
        return self.completed


class SpliceBatcher(ContinuousBatcher):
    """Admit-time full prefill + slot splice — the pre-interleave
    baseline, kept as the measured reference beside the interleaved
    scheduler.  Every admit stalls the whole decode batch for the full
    prompt and writes its KV pages twice (one-row cache, then splice).

    The reference's `stats["compiles"]` counts jit signatures; eager torch
    compiles nothing, so it is left out."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.shared:
            raise ValueError(
                "SpliceBatcher is the stripe-layout baseline: a shared "
                "pool has no per-slot stripe to splice into (a B=1 "
                "prefill cache owns a different pool entirely); use "
                "ContinuousBatcher with shared_pool=True, or the stripe "
                "layout for splice-baseline measurements")

    def _admit(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                self._set_slot_params(i, req)
                # decoders idle for the whole admit: in chunk units, the
                # interleaved scheduler would have run this many decode
                # steps over the currently active slots
                n_dec = sum(1 for j, r in enumerate(self.slots)
                            if r is not None and j != i)
                span = len(self._padded(req))
                self.stats["decode_stall_tokens"] += n_dec * (
                    -(-span // self.chunk_tokens))
                self.stats["admits"] += 1
                self._splice_prefill(i, req)

    def _padded(self, req: Request) -> List[int]:
        n = len(req.prompt)
        if not self.bucket_prompts:
            return req.prompt
        Sb = bucket_length(n, hi=self.max_context - 1)
        return req.prompt + [0] * (Sb - n)

    def _splice_prefill(self, i: int, req: Request):
        """Prefill one sequence and splice its pools and length into slot
        i (the reference's `_prefill_slot`, named apart as the engine's
        helpers are: the static analyzer resolves methods by name)."""
        n = len(req.prompt)
        prompt = torch.as_tensor(self._padded(req), dtype=torch.long,
                                 device=self.device)[None]
        logits, one = self.engine.prefill(
            self.params, {"tokens": prompt}, self.max_context,
            prompt_len=n if self.bucket_prompts else None)
        paged_kv.splice_slot(self.cache, one, i)
        self._lengths[i] = n
        toks, lps = self._sample(logits, [i], [len(req.output)])
        self._emit_token(i, req, int(toks[0]), float(lps[0]))

    def step(self) -> int:
        """One decode step over all active slots (admits prefill eagerly
        inside `_admit`, stalling the batch)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        decoded = self._decode_batch(active)
        self.stats["steps"] += 1
        return decoded
