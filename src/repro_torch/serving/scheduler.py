"""Continuous batching over the KVNAND engine (port of
`repro.serving.scheduler`: `ContinuousBatcher` and the `SpliceBatcher`
baseline).

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

Tiered mode (``EngineConfig.hot_pages``, the paper's DRAM-free story)
splits that pool into a device-resident HOT tier of `hot_pages` slots
(standing for the NPU's staging SRAM) and a CAPACITY tier (standing for
the flash): the allocator keeps stable flash page ids over `total_pages`,
a `HotTier` maps the resident ones to hot slots (the values the page
tables carry, so B2 walks the hot tier), a demoted page's bytes park in
pinned host tensors (`_store`), and a queue-ahead prefetch promotes the
next admission's prefix-hit pages at the end of each step, so admissions
pin warm pages instead of demand-faulting (faults are counted as
`tier_stall_tokens`).  Pages mapped by a live slot are pinned hot and
never demoted, so no step's walk can fault.  Window rings are not
tiered (refused, as in the reference).

An RWKV6 (`ssm`) or hybrid (hymba) model carries recurrent state, which
padding would pollute, and a meta-token prefix would break the page
alignment of later chunks: such a prompt is prefilled as ONE
exact-length chunk (whatever `prefill_chunk_tokens` says; the budget
charges its full length), and the splice baseline prefills it
unbucketed.  An RWKV6 shared-pool config builds no allocator and no
prefix cache (there is no page pool); a hybrid one allocates its pages
and rings but keeps the prefix cache off.  A slot's length, its page
reservation and the prompt cap count hymba's meta tokens
(`_prefix`), as in the reference.

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

Replicas (`serving/replica.py`, `serving/router.py`): a request with
`Request.hold` set prefills as any other but joins no decode dispatch
(sequential, overlapped or verify), so a held row is never active to the
shared-pool writers; its KV state leaves as an envelope once its prefill
handoff token is out, and its source slot retires with finish reason
"migrated".  `_pool_leaves` names the pool leaves a page's bytes live in.

Pipelined stepping: `step()` is `dispatch()` then `collect()`.
`dispatch()` does every piece of host bookkeeping a step needs
(admission, prefill chunks, page ensures, table pushes, tier promotions)
and then enqueues the decode (or verify) step, sampling included, on the
card's stream; its tokens and logprobs stay on the device, and one
non-blocking device-to-host copy of both is started (`_HostFetch`).
`collect()` waits for the OLDEST in-flight step's copy, emits its tokens
(first-token and finish times are taken here), sweeps finishes and runs
the tier's prefetch.  An overlapped driver (`KVNANDServer.stream()` with
``ServerConfig.overlap``, `serving/async_server.py`) calls dispatch(N+1)
before collect(N): a row whose previous token is still in flight takes it
from the in-flight step's device tokens by an on-device merge, so the
dispatch never waits.  Host uploads go through pinned snapshots
(`paged_kv.host_to_device`) for the same reason.  A stop-token finish is
not known at dispatch, so an overlapped step may carry PHANTOM rows for
requests that finished at the collect before it; collect discards them
by request identity (`_Inflight.reqs`).  Their appends land in pages the
finished slot still owned when the step was enqueued, and every later
write of those pages (a new occupant's fill, a hot slot's staging) is
enqueued after it on the one stream, so it cannot survive.  Length and
capacity finishes are known at dispatch, and such rows are left out.
Verify steps draft from host-visible history, so `dispatch()` drains the
pipeline first: speculation runs unoverlapped.

`SpliceBatcher` is the reference's measured baseline: each admit
prefills the whole (bucketed) prompt in one shot (`engine.prefill`, a
ring filled from the true length) and splices the one-row cache into its
slot; its `step()` stays synchronous, and overlapped drivers run it
through the same `dispatch()` / `collect()`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import paged_kv
from repro_torch.core.engine import KVNANDEngine
from repro_torch.core.page_alloc import (CacheHit, HotTier, OutOfHotSlots,
                                         OutOfPages, PageAllocator,
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
    # stop|length|capacity|aborted|deadline|migrated
    finish_reason: Optional[str] = None
    # disaggregated prefill (serving/replica.py): a held slot prefills as
    # any other but is left out of every decode dispatch, so its KV state
    # migrates to a decode replica with exactly the prefill handoff token
    # emitted, and the decode replica resumes its stream at position 1
    hold: bool = False
    priority: int = 0
    deadline_ts: Optional[float] = None
    order: int = 0
    submit_ts: Optional[float] = None
    first_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    spec_steps: int = 0       # verify steps this request offered drafts in
    spec_drafted: int = 0     # draft tokens offered for verification
    spec_accepted: int = 0    # draft tokens accepted (and emitted)
    tier_hits: int = 0        # cached pages mapped while hot-resident
    tier_stalls: int = 0      # cached pages demand-promoted from capacity


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


class _HostFetch:
    """A step's outputs on their way to the host in ONE transfer: the
    tensors are packed into one float64 vector (token ids and float32
    logprobs are exact there) and, on a card, copied into pinned memory
    without blocking, with an event behind the copy.  `wait()` returns
    them as numpy arrays of their own shapes."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self._shapes = [tuple(t.shape) for t in parts]
        flat = torch.cat([t.reshape(-1).double() for t in parts])
        self._event = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._host = host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = flat

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        flat = self._host.numpy()
        out, k = [], 0
        for shape in self._shapes:
            n = int(np.prod(shape))
            out.append(flat[k:k + n].reshape(shape))
            k += n
        return out


@dataclasses.dataclass
class _Inflight:
    """One dispatched, not yet collected decode or verify step: its device
    tokens (an overlapped dispatch chains on them), the transfer of its
    outputs, and the host snapshot `collect()` emits from — the slots'
    requests at dispatch time (a slot whose occupant changed since is a
    PHANTOM row) and the slots whose capacity finish was known then."""
    kind: str                       # "decode" | "verify"
    active: List[int]
    reqs: Dict[int, Request]
    toks: torch.Tensor              # [B] (decode) on the device
    fetch: _HostFetch               # (toks, lps) or (toks, lps, acc)
    allowed: Optional[np.ndarray] = None     # verify: per-row draft cap
    cap_finish: Set[int] = dataclasses.field(default_factory=set)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_context: int = 512, eng: Optional[EngineConfig] = None,
                 rt: Optional[Runtime] = None, seed: int = 0,
                 bucket_prompts: bool = True,
                 prefill_chunk_tokens: int = 64,
                 step_token_budget: Optional[int] = None,
                 speculation_k: int = 0, tier_prefetch: bool = True,
                 device="cuda"):
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
        self.bucket_prompts = (bucket_prompts
                               and cfg.family not in ("ssm", "hybrid"))
        # ... and, chunked, prefills the whole prompt as one exact chunk,
        # as it does a meta-token prefix (it breaks later chunks' page
        # alignment)
        self._whole_prompt = (cfg.family in ("ssm", "hybrid")
                              or cfg.n_meta_tokens > 0)
        self._prefix = cfg.n_meta_tokens
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
        # dispatched, uncollected steps: none between synchronous steps,
        # briefly two in the overlapped schedule
        self._inflight: Deque[_Inflight] = deque()
        # host-observed device idleness: opened when a collect leaves no
        # step in flight, closed (and added up) at the next step enqueue
        self._idle_since: Optional[float] = None
        # per-slot sampling params (host arrays, uploaded each step)
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
                      "spec_accepted": 0,
                      "tier_hot_slots": 0, "tier_hit_pages": 0,
                      "tier_miss_pages": 0, "tier_stall_tokens": 0,
                      "tier_promotes": 0, "tier_demotes": 0,
                      "tier_prefetch_pages": 0, "tier_peak_hot": 0,
                      "phantom_tokens": 0, "device_idle_s": 0.0}
        self.shared = eng.shared_pool
        self.alloc: Optional[PageAllocator] = None
        self.alloc_w: Optional[PageAllocator] = None     # window rings
        self.prefix_cache: Optional[PrefixCache] = None
        self.tier: Optional[HotTier] = None
        self.tier_prefetch = tier_prefetch
        if self.shared:
            self._start_shared_pool()

    # -- shared-pool bookkeeping (allocator, tables, prefix cache) -----
    def _start_shared_pool(self):
        """The reference's `_init_shared_pool`: an allocator over the
        global pool's pages (a tiered pool's over its FLASH pages, with
        the hot tier and the capacity store beside it) and one over the
        window rings' pages, zeroed host tables, per-slot maps, and the
        prefix cache — for a global-pool-only arch with no meta-token
        prefix and no recurrent state, which is what prefix sharing needs
        (a ring recycles its pages in place, so a window arch shares
        none; meta tokens shift the page alignment; a hybrid's SSM state
        is not in the pages).  An RWKV6 cache has no pool: no allocator,
        no tables, no prefix cache."""
        c = self.cache
        eng = self.engine.eng
        self._table_np = None
        self._table_w_np = None
        if c.k_pages_g is not None:
            self._NPg = c.page_table_g.shape[1]
            H = c.k_pages_g.shape[2]            # device-resident pages
            if eng.hot_pages > 0:
                # the allocator spans the flash page space (stable ids);
                # only H of those pages are on the device at a time
                total_flash = eng.total_pages or self.B * self._NPg
                if H > total_flash:
                    raise ValueError(
                        f"hot_pages={eng.hot_pages} (rounded to {H}) "
                        f"exceeds the flash pool of {total_flash} pages; "
                        "shrink hot_pages or grow total_pages")
                if c.k_pages_w is not None:
                    raise ValueError(
                        f"{self.cfg.name}: tiered pools cover the GLOBAL "
                        "layer group only — window rings recycle their "
                        "pages in place and never cool down; run "
                        "local-attention archs with hot_pages=0")
                self.alloc = PageAllocator(total_flash)
                self.tier = HotTier(H, total_flash)
                # capacity tier: a demoted page's bytes, flash id ->
                # {pool leaf: pinned host tensor}
                self._store: Dict[int, Dict[str, torch.Tensor]] = {}
                self.alloc.add_release_hook(self._tier_release)
                self._hot_resv = np.zeros(self.B, np.int64)
                self._hot_out = 0       # sum of the slots' hot footprints
                self.stats["tier_hot_slots"] = H
            else:
                self.alloc = PageAllocator(H)
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
        if (self.alloc is not None and self.alloc_w is None
                and not self._whole_prompt
                and not self.cfg.is_encoder_decoder):
            self.prefix_cache = PrefixCache(self.alloc,
                                            self.engine.eng.page_tokens)
        self._tables_dirty = True
        # the global pool's leaves a page's bytes live in (K/V codes and
        # kv8/kv4 scales): what staging, demotion and migration move
        self._pool_leaves = [n for n in paged_kv.POOL_LEAVES_G
                             if getattr(c, n) is not None]
        self._push_tables()

    # -- tiered pool ----------------------------------------------------
    def _tier_release(self, page: int):
        """Allocator release hook: flash page `page` reached refcount 0 on
        ANY free path (slot teardown, cache eviction, speculative
        rollback) — retire its hot slot and its capacity-store bytes."""
        self.tier.release(int(page))
        self._store.pop(int(page), None)

    def _bind_slot(self, page: int, avoid: frozenset = frozenset()) -> int:
        """Acquire a hot slot for flash page `page`, demoting the LRU
        unpinned resident to the capacity store when the tier is full
        (its bytes are read out before anything writes the slot)."""
        slot, victim = self.tier.bind(page, avoid=avoid)
        if victim is not None:
            self._store[victim] = paged_kv.read_hot_slot(self.cache, slot)
            self.stats["tier_demotes"] += 1
        self.stats["tier_peak_hot"] = max(self.stats["tier_peak_hot"],
                                          self.tier.resident_count)
        return slot

    def _promote(self, page: int, avoid: frozenset = frozenset()) -> int:
        """Stage a capacity-tier page's bytes into a hot slot.  Every live
        non-resident page has bytes in the store (pages leave residency
        only by demotion); fresh allocations bind without a copy and never
        come through here."""
        slot = self._bind_slot(page, avoid=avoid)
        paged_kv.stage_hot_slot(self.cache, slot,
                                self._store.pop(int(page)))
        self.stats["tier_promotes"] += 1
        return slot

    def _tier_prefetch_tick(self):
        """Queue-ahead prefetch: at the END of a step, promote the
        capacity-tier pages the next admission's prefix hit will map, so
        the admission pins resident pages instead of demand-faulting.  The
        copies queue behind the in-flight step; only demand promotions
        count as stall tokens.  Uses the side-effect-free cache lookup,
        binds around the working set being staged, and backs off when
        every remaining slot is pinned."""
        if (self.tier is None or not self.tier_prefetch or not self.queue
                or self.prefix_cache is None):
            return
        # the next ADMISSION candidate (priority / deadline order)
        head = min(self.queue, key=self._admission_key)
        hit = self.prefix_cache.lookup(head.prompt, record=False)
        pages = (hit.exact.pages if hit.exact is not None
                 else hit.full_pages)
        if not pages:
            return
        avoid = frozenset(int(p) for p in pages)
        for p in pages:
            if self.tier.is_resident(p):
                self.tier.touch(p)      # keep warm until admission pins
            else:
                try:
                    self._promote(p, avoid=avoid)
                except OutOfHotSlots:
                    break
                self.stats["tier_prefetch_pages"] += 1

    def _push_tables(self):
        """Mirror the host page tables into the device tables, only when a
        mapping changed (a non-blocking copy from a snapshot:
        `paged_kv.write_page_table`)."""
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
        unmapped, copy it on write if currently shared (refcount > 1).  A
        tiered pool also pins the page hot: a fresh page binds a slot with
        no byte traffic (its contents are written before the length covers
        them); a copy on write takes the shared bytes through the host, so
        the fresh binding may demote the old page itself when it was the
        last unpinned resident."""
        pages = self._slot_pages[i]
        if lp not in pages:
            p = self._alloc_g(lp)
            pages[lp] = p
            if self.tier is not None:
                self._table_np[i, lp] = self._bind_slot(p)
                self.tier.pin(p)
            else:
                self._table_np[i, lp] = p
            self._tables_dirty = True
            self._resv[i] -= 1
            self._outstanding -= 1
            return
        if lp in self._slot_shared[i]:
            old = pages[lp]
            fresh = self.alloc.cow(old)
            if fresh != old:
                if self.tier is not None:
                    # `old` is pinned (this slot maps it): read its bytes,
                    # drop this slot's pin, then bind and stage the copy —
                    # in that order, so the bind may demote `old` itself
                    # without losing the copy's source
                    src = self.tier.slot_of(old)
                    self._store[fresh] = paged_kv.read_hot_slot(self.cache,
                                                                src)
                    self.tier.unpin(old)
                    self._promote(fresh)
                    self.tier.pin(fresh)
                    self._table_np[i, lp] = self.tier.slot_of(fresh)
                else:
                    # one copy per pool leaf (kv8/kv4 scales too), on the
                    # stream the next decode step runs on, so the bytes
                    # land before its append
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
            if self.tier is not None:
                # unpin before the refcount drop: pages the prefix cache
                # still names stay resident (demotion candidates), dead
                # pages free their slot through the release hook
                for p in self._slot_pages[i].values():
                    self.tier.unpin(p)
            self.alloc.free(list(self._slot_pages[i].values()))
        if self.alloc_w is not None and self._slot_ring[i]:
            self.alloc_w.free(self._slot_ring[i])
        if self.tier is not None:
            self._hot_out -= int(self._hot_resv[i])
            self._hot_resv[i] = 0
        self._slot_pages[i] = {}
        self._slot_shared[i] = set()
        self._slot_ring[i] = []
        self._outstanding -= int(self._resv[i])
        self._resv[i] = 0

    def _pages_needed(self, req: Request) -> int:
        total = min(self._prefix + len(req.prompt) + req.max_new,
                    self.max_context)
        return -(-total // self.engine.eng.page_tokens)

    def _map_cached_pages(self, i: int, pages) -> int:
        """Map cached pages read-only into slot i's logical pages 0..len:
        one allocator reference each, marked shared (copy before write).

        A tiered pool pins each page hot first: a page the prefetcher (or
        recency) kept resident is a TIER HIT; a page demoted to the
        capacity store is promoted on the spot and counted as a stall
        token, the observable cost of the DRAM-free design."""
        req = self.slots[i]
        for j, p in enumerate(pages):
            self.alloc.share([p])
            self._slot_pages[i][j] = p
            self._slot_shared[i].add(j)
            if self.tier is not None:
                if self.tier.is_resident(p):
                    self.stats["tier_hit_pages"] += 1
                    req.tier_hits += 1
                else:
                    self._promote(p)
                    self.stats["tier_miss_pages"] += 1
                    self.stats["tier_stall_tokens"] += 1
                    req.tier_stalls += 1
                self.tier.pin(p)
                self._table_np[i, j] = self.tier.slot_of(p)
            else:
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
        if self.tier is not None:
            # hot-tier slack, not flash slack: the repeat that hits this
            # exact entry must re-pin every page hot AND fund the partial
            # page's copy with a hot slot, which a cold capacity tier's
            # free flash pages cannot give
            slack = min(slack, self.tier.free_slot_count
                        + self.tier.demotable_count)
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

    def _sample_dev(self, logits: torch.Tensor, rows, positions,
                    live: Optional[np.ndarray] = None):
        """Sample logits row j through slot rows[j]'s params and (seed,
        positions[j]) stream -> device (toks, lps).  Rows with `live`
        False are sampled greedily (their outputs are dropped).  The knobs
        go up through pinned snapshots, so this enqueues and returns."""
        dev = logits.device
        idx = np.asarray(rows)
        temps = self._temps[idx]
        if live is not None:
            temps = np.where(live, temps, np.float32(0.0))
        noise = None
        if (temps > 0).any():
            noise = request_noise(self._seeds[idx], positions,
                                  logits.shape[-1], dev)
        return sample_with_logprobs(
            logits, noise, true_vocab=self.cfg.vocab_size,
            temperature=paged_kv.host_to_device(temps, dev),
            top_k=paged_kv.host_to_device(self._topk[idx], dev),
            top_p=paged_kv.host_to_device(self._topp[idx], dev))

    def _sample_now(self, logits: torch.Tensor, i: int,
                    req: Request):
        """Sample ONE request's next token (the prefill handoff and the
        exact-hit first token) through the stream the batched decode uses
        -> host (token, logprob)."""
        toks, lps = _HostFetch(self._sample_dev(
            logits, [i], [len(req.output)])).wait()
        return int(toks[0]), float(lps[0])

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
        cap = self.max_context - 1 - self._prefix
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if n > cap:
            raise ValueError(
                f"request {req.uid}: prompt of {n} tokens exceeds the slot "
                f"capacity of {cap} (max_context={self.max_context} minus "
                f"1 decode token minus {self._prefix} prefix tokens); "
                "truncate the prompt or enlarge max_context")
        if self.shared and self.alloc is not None:
            need = self._pages_needed(req)
            if need > self.alloc.total:
                raise ValueError(
                    f"request {req.uid}: worst-case footprint of {need} "
                    f"pages exceeds the shared pool of {self.alloc.total} "
                    "pages; shrink the prompt/max_new or grow "
                    "EngineConfig.total_pages")
            if self.tier is not None and need > self.tier.hot_slots:
                raise ValueError(
                    f"request {req.uid}: worst-case footprint of {need} "
                    f"pages exceeds the hot tier of "
                    f"{self.tier.hot_slots} pages (mapped pages stay "
                    "pinned hot); shrink the prompt/max_new or grow "
                    "EngineConfig.hot_pages")
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
            # a tiered pool: the worst-case footprint must also fit the
            # hot tier net of every live slot's, since mapped pages stay
            # pinned for the slot's lifetime — so allocations and
            # promotions always find a free or demotable slot
            if self.tier is not None \
                    and self._hot_out + need > self.tier.hot_slots:
                return False
        if self.alloc_w is not None and need_w > self.alloc_w.free_count:
            return False

        self.queue.remove(req)
        self.slots[i] = req
        self._set_slot_params(i, req)
        self.stats["admits"] += 1
        self.stats["prompt_pages"] += -(-n // T)
        if self.tier is not None:
            self._hot_resv[i] = need
            self._hot_out += need
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
            self._lengths[i] = n            # no prefix: the cache is off
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
            logits = paged_kv.host_to_device(hit.exact.logits,
                                             self.device)[None]
            self._emit_token(i, req, *self._sample_now(logits, i, req))
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
            span = c0 + cl + (self._prefix if c0 == 0 else 0)
            for lp in range(c0 // T, -(-span // T)):
                self._ensure_page(i, lp)
            self._push_tables()
        logits, self.cache = self.engine.prefill_chunk(
            self.params, self.cache,
            {"tokens": paged_kv.host_to_device(chunk, self.device)[None]},
            i, c0, cl, first=(c0 == 0))
        ps.pos = c0 + len(chunk)
        self.stats["prefill_chunks"] += 1
        if ps.pos >= ps.n:                         # prompt fully prefilled
            del self._prefill_live[i]
            self._lengths[i] = self._prefix + ps.n
            if self.prefix_cache is not None:
                self._register_prefix(
                    i, ps, logits[0].float().cpu().numpy())
            self._emit_token(i, ps.req, *self._sample_now(logits, i,
                                                          ps.req))

    def step(self) -> int:
        """One interleaved step, the synchronous schedule: `dispatch()`
        then `collect()` back to back.  Returns the number of prefill
        chunks plus tokens emitted."""
        chunks = self.dispatch()
        return chunks + self.collect()

    def _mark_device_busy(self):
        """Close the host-observed device-idle window at the first step
        enqueue after a collect that emptied the pipeline."""
        if self._idle_since is not None:
            self.stats["device_idle_s"] += time.monotonic() - self._idle_since
            self._idle_since = None

    def _will_finish(self, i: int, pend: int) -> bool:
        """True when slot i's request is CERTAIN to finish once the
        pipeline drains: `pend` uncollected tokens ahead of it reach its
        max_new, or an in-flight step foresaw its capacity finish.  Such
        slots are left out of the next dispatch instead of becoming
        phantom rows (a stop-token finish cannot be foreseen)."""
        req = self.slots[i]
        if len(req.output) + pend >= req.max_new:
            return True
        return any(i in inf.cap_finish and inf.reqs.get(i) is req
                   for inf in self._inflight)

    def dispatch(self) -> int:
        """Host half of one scheduler step: admissions, prefill chunks
        (budgeted — the decode batch is funded first), page ensures and
        table pushes, then the decode (or verify) step's ENQUEUE.  Its
        tokens and logprobs stay on the device until `collect()`.
        Returns the number of prefill chunks processed."""
        if self._inflight and (self.spec_k > 0 or len(self._inflight) >= 2):
            # verify steps draft from host-visible history, and the
            # pipeline is one step deep: drain before dispatching again
            self.collect()
        self._admit()
        n_decoding = sum(1 for i, r in enumerate(self.slots)
                         if r is not None and i not in self._prefill_live
                         and not r.hold)
        # a verify step computes spec_k + 1 query tokens a decoding slot:
        # charge the budget that, so chunk packing does not overshoot
        per_slot = self.spec_k + 1
        budget = self.step_token_budget - n_decoding * per_slot
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
        pending = {i for inf in self._inflight for i in inf.active
                   if self.slots[i] is inf.reqs[i]}
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and i not in self._prefill_live
                  and not r.hold
                  and not self._will_finish(i, int(i in pending))]
        if active:
            if self.spec_k > 0:
                self._dispatch_verify(active)
            else:
                self._dispatch_sequential(active)
        self.stats["steps"] += 1
        return chunks_done

    def collect(self) -> int:
        """Host half of a step's completion: wait for the OLDEST in-flight
        step's outputs (its one transfer), emit its tokens through the
        finish rules — first-token and finish times are taken here, when
        the tokens are on the host — then run the tier's queue-ahead
        prefetch.  Returns the tokens emitted; with nothing in flight only
        the prefetch runs."""
        emitted = 0
        if self._inflight:
            inf = self._inflight.popleft()
            emitted = (self._collect_verify(inf) if inf.kind == "verify"
                       else self._collect_decode(inf))
        self._tier_prefetch_tick()
        if not self._inflight:
            self._idle_since = time.monotonic()
        return emitted

    @property
    def pending_steps(self) -> int:
        """Dispatched, uncollected steps (0 outside the overlapped
        schedule)."""
        return len(self._inflight)

    def _decode_batch(self, active: List[int]) -> int:
        """One SYNCHRONOUS decode (or verify) step over `active` slots,
        dispatch then collect (the splice scheduler's)."""
        if not active:
            return 0
        if self.spec_k > 0:
            self._dispatch_verify(active)
        else:
            self._dispatch_sequential(active)
        inf = self._inflight.popleft()
        return (self._collect_verify(inf) if inf.kind == "verify"
                else self._collect_decode(inf))

    def _dispatch_sequential(self, active: List[int]):
        """Enqueue one masked decode over `active` slots, sampling every
        row through its own params and stream on the device.  A row whose
        previous token is still in flight (the overlapped schedule
        dispatches step N+1 before collecting step N) takes it from that
        step's device tokens by an on-device merge, at stream position
        len(output) + 1; every other row's input is uploaded from
        `output[-1]`."""
        prev = self._inflight[-1] if self._inflight else None
        tokens = np.zeros((self.B, 1), np.int64)
        mask = np.zeros(self.B, bool)
        positions = np.zeros(self.B, np.int64)
        chain = np.zeros(self.B, bool)
        for i in active:
            req = self.slots[i]
            mask[i] = True
            if prev is not None and prev.reqs.get(i) is req:
                chain[i] = True
                positions[i] = len(req.output) + 1
            else:
                tokens[i, 0] = req.output[-1]
                positions[i] = len(req.output)
        if self.shared and self.alloc is not None:
            # every active slot appends at its current position: make that
            # page exclusively writable (lazy allocation, or a copy off a
            # shared prefix/partial page) before the step runs
            T = self.engine.eng.page_tokens
            for i in active:
                self._ensure_page(i, int(self._lengths[i]) // T)
            self._push_tables()
        self._mark_device_busy()
        dev = self.device
        tok_d = paged_kv.host_to_device(tokens, dev)
        if chain.any():
            tok_d = torch.where(
                paged_kv.host_to_device(chain, dev)[:, None],
                prev.toks[:, None], tok_d)
        logits, self.cache = self.engine.decode_step(
            self.params, self.cache, tok_d,
            active=paged_kv.host_to_device(mask, dev))
        self.stats["decode_steps"] += 1
        toks, lps = self._sample_dev(logits, range(self.B), positions,
                                     live=mask)
        self._lengths[active] += 1
        cap = {i for i in active
               if self._lengths[i] + 1 >= self.max_context}
        self._inflight.append(_Inflight(
            "decode", list(active), {i: self.slots[i] for i in active},
            toks, _HostFetch([toks, lps]), cap_finish=cap))

    def _collect_decode(self, inf: _Inflight) -> int:
        """Emit one collected decode step: its one transfer brings tokens
        and logprobs, then every surviving row goes through the finish
        rules."""
        toks, lps = inf.fetch.wait()
        emitted = 0
        for i in inf.active:
            req = inf.reqs[i]
            if self.slots[i] is not req:
                # PHANTOM row: its request finished (stop token, abort)
                # after this step was dispatched
                self.stats["phantom_tokens"] += 1
                continue
            self._emit_token(i, req, int(toks[i]), float(lps[i]))
            self.stats["decode_tokens"] += 1
            emitted += 1
            if self.slots[i] is req and i in inf.cap_finish:
                self._finish(i, "capacity")
        return emitted

    # -- speculative draft-and-verify ----------------------------------
    def _spec_rollback(self, i: int):
        """Host half of the rollback (the reference's `_rollback_pages`):
        logical pages backed for the span but not reached by a kept token
        go back to the allocator (a tiered pool unpins them first; the
        release hook frees their hot slot) and the slot's reservation is
        restored, as if they had never been handed out.  Their stale table
        entries sit past `lengths` and are never read as data."""
        if not self.shared or self.alloc is None:
            return
        last = (int(self._lengths[i]) - 1) // self.engine.eng.page_tokens
        for lp in [p for p in self._slot_pages[i] if p > last]:
            p = self._slot_pages[i].pop(lp)
            if self.tier is not None:
                self.tier.unpin(p)
            self.alloc.free([p])
            self._slot_shared[i].discard(lp)
            self._resv[i] += 1
            self._outstanding += 1

    def _dispatch_verify(self, active: List[int]):
        """Draft and enqueue one verify step over `active` slots (the
        reference's `_dispatch_verify`): each slot drafts up to `spec_k`
        tokens by prompt lookup, capped so that its span never writes past
        what sequential decode would (its max_new budget less the
        correction token, and its slot capacity).  Drafts come from the
        host-visible history, so the pipeline is drained.  When no slot
        may draft, a sequential step runs instead."""
        assert not self._inflight, "verify dispatch needs a drained pipeline"
        S = self.spec_k + 1
        T = self.engine.eng.page_tokens
        tokens = np.zeros((self.B, S), np.int64)
        mask = np.zeros(self.B, bool)
        allowed = np.zeros(self.B, np.int64)
        positions = np.zeros(self.B, np.int64)
        reqs: Dict[int, Request] = {}
        for i in active:
            req = self.slots[i]
            reqs[i] = req
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
            return self._dispatch_sequential(active)
        if self.shared and self.alloc is not None:
            # back every page the span MAY write (positions up to lengths
            # + allowed), by lazy allocation or copy-on-write
            for i in active:
                lo = int(self._lengths[i]) // T
                hi = (int(self._lengths[i]) + int(allowed[i])) // T
                for lp in range(lo, hi + 1):
                    self._ensure_page(i, lp)
            self._push_tables()
        self._mark_device_busy()
        dev = self.device
        toks_d = paged_kv.host_to_device(tokens, dev)

        def accept(logits):
            out = speculative_accept(
                logits, toks_d[:, 1:], self._seeds, positions,
                paged_kv.host_to_device(allowed, dev),
                true_vocab=self.cfg.vocab_size, temperature=self._temps,
                top_k=self._topk, top_p=self._topp)
            return out[2], out

        (toks, lps, acc), self.cache = self.engine.verify_step(
            self.params, self.cache, toks_d, accept=accept,
            active=paged_kv.host_to_device(mask, dev))
        self.stats["verify_steps"] += 1
        self._inflight.append(_Inflight(
            "verify", list(active), reqs, toks, _HostFetch([toks, lps, acc]),
            allowed=allowed))

    def _collect_verify(self, inf: _Inflight) -> int:
        """Emit one collected verify step (the reference's
        `_collect_verify`): each slot emits its accepted drafts and the
        correction / bonus token through `_emit_token`, then advances by
        what the device appended and rolls back the pages its span did
        not reach."""
        toks, lps, acc = inf.fetch.wait()
        allowed = inf.allowed
        emitted = 0
        for i in inf.active:
            req = inf.reqs[i]
            if self.slots[i] is not req:
                self.stats["phantom_tokens"] += 1
                continue
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
                self._emit_token(i, req, int(toks[i, j]),
                                 float(lps[i, j]))
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
        prompt = paged_kv.host_to_device(
            np.asarray(self._padded(req), np.int64), self.device)[None]
        logits, one = self.engine.prefill(
            self.params, {"tokens": prompt}, self.max_context,
            prompt_len=n if self.bucket_prompts else None)
        paged_kv.splice_slot(self.cache, one, i)
        self._lengths[i] = self._prefix + n
        self._emit_token(i, req, *self._sample_now(logits, i, req))

    def step(self) -> int:
        """One decode step over all active slots (admits prefill eagerly
        inside `_admit`, stalling the batch)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and not r.hold]
        decoded = self._decode_batch(active)
        self.stats["steps"] += 1
        return decoded
