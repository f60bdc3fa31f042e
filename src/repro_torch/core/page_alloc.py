"""Host-side free-page allocator + radix-style prefix cache (paper §IV-D;
a copy of `repro.core.page_alloc`, which the port never imports).

The paper describes page-level KV mapping as an FTL analogy: a
logical→physical page table with access-aware block allocation.  This
module is the FTL's host half for the SHARED page pool
(``EngineConfig.shared_pool``): pure-numpy bookkeeping that decides which
physical page of the pool backs each (slot, logical page) mapping.  The
device half (the tables the kernels consume, the page copies for COW)
lives in ``core/paged_kv.py``; the serving policy that drives both lives
in ``serving/scheduler.py``.

Invariants:

  * conservation — every physical page is either on the free list
    (refcount 0) or mapped with refcount ≥ 1; free + live == total;
  * single writer — a page with refcount > 1 is never written: writers
    must `cow()` first (the allocator hands out a fresh page and drops
    one reference from the shared page);
  * fork safety — `share()`-ing a table row only bumps refcounts, so a
    forked sequence's decode can never mutate pages it shares until it
    owns them exclusively.

Shard awareness: when the physical page axis is sharded over devices,
logical page j of a sequence should land on shard ``j % n_shards``.  The
allocator keeps one free list per shard and honours a preferred shard
per allocation, falling back to any shard only when the preferred one is
dry.

`HotTier` is the residency half of a TIERED pool (``EngineConfig
.hot_pages``): the allocator keeps stable flash page ids, the tier maps
the resident ones to the device's few hot slots (see its docstring).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    """The pool has no free page left (caller should evict / back off)."""


class PageAllocator:
    """Free-page allocator with refcounts over ``total`` physical pages.

    In a TIERED pool ``total`` counts FLASH pages — the stable ids every
    table/cache structure holds — while device residency is tracked
    separately by :class:`HotTier`.  Release hooks (``add_release_hook``)
    observe every page whose refcount reaches 0, whatever path freed it
    (slot teardown, prefix-cache eviction, speculative rollback).
    """

    def __init__(self, total: int, n_shards: int = 1):
        if total <= 0:
            raise ValueError(f"pool needs at least one page, got {total}")
        if n_shards <= 0 or total % n_shards:
            raise ValueError(
                f"total={total} pages must split evenly over "
                f"n_shards={n_shards}")
        self.total = total
        self.n_shards = n_shards
        self.pages_per_shard = total // n_shards
        self.refcount = np.zeros(total, np.int32)
        # LIFO free lists (hot pages get reused first — the access-aware
        # block-reclaim analogue); shard s owns [s*pps, (s+1)*pps)
        self._free: List[List[int]] = [
            list(range((s + 1) * self.pages_per_shard - 1,
                       s * self.pages_per_shard - 1, -1))
            for s in range(n_shards)]
        self._release_hooks: List = []

    def add_release_hook(self, fn) -> None:
        """Call ``fn(page)`` whenever a page's refcount reaches 0 (just
        before it rejoins the free list), on every free path: the tiered
        scheduler retires the page's hot slot and capacity-store bytes
        there."""
        self._release_hooks.append(fn)

    # ------------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def live_count(self) -> int:
        return self.total - self.free_count

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    # ------------------------------------------------------------------
    def alloc(self, prefer_shard: int = 0) -> int:
        """Pop one free page, preferring ``prefer_shard``'s list."""
        order = [prefer_shard % self.n_shards] + [
            s for s in range(self.n_shards)
            if s != prefer_shard % self.n_shards]
        for s in order:
            if self._free[s]:
                p = self._free[s].pop()
                assert self.refcount[p] == 0, (p, self.refcount[p])
                self.refcount[p] = 1
                return p
        raise OutOfPages(f"all {self.total} pages live")

    def alloc_for_logical(self, logical: int) -> int:
        """Allocate the backing page for logical page ``logical`` of some
        sequence — striped over shards like the old private layout."""
        return self.alloc(prefer_shard=logical % self.n_shards)

    def share(self, pages) -> None:
        """Add one reference to each page (prefix-cache map-in / fork)."""
        for p in np.atleast_1d(np.asarray(pages, np.int64)):
            if self.refcount[p] <= 0:
                raise ValueError(f"share of dead page {int(p)}")
            self.refcount[p] += 1

    def free(self, pages) -> int:
        """Drop one reference per page; pages reaching refcount 0 return
        to their shard's free list.  Returns the number actually freed."""
        n = 0
        for p in np.atleast_1d(np.asarray(pages, np.int64)):
            p = int(p)
            if self.refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                for hook in self._release_hooks:
                    hook(p)
                self._free[self.shard_of(p)].append(p)
                n += 1
        return n

    def cow(self, page: int, prefer_shard: Optional[int] = None) -> int:
        """Copy-on-write: give the caller exclusive ownership of ``page``.

        refcount == 1 -> the caller already owns it, returned unchanged.
        refcount > 1  -> allocate a fresh page (same shard by default so
        the stripe stays aligned), move one reference over, and return
        the fresh page.  The CALLER copies the device bytes.
        """
        if self.refcount[page] <= 0:
            raise ValueError(f"cow of dead page {int(page)}")
        if self.refcount[page] == 1:
            return int(page)
        fresh = self.alloc(self.shard_of(int(page))
                           if prefer_shard is None else prefer_shard)
        self.refcount[page] -= 1
        return fresh

    def is_shared(self, page: int) -> bool:
        return bool(self.refcount[page] > 1)

    def check(self) -> None:
        """Assert the conservation invariant (tests / debugging)."""
        free = sorted(p for f in self._free for p in f)
        assert len(free) == len(set(free)), "page on free list twice"
        assert all(self.refcount[p] == 0 for p in free)
        live = int((self.refcount > 0).sum())
        assert live + len(free) == self.total, (live, len(free), self.total)
        assert (self.refcount >= 0).all()



# ---------------------------------------------------------------------------
# Hot-tier residency (tiered flash KV hierarchy)
# ---------------------------------------------------------------------------

class OutOfHotSlots(OutOfPages):
    """Every hot slot is pinned or excluded (caller should back off)."""


class HotTier:
    """Residency manager for the DEVICE half of a tiered shared pool.

    A tiered pool keeps ``total_pages`` stable FLASH page ids in the
    :class:`PageAllocator` but only ``hot_slots`` physical slots on the
    device.  This class owns the flash-id → hot-slot map and the
    tier-bit encoding the per-slot page tables use:

      * ``entry(page)`` is the table word for a flash page — its hot
        slot index when resident, else ``HotTier.CAPACITY`` (the tier
        bit: a negative sentinel that must never reach a dispatched
        table, because the scheduler promotes before mapping);
      * ``pin``/``unpin`` count live-slot mappings.  A pinned resident
        is NEVER a demotion victim — this is the "a mapped hot page is
        never evicted" invariant: decode/chunked-prefill/verify walks
        touch only pages their own slot has pinned, so they can never
        fault mid-flight;
      * unpinned residents (prefix-cache-only pages, refcount ≥ 1 in
        the allocator but mapped by no slot) sit on an LRU and demote
        one at a time when ``bind`` needs a slot — the "refcounted
        shared prefix pages demote only at refcount 0 ... or under slot
        pressure, to the capacity store" side of the invariant;
      * ``release(page)`` (driven by the allocator's release hook)
        frees the slot when the flash page itself dies.

    Conservation (``check``):
    free slots + resident pages == hot_slots, always; the LRU holds
    exactly the unpinned residents; no two residents share a slot.

    The class moves no bytes — the scheduler stages page contents on
    ``bind``'s demotion victim / promotion target.
    """

    CAPACITY = -1               # table-word sentinel for a non-resident page

    def __init__(self, hot_slots: int, total_pages: int):
        if hot_slots <= 0:
            raise ValueError(f"hot tier needs at least one slot, "
                             f"got {hot_slots}")
        if hot_slots > total_pages:
            raise ValueError(f"hot_slots={hot_slots} exceeds "
                             f"total_pages={total_pages}")
        self.hot_slots = hot_slots
        self.total_pages = total_pages
        self._slot_of: Dict[int, int] = {}          # flash page -> hot slot
        self._pins = np.zeros(total_pages, np.int32)
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # unpinned res.
        self._free_slots: List[int] = list(range(hot_slots - 1, -1, -1))
        self.promotes = 0       # bind() calls for pages with stored bytes
        self.demotes = 0        # LRU victims pushed to the capacity store

    # ------------------------------------------------------------------
    @property
    def resident_count(self) -> int:
        return len(self._slot_of)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def demotable_count(self) -> int:
        """Unpinned residents — candidates for demotion."""
        return len(self._lru)

    @property
    def pinned_count(self) -> int:
        return len(self._slot_of) - len(self._lru)

    def is_resident(self, page: int) -> bool:
        return int(page) in self._slot_of

    def slot_of(self, page: int) -> int:
        """Hot slot backing ``page`` (raises KeyError if not resident)."""
        return self._slot_of[int(page)]

    def entry(self, page: int) -> int:
        """Page-table word: hot slot index, or ``CAPACITY`` (tier bit)."""
        return self._slot_of.get(int(page), self.CAPACITY)

    # ------------------------------------------------------------------
    def bind(self, page: int, avoid: frozenset = frozenset()
             ) -> Tuple[int, Optional[int]]:
        """Make ``page`` resident: returns ``(slot, victim)``.

        Takes a free slot when one exists, else demotes the
        least-recently-used UNPINNED resident not in ``avoid`` (the
        prefetcher excludes the working set it is staging so promotion
        N cannot demote promotion N-1).  ``victim`` is the demoted flash
        page (``None`` when a free slot served) — the CALLER must save
        its device bytes to the capacity store BEFORE overwriting the
        slot.  Raises :class:`OutOfHotSlots` when every slot is pinned
        or excluded; pinned residents are never victims.
        """
        page = int(page)
        if page in self._slot_of:
            raise ValueError(f"page {page} already resident")
        victim: Optional[int] = None
        if self._free_slots:
            slot = self._free_slots.pop()
        else:
            victim = next((p for p in self._lru if p not in avoid), None)
            if victim is None:
                raise OutOfHotSlots(
                    f"all {self.hot_slots} hot slots pinned or excluded")
            del self._lru[victim]
            slot = self._slot_of.pop(victim)
            self.demotes += 1
        self._slot_of[page] = slot
        if self._pins[page] == 0:
            self._lru[page] = None
        return slot, victim

    def pin(self, page: int) -> None:
        """One live-slot mapping now points at ``page`` (must be
        resident).  Pinned pages are exempt from demotion."""
        page = int(page)
        assert page in self._slot_of, f"pin of non-resident page {page}"
        self._pins[page] += 1
        self._lru.pop(page, None)

    def unpin(self, page: int) -> None:
        """Drop one live-slot mapping.  At pin count 0 a still-resident
        page joins the LRU (most-recently-used end) as a demotion
        candidate — it stays hot until slot pressure evicts it."""
        page = int(page)
        if self._pins[page] <= 0:
            raise ValueError(f"unpin of unpinned page {page}")
        self._pins[page] -= 1
        if self._pins[page] == 0 and page in self._slot_of:
            self._lru[page] = None

    def touch(self, page: int) -> None:
        """LRU bump for an unpinned resident (prefetch keeps the pages
        it staged warm until admission pins them)."""
        if int(page) in self._lru:
            self._lru.move_to_end(int(page))

    def release(self, page: int) -> None:
        """The flash page died (allocator refcount 0): free its slot.
        Wired as a ``PageAllocator`` release hook so every free path —
        slot teardown, cache eviction, speculative rollback — retires
        residency without knowing about tiers."""
        page = int(page)
        assert self._pins[page] == 0, \
            f"release of pinned page {page} (pins={int(self._pins[page])})"
        slot = self._slot_of.pop(page, None)
        if slot is not None:
            self._lru.pop(page, None)
            self._free_slots.append(slot)

    # ------------------------------------------------------------------
    def check(self) -> None:
        """Assert tier conservation (tests / debugging)."""
        slots = list(self._slot_of.values())
        assert len(slots) == len(set(slots)), "two pages share a hot slot"
        assert len(self._free_slots) == len(set(self._free_slots))
        assert not (set(self._free_slots) & set(slots)), \
            "slot both free and mapped"
        assert len(self._free_slots) + len(slots) == self.hot_slots, \
            (len(self._free_slots), len(slots), self.hot_slots)
        assert all(0 <= s < self.hot_slots for s in slots + self._free_slots)
        for p in self._lru:
            assert p in self._slot_of and self._pins[p] == 0, p
        for p, _ in self._slot_of.items():
            assert (self._pins[p] > 0) != (p in self._lru), p
        assert (self._pins >= 0).all()


# ---------------------------------------------------------------------------
# Radix-style prefix cache (full-page token prefixes + exact prompts)
# ---------------------------------------------------------------------------

@dataclass
class _Exact:
    pages: List[int]            # every page covering the prompt (last may
    n: int                      # be partial); n = prompt length in tokens
    logits: np.ndarray          # last-token logits (to sample the first
                                # output without recomputing the prompt)


@dataclass
class CacheHit:
    full_pages: List[int] = field(default_factory=list)  # read-only map-in
    exact: Optional[_Exact] = None                       # whole-prompt hit


class PrefixCache:
    """Token-prefix → physical-page cache at page granularity.

    ``register`` records, for a freshly prefilled prompt, one entry per
    full-page depth k (key = the first k·T tokens, value = the physical
    page holding tokens [(k-1)T, kT)) plus one EXACT entry for the whole
    prompt (all pages including a trailing partial page, and the
    last-token logits).  Page K/V at any layer depends only on tokens at
    positions ≤ its own (causal attention), so a key match guarantees
    bit-identical page contents regardless of which sequence registered
    it.  Every referenced page carries one cache refcount in the
    allocator; `evict_lru` drops entries (and their references) until
    pages come free.
    """

    def __init__(self, alloc: PageAllocator, page_tokens: int,
                 max_entries: int = 1024):
        self.alloc = alloc
        self.T = page_tokens
        self.max_entries = max_entries
        self._full: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        self._exact: "OrderedDict[Tuple[int, ...], _Exact]" = OrderedDict()
        self.hits = 0           # pages served from the cache
        self.lookups = 0        # prompt pages that could have been served

    # ------------------------------------------------------------------
    def lookup(self, prompt: Sequence[int], record: bool = True) -> CacheHit:
        """Longest usable hit for ``prompt``: an exact whole-prompt entry,
        else the deepest contiguous full-page chain with h·T < len(prompt)
        (strict: at least the last token is always computed so the caller
        has logits to sample from).

        record=False is a side-effect-free PEEK — no hit/lookup counter
        bumps, no LRU reordering."""
        toks = tuple(int(t) for t in prompt)
        n = len(toks)
        if record:
            self.lookups += (n + self.T - 1) // self.T
        hit = CacheHit()
        ex = self._exact.get(toks)
        if ex is not None:
            nf = n // self.T
            hit.full_pages = ex.pages[:nf]
            hit.exact = ex
            if record:
                self._exact.move_to_end(toks)
                self.hits += len(ex.pages)
                for k in range(1, nf + 1):
                    if toks[:k * self.T] in self._full:
                        self._full.move_to_end(toks[:k * self.T])
            return hit
        h = 0
        while (h + 1) * self.T < n:
            key = toks[:(h + 1) * self.T]
            page = self._full.get(key)
            if page is None:
                break
            if record:
                self._full.move_to_end(key)
            hit.full_pages.append(page)
            h += 1
        if record:
            self.hits += h
        return hit

    # ------------------------------------------------------------------
    def register(self, prompt: Sequence[int], pages: Sequence[int],
                 logits: np.ndarray, include_exact: bool = True) -> bool:
        """Insert a prefilled prompt's pages.  ``pages`` are the physical
        pages of logical pages 0..ceil(n/T)-1 in order.  Each NEW entry
        takes one allocator reference per page it names.

        include_exact=False registers only the full-page chain (callers
        skip the exact entry when the pool lacks slack to fund the
        copy-on-write its shared partial page would later force).
        Returns True when a NEW exact entry was added."""
        toks = tuple(int(t) for t in prompt)
        n = len(toks)
        n_pages = (n + self.T - 1) // self.T
        assert len(pages) >= n_pages, (len(pages), n_pages)
        for k in range(1, n // self.T + 1):
            key = toks[:k * self.T]
            if key not in self._full:
                self._full[key] = int(pages[k - 1])
                self.alloc.share([pages[k - 1]])
        added = False
        if include_exact and toks not in self._exact:
            ps = [int(p) for p in pages[:n_pages]]
            self._exact[toks] = _Exact(ps, n, np.asarray(logits))
            self.alloc.share(ps)
            added = True
        self._trim()
        return added

    # ------------------------------------------------------------------
    @property
    def entry_count(self) -> int:
        return len(self._full) + len(self._exact)

    def evictable_pages(self) -> int:
        """Pages that would come FREE if the whole cache were dropped:
        cache references to pages no live slot maps (refcount equals the
        number of cache references)."""
        refs: Dict[int, int] = {}
        for p in self._full.values():
            refs[p] = refs.get(p, 0) + 1
        for e in self._exact.values():
            for p in e.pages:
                refs[p] = refs.get(p, 0) + 1
        return sum(1 for p, r in refs.items()
                   if self.alloc.refcount[p] == r)

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (exact entries first — they
        hold the partial page that full-page chains can't serve anyway).
        Returns False when the cache is empty."""
        if self._exact:
            _, e = self._exact.popitem(last=False)
            self.alloc.free(e.pages)
            return True
        if self._full:
            _, page = self._full.popitem(last=False)
            self.alloc.free([page])
            return True
        return False

    def _trim(self) -> None:
        while self.entry_count > self.max_entries:
            if not self.evict_lru():
                break
