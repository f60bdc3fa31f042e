"""Disaggregated prefill/decode: KV page migration between replicas (port
of `repro.serving.replica`).

A request that chunk-prefilled on one `ContinuousBatcher` moves to
another (a PREFILL replica handing off to a DECODE replica) as a
`KVEnvelope` holding everything the decode side needs:

  * the request's pages as PAGE BYTES in logical order (physical ids are
    replica-local and never travel): one [L, K, T, dh] block per mapped
    global-pool page, per pool leaf, kv8/kv4 codes and their per-page
    scales alike;
  * window-ring pages and the slot's `page_pos_w` ring-base row;
  * recurrent-state rows (RWKV6's state and shifts, a hybrid's SSM
    state and conv tail);
  * the slot's length, the output so far (the prefill handoff token),
    its logprobs, and the request's `SamplingParams` with its RESOLVED
    seed, so the decode replica continues ``fold_in(PRNGKey(seed),
    position)`` where prefill stopped.

The wire form is the reference's, byte for byte in layout: an 8-byte
little-endian header length, the JSON header (sorted keys) and an
`np.savez` payload of the flat ``{path: array}`` dict the checkpoint
flattener makes (bf16 pages travel as float32, as the reference's do).
So an envelope exported by either package imports into the other.

Import allocates FRESH physical pages on the destination (admission
accounting mirrors `_admit_shared`: the worst-case footprint against
free plus evictable pages net of reservations, and on a tiered pool
against the hot tier net of every slot's) and writes through the
`paged_kv` writers only: `stage_hot_slot` for page bytes (a flat pool's
physical index in the hot slot's place), `import_slot_rows` for the
slot's rows.  Every write is enqueued on the device's stream, after any
step still in flight there.

`PrefixPageIndex` is the cross-replica prefix index: full-page KV bytes
keyed by their token chain, published from any replica's `PrefixCache`
and imported into another's pool, so system-prompt pages prefilled on
replica A admit as prefix hits on replica B.
"""
from __future__ import annotations

import dataclasses
import io
import json
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.core import paged_kv
from repro_torch.core.page_alloc import OutOfPages
from repro_torch.core.quant import QuantizedWeight
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import ContinuousBatcher, Request

ENVELOPE_VERSION = 1

# per-slot rows of the [L, B, ...] leaves (batch axis 1) that migrate as
# [L, ...] stacks
_STATE_ROW_LEAVES = ("rwkv_state", "rwkv_shift", "rwkv_shift2",
                     "ssm_state", "conv_tail")
_WINDOW_LEAVES = ("k_pages_w", "v_pages_w", "k_scale_w", "v_scale_w")


def _window_leaves(cache) -> List[str]:
    return [n for n in _WINDOW_LEAVES if getattr(cache, n) is not None]


def _page_bytes(batcher: ContinuousBatcher, phys: int,
                leaves: Sequence[str]) -> Dict[str, np.ndarray]:
    """One physical page's bytes per pool leaf, wherever they live: the
    device pool (flat), the hot tier (tiered resident: a live slot's
    pages are pinned hot) or the capacity store (tiered demoted)."""
    return paged_kv.read_page_bytes(
        batcher.cache, phys, leaves, tier=batcher.tier,
        store=batcher._store if batcher.tier is not None else None)


@dataclasses.dataclass
class KVEnvelope:
    """One migratable request: a JSON-able header plus the flat
    ``{path: array}`` dict of the checkpoint flattener.

    Array paths: ``prompt`` / ``output`` / ``logprobs``,
    ``pages_g/<j>/<leaf>`` and ``pages_w/<j>/<leaf>`` per logical page j,
    ``page_pos_w``, and ``state/<leaf>`` rows."""
    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]

    @property
    def uid(self) -> int:
        return int(self.meta["uid"])

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values()))

    def to_bytes(self) -> bytes:
        """Wire form: 8-byte header length, JSON header, npz payload."""
        buf = io.BytesIO()
        np.savez(buf, **self.arrays)
        header = json.dumps(self.meta, sort_keys=True).encode()
        return (len(header).to_bytes(8, "little") + header
                + buf.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVEnvelope":
        hlen = int.from_bytes(data[:8], "little")
        meta = json.loads(data[8:8 + hlen].decode())
        if meta.get("version") != ENVELOPE_VERSION:
            raise ValueError(
                f"KVEnvelope version {meta.get('version')} != "
                f"{ENVELOPE_VERSION}")
        npz = np.load(io.BytesIO(data[8 + hlen:]))
        return cls(meta=meta, arrays={k: npz[k] for k in npz.files})


def _slot_of(batcher: ContinuousBatcher, uid: int) -> int:
    for i, r in enumerate(batcher.slots):
        if r is not None and r.uid == uid:
            return i
    raise KeyError(f"uid {uid} occupies no slot (queued, finished, or "
                   "unknown)")


def export_request(batcher: ContinuousBatcher, uid: int) -> KVEnvelope:
    """Serialize one slot-resident request's KV state.  Read-only: the
    source keeps its pages until `finish_migrated`, so an import that
    fails is retried without losing the request.  The reads are
    same-stream copies, ordered after any step in flight (which a held
    row is not part of)."""
    if not batcher.shared:
        raise ValueError(
            "KV migration needs the shared-pool layout (physical pages "
            "addressed through tables); stripe caches have no per-page "
            "identity to serialize — run replicas with "
            "EngineConfig(shared_pool=True)")
    i = _slot_of(batcher, uid)
    req = batcher.slots[i]
    if i in batcher._prefill_live:
        raise ValueError(f"uid {uid} is mid-chunked-prefill; export "
                         "after the prefill handoff token")
    if not req.output:
        raise ValueError(f"uid {uid} has no emitted token yet")
    c = batcher.cache
    T = batcher.engine.eng.page_tokens
    length = int(batcher._lengths[i])

    tree: Dict[str, Any] = {
        "prompt": np.asarray(req.prompt, np.int32),
        "output": np.asarray(req.output, np.int32),
        "logprobs": np.asarray(req.logprobs, np.float64),
    }
    n_pg = 0
    if batcher.alloc is not None:
        pages = batcher._slot_pages[i]
        n_pg = len(pages)
        assert sorted(pages) == list(range(n_pg)), \
            f"non-contiguous logical pages {sorted(pages)}"
        assert n_pg == -(-length // T), (n_pg, length, T)
        tree["pages_g"] = {
            f"{j:04d}": _page_bytes(batcher, pages[j],
                                    batcher._pool_leaves)
            for j in range(n_pg)}
    n_pw = 0
    if batcher.alloc_w is not None:
        ring = batcher._slot_ring[i]
        n_pw = len(ring)
        wl = _window_leaves(c)
        tree["pages_w"] = {
            f"{j:04d}": paged_kv.read_page_bytes(c, p, wl)
            for j, p in enumerate(ring)}
    tree["page_pos_w"] = (c.page_pos_w[i] if c.page_pos_w is not None
                          else None)
    state = {n: getattr(c, n)[:, i]
             for n in _STATE_ROW_LEAVES if getattr(c, n) is not None}
    tree["state"] = state or None

    p = req.params
    meta = {
        "version": ENVELOPE_VERSION,
        "uid": req.uid,
        "length": length,
        "n_pages_g": n_pg,
        "n_pages_w": n_pw,
        "page_tokens": T,
        "kv_quant": batcher.engine.eng.kv_quant,
        "seed": int(batcher._seed_of(req)),
        "priority": req.priority,
        "deadline_ts": req.deadline_ts,
        "submit_ts": req.submit_ts,
        "first_ts": req.first_ts,
        "params": {
            "temperature": p.temperature, "top_k": p.top_k,
            "top_p": p.top_p, "max_new_tokens": p.max_new_tokens,
            "stop_token_ids": list(p.stop_token_ids),
            "logprobs": p.logprobs, "speculation": p.speculation,
        },
    }
    return KVEnvelope(meta=meta, arrays=_flatten_with_paths(tree))


def finish_migrated(batcher: ContinuousBatcher, uid: int) -> None:
    """Release the source half of a completed migration: the slot retires
    with ``finish_reason="migrated"`` and its pages go back through the
    allocator (prefix-cache references survive, as on any finish)."""
    i = _slot_of(batcher, uid)
    batcher._prefill_live.pop(i, None)
    batcher._finish(i, "migrated")
    batcher.stats["migrations_out"] = (
        batcher.stats.get("migrations_out", 0) + 1)


def _stage_page(batcher: ContinuousBatcher, dst: int,
                vals: Dict[str, np.ndarray]) -> None:
    dev = batcher.device
    paged_kv.stage_hot_slot(batcher.cache, dst, {
        n: paged_kv.host_to_device(v, dev) for n, v in vals.items()})


def import_request(batcher: ContinuousBatcher,
                   env: KVEnvelope) -> Optional[Request]:
    """Splice a migrated request into a free slot of `batcher`.

    Returns the (fresh) Request now decoding here, or None when the
    destination cannot take it YET: no free slot, or the worst-case
    footprint does not fit the pool / hot tier net of reservations (the
    bound `_admit_shared` enforces, so an admitted import never runs out
    of pages or hot slots mid-decode).  A layout mismatch raises:
    migration is defined only between replicas serving the same model
    and cache layout."""
    if not batcher.shared:
        raise ValueError("KV migration import needs a shared-pool "
                         "batcher (EngineConfig.shared_pool=True)")
    m = env.meta
    T = batcher.engine.eng.page_tokens
    if m["page_tokens"] != T or m["kv_quant"] != batcher.engine.eng.kv_quant:
        raise ValueError(
            f"KVEnvelope layout (page_tokens={m['page_tokens']}, "
            f"kv_quant={m['kv_quant']!r}) does not match this replica "
            f"(page_tokens={T}, "
            f"kv_quant={batcher.engine.eng.kv_quant!r})")
    free = [i for i, r in enumerate(batcher.slots)
            if r is None and i not in batcher._prefill_live]
    if not free:
        return None
    i = free[0]

    params = SamplingParams(seed=int(m["seed"]), **m["params"])
    req = Request(
        uid=int(m["uid"]), prompt=[int(t) for t in env.arrays["prompt"]],
        max_new=params.max_new_tokens, params=params,
        output=[int(t) for t in env.arrays["output"]],
        logprobs=[float(v) for v in env.arrays["logprobs"]],
        priority=int(m["priority"]), deadline_ts=m["deadline_ts"],
        submit_ts=m["submit_ts"], first_ts=m["first_ts"])
    length = int(m["length"])
    n_pg, n_pw = int(m["n_pages_g"]), int(m["n_pages_w"])

    # -- admission accounting (the mirror of _admit_shared): every
    # imported page is a FRESH allocation here, so the whole worst-case
    # footprint must fit free + evictable pages net of reservations
    need_g = batcher._pages_needed(req) if batcher.alloc is not None else 0
    if batcher.alloc is not None:
        assert n_pg == -(-length // T), (n_pg, length, T)
        evictable = (batcher.prefix_cache.evictable_pages()
                     if batcher.prefix_cache is not None else 0)
        avail = (batcher.alloc.free_count + evictable
                 - batcher._outstanding)
        if need_g > avail:
            return None
        if batcher.tier is not None \
                and batcher._hot_out + need_g > batcher.tier.hot_slots:
            return None
    if batcher.alloc_w is not None and n_pw > batcher.alloc_w.free_count:
        return None

    # -- page bytes: destination-local physical pages, each logical
    # page's leaves through the one staging writer (a tiered pool binds
    # and pins a hot slot per page)
    if batcher.alloc is not None:
        for j in range(n_pg):
            p = batcher._alloc_g(j)
            batcher._slot_pages[i][j] = p
            if batcher.tier is not None:
                batcher._table_np[i, j] = batcher._bind_slot(p)
                batcher.tier.pin(p)
                dst = int(batcher._table_np[i, j])
            else:
                batcher._table_np[i, j] = p
                dst = p
            _stage_page(batcher, dst, {
                n: env.arrays[f"pages_g/{j:04d}/{n}"]
                for n in batcher._pool_leaves})
    if batcher.alloc_w is not None:
        wl = _window_leaves(batcher.cache)
        for j in range(n_pw):
            p = batcher.alloc_w.alloc_for_logical(j)
            batcher._slot_ring[i].append(p)
            batcher._table_w_np[i, j] = p
            _stage_page(batcher, p, {
                n: env.arrays[f"pages_w/{j:04d}/{n}"] for n in wl})

    # -- per-slot rows: length, ring bases, recurrent state
    rows: Dict[str, np.ndarray] = {"lengths": np.asarray(length)}
    if batcher.cache.page_pos_w is not None:
        rows["page_pos_w"] = env.arrays["page_pos_w"]
    for n in _STATE_ROW_LEAVES:
        if getattr(batcher.cache, n) is not None:
            rows[n] = env.arrays[f"state/{n}"]
    paged_kv.import_slot_rows(batcher.cache, i, rows)

    # -- host bookkeeping: the slot now looks exactly like one whose
    # chunked prefill just handed off
    req.order = batcher._submit_seq
    batcher._submit_seq += 1
    batcher.slots[i] = req
    batcher._set_slot_params(i, req)
    batcher._lengths[i] = length
    batcher._resv[i] = need_g - n_pg
    batcher._outstanding += need_g - n_pg
    if batcher.tier is not None:
        batcher._hot_resv[i] = need_g
        batcher._hot_out += need_g
    batcher._tables_dirty = True
    batcher._push_tables()
    batcher.stats["migrations_in"] = (
        batcher.stats.get("migrations_in", 0) + 1)
    batcher.stats["admits"] += 1
    return req


def _params_on(params, device):
    """The params tree on `device`; a tensor already there is the same
    tensor (replicas on one device share their weights)."""
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    if isinstance(params, (torch.Tensor, QuantizedWeight)):
        return params.to(device)
    return params


def build_replica(config=None, *, cfg=None, params=None, rt=None,
                  device=None):
    """A `KVNANDServer` whose weights and KV pool live on `device` (one
    replica per card, or several on one).  Replicas built from one
    params tree on one device share its tensors and copy none.
    Migration and the prefix index move bytes through the host, so
    envelopes cross devices without a collective; `device=None` keeps
    ``config.device``."""
    from repro_torch.serving.api import KVNANDServer, ServerConfig
    if device is not None:
        config = dataclasses.replace(config or ServerConfig(),
                                     device=str(device))
        if params is not None:
            params = _params_on(params, torch.device(device))
    return KVNANDServer(config, cfg=cfg, params=params, rt=rt)


class PrefixPageIndex:
    """Cross-replica prefix-cache index.

    Maps full-page token chains (the radix keys `PrefixCache` uses) to
    host page BYTES per pool leaf.  `publish_from` reads a replica's
    local cache chain for a prompt and records pages the index lacks;
    `warm` imports the chain's missing tail into another replica's pool
    and registers it in that replica's local cache, so the next
    admission of the prompt maps warm pages (a prefix hit) instead of
    prefilling them.  A tiered destination lands imported bytes in its
    CAPACITY store, from which the map-in path (or the queue-ahead
    prefetch) promotes them as any other demoted page.

    A bounded LRU over pages; eviction drops index bytes only, never a
    replica's own cache entries."""

    def __init__(self, page_tokens: int, max_pages: int = 512):
        self.T = page_tokens
        self.max_pages = max_pages
        self._pages: "OrderedDict[Tuple[int, ...], Dict[str, np.ndarray]]" \
            = OrderedDict()
        self.published_pages = 0
        self.warmed_pages = 0

    def __len__(self) -> int:
        return len(self._pages)

    def publish_from(self, batcher: ContinuousBatcher,
                     prompt: Sequence[int]) -> int:
        """Record the full-page chain the replica's local cache holds for
        `prompt`; returns pages newly added to the index."""
        if batcher.prefix_cache is None or batcher.alloc is None:
            return 0
        hit = batcher.prefix_cache.lookup(prompt, record=False)
        n_full = len(prompt) // self.T
        pages = (hit.exact.pages[:n_full] if hit.exact is not None
                 else hit.full_pages)
        toks = tuple(int(t) for t in prompt)
        added = 0
        for j, p in enumerate(pages):
            key = toks[:(j + 1) * self.T]
            if key in self._pages:
                self._pages.move_to_end(key)
                continue
            self._pages[key] = _page_bytes(batcher, int(p),
                                           batcher._pool_leaves)
            added += 1
        while len(self._pages) > self.max_pages:
            self._pages.popitem(last=False)
        self.published_pages += added
        return added

    def chain(self, prompt: Sequence[int]) -> List[Dict[str, np.ndarray]]:
        """The deepest contiguous full-page chain the index holds for
        `prompt` (strict h·T < len, as `PrefixCache.lookup`)."""
        toks = tuple(int(t) for t in prompt)
        out: List[Dict[str, np.ndarray]] = []
        while (len(out) + 1) * self.T < len(toks):
            key = toks[:(len(out) + 1) * self.T]
            vals = self._pages.get(key)
            if vals is None:
                break
            self._pages.move_to_end(key)
            out.append(vals)
        return out

    def warm(self, batcher: ContinuousBatcher,
             prompt: Sequence[int]) -> int:
        """Import into `batcher` the chain pages its local cache lacks:
        allocate a page, stage the bytes (flat pool) or park them in the
        capacity store (tiered), register the extended chain, and drop
        the import reference so the local cache is the sole owner.
        Returns pages imported; backs off under page pressure (warming
        is an optimization, never an obligation)."""
        if batcher.prefix_cache is None or batcher.alloc is None:
            return 0
        local = batcher.prefix_cache.lookup(prompt, record=False)
        if local.exact is not None:
            return 0
        have = len(local.full_pages)
        chain = self.chain(prompt)
        if len(chain) <= have:
            return 0
        pin = batcher.device.type == "cuda"
        new_pages: List[int] = []
        for j in range(have, len(chain)):
            if batcher.alloc.free_count - batcher._outstanding <= 0:
                break
            try:
                p = batcher._alloc_g(j)
            except (OutOfPages, RuntimeError):
                break
            if batcher.tier is not None:
                batcher._store[p] = {
                    n: (torch.from_numpy(np.array(v)).pin_memory() if pin
                        else torch.from_numpy(np.array(v)))
                    for n, v in chain[j].items()}
            else:
                _stage_page(batcher, p, chain[j])
            new_pages.append(p)
        if not new_pages:
            return 0
        n_reg = have + len(new_pages)
        pages = [int(p) for p in local.full_pages] + new_pages
        batcher.prefix_cache.register(list(prompt)[:n_reg * self.T],
                                      pages, None, include_exact=False)
        batcher.alloc.free(new_pages)     # the cache reference remains
        self.warmed_pages += len(new_pages)
        return len(new_pages)
