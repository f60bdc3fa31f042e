"""PyTorch port: the copied page allocator and prefix cache against the
reference's, op for op.

The same random sequence of alloc / share / cow / free / register /
lookup / evict (drawn from a numpy seed) drives `repro.core.page_alloc`
and `repro_torch.core.page_alloc`; every returned page id, hit, refcount
and free-list state must be identical, and both must pass `check()`
after every op."""
import numpy as np
import pytest

from repro.core import page_alloc as ref
from repro_torch.core import page_alloc as port

TOTAL, T = 24, 4


def _state(alloc, cache):
    return (alloc.refcount.tolist(), [list(f) for f in alloc._free],
            list(cache._full.items()),
            [(k, e.pages, e.n) for k, e in cache._exact.items()],
            cache.hits, cache.lookups, cache.evictable_pages())


def _apply(mod, alloc, cache, op, arg, logits):
    """One op on one implementation; returns what it returned (an
    exception type for refused ops)."""
    try:
        if op == "alloc":
            return alloc.alloc_for_logical(arg)
        if op == "share":
            return alloc.share([arg])
        if op == "free":
            return alloc.free([arg])
        if op == "cow":
            return alloc.cow(arg)
        if op == "register":
            prompt, pages = arg
            return cache.register(prompt, pages,
                                  np.asarray(logits, np.float32),
                                  include_exact=len(prompt) % 3 != 0)
        if op == "lookup":
            hit = cache.lookup(arg, record=len(arg) % 2 == 0)
            return (hit.full_pages,
                    None if hit.exact is None else (hit.exact.pages,
                                                    hit.exact.n))
        if op == "evict":
            return cache.evict_lru()
    except (mod.OutOfPages, ValueError) as e:
        return type(e).__name__
    raise AssertionError(op)


@pytest.mark.parametrize("seed", range(8))
def test_same_op_sequence_same_pages_refcounts_and_hits(seed):
    r = np.random.default_rng(seed)
    ra, pa = ref.PageAllocator(TOTAL), port.PageAllocator(TOTAL)
    rc, pc = ref.PrefixCache(ra, T, max_entries=6), \
        port.PrefixCache(pa, T, max_entries=6)
    released = {"ref": [], "port": []}
    ra.add_release_hook(released["ref"].append)
    pa.add_release_hook(released["port"].append)
    prompts = [r.integers(0, 3, n).tolist() for n in r.integers(1, 14, 6)]
    for _ in range(300):
        op = r.choice(["alloc", "alloc", "share", "free", "cow", "register",
                       "lookup", "evict"])
        live = np.flatnonzero(ra.refcount > 0)
        if op == "alloc":
            arg = int(r.integers(0, 8))
        elif op in ("share", "free", "cow"):
            if not len(live):
                continue
            arg = int(r.choice(live))
        elif op == "register":
            prompt = prompts[r.integers(len(prompts))]
            need = -(-len(prompt) // T)
            if len(live) < need:
                continue
            arg = (prompt, [int(p) for p in r.choice(live, need)])
        elif op == "lookup":
            arg = prompts[r.integers(len(prompts))]
        else:
            arg = None
        logits = r.standard_normal(3)
        got_r = _apply(ref, ra, rc, op, arg, logits)
        got_p = _apply(port, pa, pc, op, arg, logits)
        assert got_p == got_r, (op, arg)
        assert _state(pa, pc) == _state(ra, rc)
        ra.check()
        pa.check()
    assert released["port"] == released["ref"]
    assert pa.live_count == ra.live_count and pa.free_count == ra.free_count


def test_exact_entry_keeps_float32_logits():
    """An exact hit hands back the registered last-token logits unchanged
    (the server samples a repeat's first token from them)."""
    alloc = port.PageAllocator(8)
    cache = port.PrefixCache(alloc, T)
    pages = [alloc.alloc() for _ in range(2)]
    logits = np.random.default_rng(0).standard_normal(11).astype(np.float32)
    assert cache.register(list(range(6)), pages, logits)
    hit = cache.lookup(list(range(6)))
    assert hit.exact.pages == pages and hit.full_pages == pages[:1]
    assert hit.exact.logits.dtype == np.float32
    np.testing.assert_array_equal(hit.exact.logits, logits)
    assert alloc.refcount[pages].tolist() == [3, 2]
