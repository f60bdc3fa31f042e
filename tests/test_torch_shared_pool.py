"""PyTorch port: the shared page pool against the JAX reference.

Same numpy inputs through both packages:

  * the plain shared decode partial (the CUDA kernel B2's CPU stand-in)
    against JAX `paged_attention_partial(page_table=...)` at impl="ref"
    and at impl="interpret" (the Pallas shared kernel), tolerance 3e-5 as
    the reference's own `test_shared_kernel_matches_gather_ref`; tables
    are permutations of a larger pool, one row's entries past its length
    name pages other rows own, and one row is all masked;
  * shared chunk fills, the ragged append and the copy-on-write page copy:
    pool bytes bit-identical to the reference's;
  * an engine trace through a permuted table (3 chunks + 4 decode steps,
    float32 pool): logits within 2e-4 relative of the JAX engine, the same
    pool cells written, with values equal up to float32 rounding (1e-5:
    the two frameworks' K/V projections differ in the last bits);
  * the aliasing case: an inactive slot whose table row names the cell an
    active slot appends into must not clobber the active token."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EngineConfig, get_config
from repro.core import paged_kv as jkv
from repro.core.engine import KVNANDEngine
from repro.core.quant import quantize_kv_page
from repro.kernels.paged_attention import (paged_attention_partial,
                                           paged_chunk_attention)
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tkv
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.kernels import paged_attention as tpa

torch.set_num_threads(2)

B, K, NP, T, DH = 4, 2, 4, 8, 16
P_TOTAL = B * NP + 5                  # the tables permute a larger pool
LENGTHS = (5, 17, 32, 0)              # ragged, full, all masked


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _shared_inputs(G, fmt, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, K * G, DH)).astype(np.float32)
    kd = r.standard_normal((K, P_TOTAL, T, DH)).astype(np.float32)
    vd = r.standard_normal((K, P_TOTAL, T, DH)).astype(np.float32)
    table = r.permutation(P_TOTAL)[:B * NP].reshape(B, NP).astype(np.int32)
    # row 0 holds 5 tokens: its entries past logical page 0 are stale and
    # name pages rows 1 and 2 own; the all-masked row 3 aliases row 2
    table[0, 1:] = table[2, 1:]
    table[3] = table[2]
    base = np.broadcast_to(np.arange(NP, dtype=np.int32) * T,
                           (B, NP)).copy()
    length = np.asarray(LENGTHS, np.int32)
    ks = vs = None
    if fmt != "none":
        kd, ks = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(kd),
                                                          fmt))
        vd, vs = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(vd),
                                                          fmt))
    return q, kd, vd, table, base, length, ks, vs


SWEEP = list(itertools.product(("none", "kv8", "kv4"), (None, 12), (1, 2),
                               (1, 2)))


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("fmt,window,partitions,G", SWEEP)
def test_shared_decode_partial_matches_reference(fmt, window, partitions, G,
                                                 impl):
    q, kp, vp, table, base, length, ks, vs = _shared_inputs(G, fmt)
    jo = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(base),
        jnp.asarray(length), window=window, impl=impl, kv_quant=fmt,
        k_scale=_jnp(ks), v_scale=_jnp(vs), page_table=jnp.asarray(table),
        partitions=partitions)
    to = tpa.paged_attention_partial(
        _t(q), _t(kp), _t(vp), _t(base), _t(length), window=window,
        kv_quant=fmt, k_scale=_t(ks), v_scale=_t(vs), page_table=_t(table),
        partitions=partitions)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                                   rtol=3e-5)
    o, m, l = to                        # the all-masked row
    assert torch.all(o[3] == 0) and torch.all(l[3] == 0)
    assert torch.all(m[3] == -1e30)


def test_shared_plain_version_is_the_stripe_oracle_on_gathered_pages():
    """`paged_attention_shared_ref` equals the stripe plain version on the
    stripes the tables describe, gathered by hand."""
    q, kp, vp, table, base, length, _, _ = _shared_inputs(2, "none", 1)
    stripe_k = np.stack([kp[:, row] for row in table])   # [B, K, NP, T, dh]
    stripe_v = np.stack([vp[:, row] for row in table])
    got = tpa.paged_attention_shared_ref(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(base), _t(length), window=12)
    want = tpa.paged_attention_partial_ref(_t(q), _t(stripe_k),
                                           _t(stripe_v), _t(base),
                                           _t(length), window=12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shared_decode_partial_bf16_pool():
    q, kp, vp, table, base, length, _, _ = _shared_inputs(2, "none", 2)
    jo, _, _ = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(base), jnp.asarray(length),
        impl="ref", page_table=jnp.asarray(table))
    to, _, _ = tpa.paged_attention_partial(
        _t(q), _t(kp, torch.bfloat16), _t(vp, torch.bfloat16), _t(base),
        _t(length), page_table=_t(table))
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("partitions", [1, 2])
def test_shared_chunk_partial_matches_reference(window, partitions):
    """The chunked-prefill past partial through one slot's table row."""
    _, kp, vp, table, base, _, _, _ = _shared_inputs(2, "none", 3)
    S, start = 8, 16
    q = np.random.default_rng(4).standard_normal(
        (1, S, K * 2, DH)).astype(np.float32)
    q_pos = start + np.arange(S, dtype=np.int32)
    jo = paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(base[1:2]), jnp.asarray(start, jnp.int32),
        jnp.asarray(q_pos), window=window, page_table=jnp.asarray(table[1:2]),
        partitions=partitions)
    to = tpa.paged_chunk_attention(
        _t(q), _t(kp), _t(vp), _t(base[1:2]), start, _t(q_pos),
        window=window, page_table=_t(table[1:2]), partitions=partitions)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                                   rtol=3e-5)


# ---------------------------------------------------------------------------
# pool writers: bit-identical bytes
# ---------------------------------------------------------------------------

L = 2


def test_shared_chunk_fills_bit_identical():
    r = np.random.default_rng(5)
    S, slot = 40, 1
    kv = r.standard_normal((1, S, K, DH)).astype(np.float32)
    table = r.permutation(P_TOTAL)[:B * NP].reshape(B, NP).astype(np.int32)
    init = r.standard_normal((L, K, P_TOTAL, T, DH)).astype(np.float32)
    jpool, tpool = jnp.asarray(init), _t(init)
    for c0, cl in ((0, 16), (16, 16), (32, 8)):
        chunk = np.zeros((1, 16, K, DH), np.float32)
        chunk[:, :cl] = kv[:, c0:c0 + cl]
        jpool = jkv.fill_chunk_global_at_shared(
            jpool, jnp.asarray(chunk), jnp.asarray(1),
            jnp.asarray(table[slot]), jnp.asarray(c0 // T), jnp.asarray(cl))
        tkv.fill_chunk_global_at_shared(tpool, _t(chunk), 1,
                                        _t(table[slot]), c0 // T, cl)
    # a chunk whose padding reaches past the table is dropped, not wrapped
    tail = r.standard_normal((1, 16, K, DH)).astype(np.float32)
    jpool = jkv.fill_chunk_global_at_shared(
        jpool, jnp.asarray(tail), jnp.asarray(0), jnp.asarray(table[0]),
        jnp.asarray(NP - 1), jnp.asarray(16))
    tkv.fill_chunk_global_at_shared(tpool, _t(tail), 0, _t(table[0]),
                                    NP - 1, 16)
    assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    assert not np.array_equal(tpool.numpy(), init)


def test_shared_append_and_cow_copy_bit_identical():
    """Active rows append through the table (the reference drops the
    inactive rows through its out-of-range sentinel, the port writes only
    the active rows), then a page is copied on write across all layers."""
    r = np.random.default_rng(6)
    init = r.standard_normal((L, K, P_TOTAL, T, DH)).astype(np.float32)
    phys = np.asarray([3, 7, 7, 11], np.int32)
    slot = np.asarray([0, 5, 5, 7], np.int32)
    active = np.asarray([True, True, False, True])
    val = r.standard_normal((B, K, DH)).astype(np.float32)
    jphys = np.where(active, phys, P_TOTAL)            # the drop sentinel
    jpool = jkv.append_global_shared(jnp.asarray(init), jnp.asarray(1),
                                     jnp.asarray(jphys), jnp.asarray(slot),
                                     jnp.asarray(val))
    tpool = _t(init)
    tkv.append_global_shared(tpool, 1, _t(phys), _t(slot), _t(val),
                             rows=torch.from_numpy(active).nonzero()[:, 0])
    assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    jpool = jkv.copy_page_shared(jpool, 7, 12)
    tkv.copy_page_shared(tpool, 7, 12)
    assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    assert np.array_equal(tpool[:, :, 12].numpy(), tpool[:, :, 7].numpy())


def test_inactive_row_aliasing_an_active_cell_keeps_the_active_token():
    """Two rows name one pool cell; only row 0 is active.  Writing the
    inactive row's current value back (the stripe writers' masking) would
    race the active token in one scatter; the shared writer skips it."""
    pool = torch.zeros(L, K, P_TOTAL, T, DH)
    val = torch.randn(2, K, DH, generator=torch.Generator().manual_seed(0))
    phys, slot = torch.tensor([9, 9]), torch.tensor([3, 3])
    active = torch.tensor([True, False])
    tkv.append_global_shared(pool, 0, phys, slot, val,
                             rows=active.nonzero()[:, 0])
    assert torch.equal(pool[0, :, 9, 3], val[0])
    assert int((pool != 0).sum()) == K * DH


# ---------------------------------------------------------------------------
# engine trace through a permuted table
# ---------------------------------------------------------------------------

TE, C = 8, 16          # page tokens, chunk bucket
_CACHE = {}


def _weights(arch):
    if arch not in _CACHE:
        cfg = get_config(arch).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE[arch] = (cfg, params, tparams)
    return _CACHE[arch]


def _engines(arch, total_pages=0):
    cfg, params, tparams = _weights(arch)
    kw = dict(page_tokens=TE, kv_dtype="float32", uniform_lengths=False,
              shared_pool=True, total_pages=total_pages)
    je = KVNANDEngine(cfg, EngineConfig(**kw))
    te = TEngine(tget(arch).reduced(), TEngineConfig(**kw), device="cpu")
    return cfg, params, tparams, je, te


def _set_tables(jc, tc, table):
    tkv.write_page_table(tc.page_table_g, table)
    return dataclasses.replace(jc, page_table_g=jnp.asarray(table))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_shared_engine_trace_matches_reference(arch):
    cfg, params, tparams, je, te = _engines(arch, total_pages=24)
    jc, tc = je.init_cache(2, 64), te.init_cache(2, 64)
    assert tuple(tc.k_pages_g.shape) == tuple(jc.k_pages_g.shape)
    assert np.array_equal(tc.page_table_g.numpy(), np.asarray(jc.page_table_g))
    r = np.random.default_rng(0)
    table = r.permutation(24)[:16].reshape(2, 8).astype(np.int32)
    jc = _set_tables(jc, tc, table)
    prompt0 = r.integers(1, cfg.vocab_size, 20)
    prompt1 = r.integers(1, cfg.vocab_size, 7)
    errs = []

    def chunk(toks, slot, start, n, first):
        nonlocal jc
        padded = np.zeros(C, np.int32)
        padded[:n] = toks
        jl, jc = je.prefill_chunk(params, jc,
                                  {"tokens": jnp.asarray(padded)[None]},
                                  slot, start, n, first=first)
        tl, _ = te.prefill_chunk(tparams, tc,
                                 {"tokens": torch.from_numpy(padded)[None]},
                                 slot, start, n, first=first)
        errs.append(_rel(tl, jl))

    chunk(prompt0[:16], 0, 0, 16, True)
    chunk(prompt1, 1, 0, 7, True)
    chunk(prompt0[16:], 0, 16, 4, False)
    for step in range(4):
        toks = r.integers(1, cfg.vocab_size, 2).astype(np.int32)
        active = np.asarray([True, step != 2])       # slot 1 sits out once
        jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                                active=jnp.asarray(active))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                               active=torch.from_numpy(active))
        errs.append(_rel(tl, jl))
    assert max(errs) < 2e-4, errs
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [24, 10]
    for name in ("k_pages_g", "v_pages_g"):
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        # the same cells written (the pools start at zero) ...
        assert np.array_equal(got != 0, want != 0)
        # ... with the same values up to float32 rounding: the writers are
        # bit-identical (above), the K/V projections round differently
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_engine_inactive_slot_aliasing_active_page():
    """Slot 1 is inactive while its table row names slot 0's pages at the
    same length, so its (page, slot) is slot 0's append cell: slot 0's new
    K/V must land there, as in the reference (which drops slot 1's write
    through its sentinel)."""
    cfg, params, tparams, je, te = _engines("qwen1.5-0.5b")
    jc, tc = je.init_cache(2, 32), te.init_cache(2, 32)
    r = np.random.default_rng(1)
    prompt = np.zeros(C, np.int32)
    prompt[:11] = r.integers(1, cfg.vocab_size, 11)
    _, jc = je.prefill_chunk(params, jc, {"tokens": jnp.asarray(prompt)[None]},
                             0, 0, 11, first=True)
    te.prefill_chunk(tparams, tc, {"tokens": torch.from_numpy(prompt)[None]},
                     0, 0, 11, first=True)
    table = np.asarray(tc.page_table_g).copy()
    table[1] = table[0]
    jc = _set_tables(jc, tc, table)
    tc.lengths[1] = 11
    jc = dataclasses.replace(jc, lengths=jc.lengths.at[1].set(11))
    toks = np.asarray([5, 6], np.int32)
    active = np.asarray([True, False])
    before = tc.k_pages_g[:, :, table[0, 1], 11 - TE].clone()
    jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                            active=jnp.asarray(active))
    tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                           active=torch.from_numpy(active))
    cell = tc.k_pages_g[:, :, table[0, 1], 11 - TE]
    assert not torch.equal(cell, before)
    np.testing.assert_allclose(
        cell.numpy(), np.asarray(jc.k_pages_g[:, :, table[0, 1], 11 - TE]),
        atol=1e-5, rtol=1e-5)
    assert _rel(tl[:1], jl[:1]) < 2e-4
    assert tc.lengths.tolist() == [12, 11]
