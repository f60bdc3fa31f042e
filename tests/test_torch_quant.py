"""PyTorch port: weight quantization and the kv8/kv4 pool writers against
the JAX reference.

Same numpy inputs through both packages:

  * `quantize_weight` codes and scales, `dequantize`,
    `quantize_activations_int8` and the tree-level `quantize_params`:
    bit-identical, for 2-D and stacked leaves of both schemes;
  * the requantizing token appends (stripe and shared), the quantizing
    chunk fills (stripe and shared) and the copy-on-write page copy of
    the scale leaves: pool codes and scales bit-identical for kv8 and kv4;
  * aliasing: an inactive row whose stale (page, slot) names an active
    row's page must leave that page's tokens and scale as the active row
    wrote them — an all-rows requantize zeroes the active row's tokens
    past the stale slot."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import paged_kv as jkv
from repro.core import quant as jq
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.core import paged_kv as tkv
from repro_torch.core import quant as tq

torch.set_num_threads(2)

SCHEMES = ("w4a16", "w8a8")
FORMATS = ("kv8", "kv4")


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape", [(64, 48), (130, 77), (3, 96, 40),
                                   (2, 2, 32, 16)])
def test_quantize_weight_bit_identical(scheme, shape):
    r = np.random.default_rng(0)
    w = r.standard_normal(shape).astype(np.float32) * 0.1
    w[..., 5] = 0.0                        # an all-zero output channel
    if scheme == "w4a16" and shape[-2] % 2:
        with pytest.raises(ValueError):
            tq.quantize_weight(_t(w), scheme)
        return
    jw = jq.quantize_weight(jnp.asarray(w), scheme)
    tw = tq.quantize_weight(_t(w), scheme)
    assert tw.q.dtype == (torch.uint8 if scheme == "w4a16" else torch.int8)
    assert _same(tw.q, jw.q) and _same(tw.scale, jw.scale)
    assert tw.scheme == jw.scheme and tw.orig_shape == jw.orig_shape
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize(tw, dt_t).float()
        want = np.asarray(jq.dequantize(jw, dt_j).astype(jnp.float32))
        assert np.array_equal(got.numpy(), want)


def test_quantize_activations_int8_bit_identical():
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 7, 96)).astype(np.float32)
    x[1, 2] = 0.0                          # an all-zero token
    jxq, jxs = jq.quantize_activations_int8(jnp.asarray(x))
    txq, txs = tq.quantize_activations_int8(_t(x))
    assert txq.dtype == torch.int8
    assert _same(txq, jxq) and _same(txs, jxs)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_params_and_layer_slices(scheme):
    """The same leaves quantize (matmul weights; not norms, biases or the
    embedding), bit for bit; a stacked leaf slices per layer."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = Model(cfg).init(jax.random.PRNGKey(0))
    jtree = bridge.flatten_with_paths(
        jax.tree.map(np.asarray, jq.quantize_params(params, scheme)))
    ttree = bridge.flatten_with_paths(tq.quantize_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        scheme))
    assert sorted(ttree) == sorted(jtree)
    quantized = [k for k, v in ttree.items()
                 if isinstance(v, tq.QuantizedWeight)]
    assert sorted(quantized) == sorted(
        f"layers/{n}_w" for n in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                  "mlp/gate", "mlp/up", "mlp/down"))
    for k in quantized:
        t, j = ttree[k], jtree[k]
        assert _same(t.q, j.q) and _same(t.scale, j.scale), k
        assert t.orig_shape == j.orig_shape, k
        one = t[1]                              # layer 1 of the stack
        assert one.orig_shape == t.orig_shape[1:]
        assert torch.equal(one.q, t.q[1]) and torch.equal(one.scale,
                                                          t.scale[1])
    assert tq.quantize_params(ttree, "none") is ttree


# ---------------------------------------------------------------------------
# kv8/kv4 pool writers
# ---------------------------------------------------------------------------

L, B, K, NP, T, DH = 2, 4, 2, 4, 8, 16
P_TOTAL = B * NP + 5


def _pool(r, lead, fmt):
    """Random pages quantized into (codes, scales) of format `fmt`."""
    x = r.standard_normal(lead + (T, DH)).astype(np.float32)
    q, s = jq.quantize_kv_page(jnp.asarray(x), fmt)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("fmt", FORMATS)
def test_stripe_append_quant_bit_identical(fmt):
    """Active rows requantize their page with the new token (the reference
    drops inactive rows through its out-of-range sentinel, the port writes
    only the active rows).  The reference runs under jit, as it serves:
    XLA computes the page scale amax / 7 as amax * (1 / 7), and a
    requantized page's old codes can sit on the rounding tie that last bit
    decides."""
    r = np.random.default_rng(2)
    q0, s0 = _pool(r, (L, B, K, NP), fmt)
    phys = np.asarray([0, 2, 3, 1], np.int32)
    slot = np.asarray([0, 5, T - 1, 3], np.int32)
    active = np.asarray([True, True, False, True])
    val = r.standard_normal((B, K, DH)).astype(np.float32) * 3
    append = jax.jit(jkv.append_token_quant, static_argnums=6)
    jq_, js = append(
        jnp.asarray(q0), jnp.asarray(s0), jnp.asarray(1),
        jnp.asarray(np.where(active, phys, NP)), jnp.asarray(slot),
        jnp.asarray(val), fmt)
    tq_, ts = _t(q0), _t(s0)
    tkv.append_token_quant(tq_, ts, 1, _t(phys), _t(slot), _t(val), fmt,
                           rows=_t(active).nonzero()[:, 0])
    assert _same(tq_, jq_) and _same(ts, js)
    assert not np.array_equal(tq_.numpy(), q0)
    # every row writing (no active mask) matches the reference too
    jq_, js = append(jnp.asarray(q0), jnp.asarray(s0), jnp.asarray(0),
                     jnp.asarray(phys), jnp.asarray(slot), jnp.asarray(val),
                     fmt)
    tq_, ts = _t(q0), _t(s0)
    tkv.append_token_quant(tq_, ts, 0, _t(phys), _t(slot), _t(val), fmt)
    assert _same(tq_, jq_) and _same(ts, js)


@pytest.mark.parametrize("s_old", [0.5, 1.0, 0.4052151143550873])
def test_requantized_tie_follows_the_served_reference(s_old):
    """A kv4 page whose amax token (code 7, slot 10) falls past the new
    token's slot: the zeroed page's amax is a code-6 token, the new scale
    6/7 of the old, and the old code 3 lands on the tie 3.5.  The jitted
    reference (as it serves) computes the scale as amax * (1 / 7), one bit
    off amax / 7, and rounds the tie down where the eager reference rounds
    it up; the port follows the served one, codes and scale."""
    codes = np.zeros((1, 1, 1, 1, 16, 4), np.int8)
    codes[..., 0, :] = [3, -3, 1, 0]
    codes[..., 1, :] = [6, 0, 0, 0]
    codes[..., 10, :] = [7, 0, 0, 0]
    q = tq.pack_int4_tokens(torch.from_numpy(codes + 8)).numpy()
    s = np.full((1, 1, 1, 1), s_old, np.float32)
    val = np.full((1, 1, 4), 0.01, np.float32)
    args = (jnp.asarray(q), jnp.asarray(s), 0, jnp.asarray([0]),
            jnp.asarray([2]), jnp.asarray(val), "kv4")
    served = jax.jit(jkv.append_token_quant, static_argnums=6)(*args)
    eager = jkv.append_token_quant(*args)
    tq_, ts = _t(q), _t(s)
    tkv.append_token_quant(tq_, ts, 0, torch.tensor([0]), torch.tensor([2]),
                           _t(val), "kv4")
    assert _same(tq_, served[0]) and _same(ts, served[1])
    assert not np.array_equal(np.asarray(eager[0]), np.asarray(served[0]))
    # token 0's codes 3 / -3 went to 3 / -3 (4 / -4 eager): the tie
    assert tq.unpack_int4_tokens(tq_)[0, 0, 0, 0, 0].tolist() == [3, -3, 1, 0]


@pytest.mark.parametrize("fmt", FORMATS)
def test_shared_append_quant_and_cow_copy_bit_identical(fmt):
    r = np.random.default_rng(3)
    q0, s0 = _pool(r, (L, K, P_TOTAL), fmt)
    phys = np.asarray([3, 7, 7, 11], np.int32)
    slot = np.asarray([0, 5, 2, T - 1], np.int32)
    active = np.asarray([True, True, False, True])
    val = r.standard_normal((B, K, DH)).astype(np.float32)
    jq_, js = jkv.append_token_quant_shared(
        jnp.asarray(q0), jnp.asarray(s0), jnp.asarray(1),
        jnp.asarray(np.where(active, phys, P_TOTAL)), jnp.asarray(slot),
        jnp.asarray(val), fmt)
    tq_, ts = _t(q0), _t(s0)
    tkv.append_token_quant_shared(tq_, ts, 1, _t(phys), _t(slot), _t(val),
                                  fmt, rows=_t(active).nonzero()[:, 0])
    assert _same(tq_, jq_) and _same(ts, js)
    for jleaf, tleaf in ((jq_, tq_), (js, ts)):
        jleaf = jkv.copy_page_shared(jleaf, 7, 12)
        tkv.copy_page_shared(tleaf, 7, 12)
        assert _same(tleaf, jleaf)
        assert torch.equal(tleaf[:, :, 12], tleaf[:, :, 7])


@pytest.mark.parametrize("fmt", FORMATS)
def test_chunk_fills_quant_bit_identical(fmt):
    """Three chunks of one slot's prompt (the last one partial) and a chunk
    whose padding reaches past the walk, on the stripe and through a
    permuted table of the shared pool (the reference under jit, as it
    serves)."""
    r = np.random.default_rng(4)
    kv = r.standard_normal((1, 40, K, DH)).astype(np.float32)
    table = r.permutation(P_TOTAL)[:B * NP].reshape(B, NP).astype(np.int32)
    chunks = []
    for c0, cl in ((0, 16), (16, 16), (32, 8)):
        chunk = r.standard_normal((1, 16, K, DH)).astype(np.float32)
        chunk[:, :cl] = kv[:, c0:c0 + cl]       # padding rows stay random
        chunks.append((chunk, c0 // T, cl))
    tail = (r.standard_normal((1, 16, K, DH)).astype(np.float32), NP - 1, 16)
    for shared in (False, True):
        lead = (L, K, P_TOTAL) if shared else (L, B, K, NP)
        q0, s0 = _pool(r, lead, fmt)
        jq_, js = jnp.asarray(q0), jnp.asarray(s0)
        tq_, ts = _t(q0), _t(s0)
        for slot, (chunk, page0, cl) in [(1, c) for c in chunks] + [(0, tail)]:
            kw = dict(kv_quant=fmt)
            if shared:
                jq_, js = jax.jit(jkv.fill_chunk_global_at_shared,
                                  static_argnames="kv_quant")(
                    jq_, jnp.asarray(chunk), jnp.asarray(1),
                    jnp.asarray(table[slot]), jnp.asarray(page0),
                    jnp.asarray(cl), scale=js, **kw)
                tkv.fill_chunk_global_at_shared(tq_, _t(chunk), 1,
                                                _t(table[slot]), page0, cl,
                                                scale=ts, **kw)
            else:
                jq_, js = jax.jit(jkv.fill_chunk_global_at,
                                  static_argnames="kv_quant")(
                    jq_, jnp.asarray(chunk), jnp.asarray(1),
                    jnp.asarray(slot), jnp.asarray(page0), jnp.asarray(cl),
                    scale=js, **kw)
                tkv.fill_chunk_global_at(tq_, _t(chunk), 1, slot, page0, cl,
                                         scale=ts, **kw)
        assert _same(tq_, jq_) and _same(ts, js), shared
        assert not np.array_equal(ts.numpy(), s0)


# ---------------------------------------------------------------------------
# aliasing: inactive rows must not requantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_inactive_row_aliasing_an_active_page_keeps_its_tokens(fmt):
    """Row 0 (active) appends token 5 into page 9; row 1 (inactive) has a
    stale table entry naming the same page at slot 2.  Requantizing row 1
    too would zero page 9's tokens 3..5, row 0's among them."""
    r = np.random.default_rng(5)
    x = r.standard_normal((L, K, P_TOTAL, T, DH)).astype(np.float32)
    x[:, :, 9, 5:] = 0.0                   # page 9 holds tokens 0..4
    q0, s0 = tq.quantize_kv_page(_t(x), fmt)
    phys, slot = torch.tensor([9, 9]), torch.tensor([5, 2])
    val = torch.from_numpy(r.standard_normal((2, K, DH)).astype(np.float32))
    pool, scale = q0.clone(), s0.clone()
    tkv.append_token_quant_shared(pool, scale, 0, phys, slot, val, fmt,
                                  rows=torch.tensor([True, False])
                                  .nonzero()[:, 0])
    # what row 0 alone writes
    want_q, want_s = q0.clone(), s0.clone()
    tkv.append_token_quant_shared(want_q, want_s, 0, phys[:1], slot[:1],
                                  val[:1], fmt)
    assert torch.equal(pool, want_q) and torch.equal(scale, want_s)
    page = tq.dequantize_kv_page(pool[0, :, 9], scale[0, :, 9], fmt)
    tol = 0.6 * float(scale[0, :, 9].max())       # half a code step
    torch.testing.assert_close(page[:, :5], _t(x)[0, :, 9, :5], atol=tol,
                               rtol=0)
    torch.testing.assert_close(page[:, 5], val[0], atol=tol, rtol=0)
    assert bool((page[:, 3:6].abs().amax(-1) > 0).all())
