"""PyTorch port: paged decode attention (the CUDA kernel's plain version),
the LSE merge core and the chunk partial against the JAX reference, on
the same numpy inputs.  The JAX side runs both its jnp oracle
(impl="ref") and its Pallas kernel in interpret mode.  The head dims of
the port's wider configs (112 kimi-k2, 160 pixtral-12b, 256 gemma3-12b)
are held on both layouts, and `choose_split` (the cluster size that
splits each partition's walk inside the kernel launch) is pinned.

Tolerances are the reference's own: 2e-5 at float32 (kv8/kv4 codes are
contracted in float32 on both sides), 3e-2 for bf16 pools; the shared
pool 3e-5, as the reference's `test_shared_kernel_matches_gather_ref`."""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_kv_page
from repro.kernels.paged_attention import (merge_partials,
                                           paged_attention_partial,
                                           paged_chunk_attention)
from repro_torch.core import quant as tquant
from repro_torch.kernels import paged_attention as tpa

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, K, NP, T, DH = 4, 2, 8, 16, 32
LENGTHS = (128, 37, 1, 0)           # full, ragged, a single token, empty


def _inputs(G, fmt, seed=0, dh=DH):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, K * G, dh)).astype(np.float32)
    kd = r.standard_normal((B, K, NP, T, dh)).astype(np.float32)
    vd = r.standard_normal((B, K, NP, T, dh)).astype(np.float32)
    base = np.broadcast_to(np.arange(NP, dtype=np.int32) * T, (B, NP)).copy()
    base[1, 5:] = -1                # unwritten pages past row 1's length
    length = np.asarray(LENGTHS, np.int32)
    ks = vs = None
    if fmt in ("kv8", "kv4"):       # one set of codes + scales, both sides
        kd, ks = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(kd),
                                                          fmt))
        vd, vs = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(vd),
                                                          fmt))
    return q, kd, vd, base, length, ks, vs


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


SWEEP = list(itertools.product(("none", "kv8", "kv4"), (None, 24), (1, 4),
                               (1, 2, 4)))


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("fmt,window,partitions,G", SWEEP)
def test_decode_partial_matches_reference(fmt, window, partitions, G, impl):
    q, kp, vp, base, length, ks, vs = _inputs(G, fmt)
    jo = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(base),
        jnp.asarray(length), window=window, impl=impl, kv_quant=fmt,
        k_scale=_jnp(ks), v_scale=_jnp(vs), partitions=partitions,
        pages_per_block=2)
    to = tpa.paged_attention_partial(
        _t(q), _t(kp), _t(vp), _t(base), _t(length), window=window,
        kv_quant=fmt, k_scale=_t(ks), v_scale=_t(vs), partitions=partitions)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=2e-5)
    # the all-masked row: o = 0, m = NEG_INF, l = 0 — finite, never NaN
    o, m, l = to
    assert torch.all(o[3] == 0) and torch.all(l[3] == 0)
    assert torch.all(m[3] == -1e30)


WIDE = list(itertools.product(("none", "kv8", "kv4"), (112, 160, 256),
                              (1, 4, 8)))


@pytest.mark.parametrize("fmt,dh,G", WIDE)
def test_decode_partial_wide_heads_matches_reference(fmt, dh, G):
    """Head dims past 128, and 112 (3.5 x 32), through the stripe plain
    version, with a window and two partitions."""
    q, kp, vp, base, length, ks, vs = _inputs(G, fmt, seed=5, dh=dh)
    kw = dict(window=24, kv_quant=fmt, partitions=2)
    jo = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(base),
        jnp.asarray(length), impl="ref", k_scale=_jnp(ks), v_scale=_jnp(vs),
        **kw)
    to = tpa.paged_attention_partial(
        _t(q), _t(kp), _t(vp), _t(base), _t(length), k_scale=_t(ks),
        v_scale=_t(vs), **kw)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=2e-5)
    o, m, l = to
    assert o.shape == (B, K * G, dh)
    assert torch.all(o[3] == 0) and torch.all(m[3] == -1e30)


P_TOTAL = B * NP + 6


@pytest.mark.parametrize("fmt,dh,G", WIDE)
def test_shared_decode_partial_wide_heads_matches_reference(fmt, dh, G):
    """The same head dims through the shared pool: tables permute a
    larger pool, row 2's entries past its one token name row 0's pages,
    row 3 is all masked."""
    r = np.random.default_rng(6)
    q = r.standard_normal((B, K * G, dh)).astype(np.float32)
    kd = r.standard_normal((K, P_TOTAL, T, dh)).astype(np.float32)
    vd = r.standard_normal((K, P_TOTAL, T, dh)).astype(np.float32)
    table = r.permutation(P_TOTAL)[:B * NP].reshape(B, NP).astype(np.int32)
    table[2, 1:] = table[0, 1:]
    base = np.broadcast_to(np.arange(NP, dtype=np.int32) * T, (B, NP)).copy()
    length = np.asarray(LENGTHS, np.int32)
    ks = vs = None
    if fmt != "none":
        kd, ks = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(kd),
                                                          fmt))
        vd, vs = (np.asarray(a) for a in quantize_kv_page(jnp.asarray(vd),
                                                          fmt))
    kw = dict(window=24, kv_quant=fmt, partitions=2)
    jo = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(base),
        jnp.asarray(length), impl="ref", k_scale=_jnp(ks), v_scale=_jnp(vs),
        page_table=jnp.asarray(table), **kw)
    to = tpa.paged_attention_partial(
        _t(q), _t(kd), _t(vd), _t(base), _t(length), k_scale=_t(ks),
        v_scale=_t(vs), page_table=_t(table), **kw)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                                   rtol=3e-5)
    assert torch.all(to[0][3] == 0) and torch.all(to[1][3] == -1e30)


@pytest.mark.parametrize("ctas,tokens,sms,want", [
    (64, 512, 132, 2),        # the serving shape: B=4 x K=16, 32 pages
    (16, 512, 132, 8),        # one slot: capped at 8
    (256, 6400, 132, 1),      # the long shape (16 partitions) fills it
    (132, 64, 132, 1),        # a CTA for every SM already
    (100, 4096, 132, 1),      # a doubling would pass one CTA an SM
    (33, 4096, 132, 4),
    (4, 64, 132, 2),          # 64 token slots: two tiles, two CTAs
    (4, 48, 132, 1),          # under two tiles: no split
    (8, 16, 132, 1),          # under one tile
    (64, 512, 66, 1),         # a card half the size
])
def test_choose_split(ctas, tokens, sms, want):
    assert tpa.choose_split(ctas, tokens, sms) == want


@pytest.mark.parametrize("ctas", [1, 3, 16, 50, 64, 131, 132, 500])
@pytest.mark.parametrize("tokens", [16, 32, 64, 100, 512, 100_000])
def test_choose_split_bounds(ctas, tokens):
    """S is one of the kernel's cluster sizes, 1 where the grid fills the
    card, never past one CTA an SM once split, and never less than one
    32-slot tile a CTA once split."""
    s = tpa.choose_split(ctas, tokens)
    assert s in tpa.SPLITS and s <= 8
    if ctas >= 132:
        assert s == 1
    if s > 1:
        assert ctas * s <= 132 and tokens >= s * 32


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("partitions", [1, 4])
def test_decode_partial_bf16_pool(partitions, impl):
    q, kp, vp, base, length, _, _ = _inputs(2, "none", seed=1)
    jo, _, _ = paged_attention_partial(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(base), jnp.asarray(length),
        impl=impl, partitions=partitions, pages_per_block=2)
    to, _, _ = tpa.paged_attention_partial(
        _t(q), _t(kp, torch.bfloat16), _t(vp, torch.bfloat16), _t(base),
        _t(length), partitions=partitions)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("fmt", ["kv8", "kv4"])
def test_kv_page_codes_match(fmt):
    """Same codes and scales as the reference's page quantizer as it
    serves, under jit (where XLA computes amax / 7 as amax * (1 / 7)), and
    the kv4 nibble order (high nibble = even token, offset 8)."""
    x = np.random.default_rng(2).standard_normal((2, 3, 16, 32)) * 2
    x = x.astype(np.float32)
    jq, js = jax.jit(quantize_kv_page, static_argnums=1)(jnp.asarray(x), fmt)
    tq, ts = tquant.quantize_kv_page(torch.from_numpy(x), fmt)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tquant.dequantize_kv_page(tq, ts, fmt)
    if fmt == "kv4":
        un = tquant.unpack_int4_tokens(tq)
        assert torch.equal(un[..., 0::2, :], ((tq >> 4) & 0xF).to(
            torch.int8) - 8)
    assert float((deq - torch.from_numpy(x)).abs().max()) <= \
        float(ts.max()) * 0.5 + 1e-6


def test_merge_partials_matches_reference_and_empty_is_identity():
    r = np.random.default_rng(3)
    o = r.standard_normal((5, 3, 4, 8)).astype(np.float32)
    m = r.standard_normal((5, 3, 4)).astype(np.float32)
    l = r.uniform(0.5, 3, (5, 3, 4)).astype(np.float32)
    m[2], l[2], o[2] = -1e30, 0.0, 0.0          # one empty partial
    jt = merge_partials(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    tt = tpa.merge_partials(*(torch.from_numpy(a) for a in (o, m, l)))
    for t, j in zip(tt, jt):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6,
                                   rtol=2e-6)
    keep = [0, 1, 3, 4]                         # dropping it changes nothing
    tk = tpa.merge_partials(*(torch.from_numpy(a[keep]) for a in (o, m, l)))
    for a, b in zip(tt, tk):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # every partial empty: o = 0, l = 0
    e = tpa.merge_partials(torch.zeros(3, 2, 4), torch.full((3, 2), -1e30),
                           torch.zeros(3, 2))
    assert torch.all(e[0] == 0) and torch.all(e[2] == 0)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("partitions", [1, 4])
def test_chunk_partial_matches_reference(window, partitions):
    r = np.random.default_rng(4)
    S, G = 16, 2
    q = r.standard_normal((1, S, K * G, DH)).astype(np.float32)
    kp = r.standard_normal((1, K, NP, T, DH)).astype(np.float32)
    vp = r.standard_normal((1, K, NP, T, DH)).astype(np.float32)
    base = (np.arange(NP, dtype=np.int32) * T)[None]
    start = 48
    q_pos = start + np.arange(S, dtype=np.int32)
    jo = paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(base),
        jnp.asarray(start, jnp.int32), jnp.asarray(q_pos), window=window,
        partitions=partitions)
    to = tpa.paged_chunk_attention(
        _t(q), _t(kp), _t(vp), _t(base), start, _t(q_pos), window=window,
        partitions=partitions)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel wrapper raises on a CPU tensor instead of
    running the plain version."""
    q, kp, vp, base, length, _, _ = _inputs(1, "none")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(_t(q).reshape(B, K, 1, DH), _t(kp), _t(vp),
                                 _t(base), _t(length))


def test_port_imports_without_jax_nvcc_or_card():
    """The port imports with jax blocked and no CUDA toolkit on PATH, and
    importing builds nothing (the nvcc build is lazy)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._fns\n"
        "assert not any(k == 'repro' or k.startswith('repro.') "
        "for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
