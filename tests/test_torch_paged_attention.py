"""PyTorch port: paged decode attention (the CUDA kernel's plain version),
the LSE merge core and the chunk partial against the JAX reference, on
the same numpy inputs.  The JAX side runs both its jnp oracle
(impl="ref") and its Pallas kernel in interpret mode.

Tolerances are the reference's own: 2e-5 at float32 (kv8/kv4 codes are
contracted in float32 on both sides), 3e-2 for bf16 pools."""
import itertools
import os
import subprocess
import sys
from pathlib import Path

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


def _inputs(G, fmt, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, K * G, DH)).astype(np.float32)
    kd = r.standard_normal((B, K, NP, T, DH)).astype(np.float32)
    vd = r.standard_normal((B, K, NP, T, DH)).astype(np.float32)
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
    """Same codes and scales as the reference's page quantizer, and the
    kv4 nibble order (high nibble = even token, offset 8)."""
    x = np.random.default_rng(2).standard_normal((2, 3, 16, 32)) * 2
    x = x.astype(np.float32)
    jq, js = quantize_kv_page(jnp.asarray(x), fmt)
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
