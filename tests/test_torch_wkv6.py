"""PyTorch port: the RWKV6 wkv recurrence (`repro_torch.kernels.wkv6`)
against the reference's on the same numpy inputs.

The plain versions are held against the reference's chunked form (the
reference's own CPU path), its recurrence and its Pallas kernel in
interpret mode, over the reference's SWEEP shapes
(`tests/test_kernels_wkv6.py`), with the decays drawn as the reference
draws them.  Tolerances (atol = rtol): the two recurrences 1e-5, the
same arithmetic in another framework (measured <= 6.1e-6); any chunked
form against any other form 5e-4, the reference's own tolerance for its
two forms.  Two chunked forms differ by more than two recurrences
(measured <= 1.1e-4): their factors e^{cum_excl} and e^{-cum} reach
e^{±65}, so the last-bit differences of torch's and XLA's cumsum and exp
(~|cum|·eps relative) are scaled up inside the products.

Also pinned: the reference's chunked factorization overflows at strong
decay (ROADMAP §C), and the port's plain copy with it — at logw = -3.0
both turn non-finite in the same places, where the recurrence is finite;
the dispatch by device and the chunk clamp of `wkv6`; the state carried
across a split sequence.  Kernel B5 itself is held against these plain
versions on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

`wkv_chunk_parallel`, the plain version of B5's own split (pivoted local
pass, carry, correction), is held against the reference's recurrence at
2e-5 — its float64 decay scan keeps it within 1e-5 on these inputs
(measured <= 9.7e-6), where a float32 scan reaches 8.8e-5 on SWEEP's
(1, 128, 4, 64) — including logw -3.0 to -4.05, where the reference's
chunked form overflows; against the reference's Pallas kernel in
interpret mode at 5e-4, the tolerance between chunked forms; at weak
decay too, where the state carries across chunks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import wkv6 as twkv
from repro_torch.kernels.wkv6 import ops as tops

torch.set_num_threads(2)

SWEEP = [
    # B, S, H, dh, chunk  (the reference's sweep)
    (2, 77, 3, 32, 32),
    (1, 64, 2, 64, 16),
    (3, 33, 1, 16, 32),
    (1, 128, 4, 64, 32),
]
EXACT = dict(atol=1e-5, rtol=1e-5)
FORMS = dict(atol=5e-4, rtol=5e-4)
PIVOTED = dict(atol=2e-5, rtol=2e-5)    # chunk-parallel vs the recurrence


def _inputs(B, S, H, dh, seed=1, logw=None):
    """r, k, v, logw, u, s0 as numpy float32, decays as the reference's
    tests draw them (-0.05 - 4·sigmoid(N(0, 1))) unless a constant is
    given."""
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    if logw is None:
        z = g.standard_normal((B, S, H, dh))
        lw = (-0.05 - 4.0 / (1.0 + np.exp(-z))).astype(np.float32)
    else:
        lw = np.full((B, S, H, dh), logw, np.float32)
    u = (g.standard_normal((H, dh)) * 0.5).astype(np.float32)
    s0 = (g.standard_normal((B, H, dh, dh)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("reference", ["chunked", "recurrent", "interpret"])
def test_plain_chunked_matches_reference(case, reference):
    B, S, H, dh, chunk = case
    x = _inputs(B, S, H, dh)
    got = twkv.wkv_chunked(*_t(x), chunk=chunk)
    if reference == "chunked":
        want = jrwkv.wkv_chunked(*_j(x), chunk=chunk)
    elif reference == "recurrent":
        want = jrwkv.wkv_recurrent(*_j(x))
    else:
        want = jwkv6(*_j(x), impl="interpret", chunk=chunk)
    assert got[0].shape == (B, S, H, dh) and got[1].shape == (B, H, dh, dh)
    _close(got, want, **FORMS)


@pytest.mark.parametrize("case", SWEEP)
def test_plain_recurrent_matches_reference(case):
    B, S, H, dh, _ = case
    x = _inputs(B, S, H, dh, seed=2)
    _close(twkv.wkv_recurrent(*_t(x)), jrwkv.wkv_recurrent(*_j(x)), **EXACT)


@settings(max_examples=10, deadline=None)
@given(s=st.integers(3, 90), seed=st.integers(0, 999))
def test_state_chaining_property(s, seed):
    """Splitting a sequence at any point and chaining states == one shot
    (the engine's decode after a prefill does exactly this)."""
    r, k, v, lw, u, s0 = _t(_inputs(1, s, 2, 16, seed))
    o_full, s_full = twkv.wkv_recurrent(r, k, v, lw, u, s0)
    cut = max(1, s // 3)
    o1, sm = twkv.wkv_chunked(r[:, :cut], k[:, :cut], v[:, :cut],
                              lw[:, :cut], u, s0, chunk=16)
    o2, s2 = twkv.wkv_chunked(r[:, cut:], k[:, cut:], v[:, cut:],
                              lw[:, cut:], u, sm, chunk=16)
    _close((torch.cat([o1, o2], 1), s2), (o_full, s_full), **FORMS)


@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 65])
def test_ragged_tail_state_is_after_the_last_valid_token(S):
    """A ragged S is zero-padded to the chunk: the padding (logw = 0,
    k = 0) leaves the state unchanged, so the returned state is the one
    after token S - 1, and the outputs stop at S."""
    x = _t(_inputs(2, S, 3, 32, seed=3))
    out, sT = twkv.wkv_chunked(*x)
    o_rec, s_rec = twkv.wkv_recurrent(*x)
    assert out.shape == (2, S, 3, 32)
    _close((out, sT), (o_rec, s_rec), **FORMS)


def test_chunk_is_clamped_at_32_for_the_kernel(monkeypatch):
    """`wkv6` hands the kernel min(chunk, 32), as the reference's ops
    clamps its TPU kernel's chunk; the plain chunked form takes the chunk
    it is given, as the reference's does."""
    seen = []

    def fake_kernel(r, k, v, logw, u, state, *, chunk):
        seen.append(chunk)
        return twkv.wkv_chunked(r, k, v, logw, u, state, chunk=chunk)

    monkeypatch.setattr(tops, "wkv6_cuda", fake_kernel)
    x = _inputs(1, 128, 4, 64)
    got = twkv.wkv6(*_t(x), impl="cuda", chunk=128)
    twkv.wkv6(*_t(x), impl="cuda", chunk=16)
    assert seen == [32, 16]
    _close(got, jwkv6(*_j(x), impl="interpret", chunk=128), **FORMS)


@pytest.mark.parametrize("S", [2, 77])
def test_plain_chunked_bf16_inputs_match_reference(S):
    """r/k/v/logw in the bf16 activation dtype: both plain chunked forms
    upcast to float32 inside, so they see the same bf16-rounded inputs.
    The output is rounded to bf16 on both sides, so a value that the two
    float32 results straddle a rounding boundary of lands one bf16 ulp
    (2^-7 relative) apart: within that plus the float32 tolerance between
    two chunked forms; the float32 state within the latter."""
    x = _inputs(2, S, 3, 32, seed=6)
    jx = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in x[:4]) \
        + tuple(jnp.asarray(a) for a in x[4:])
    tx = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in x[:4]) \
        + tuple(torch.from_numpy(a) for a in x[4:])
    out, sT = twkv.wkv_chunked(*tx)
    assert out.dtype == torch.bfloat16 and sT.dtype == torch.float32
    for want in (jrwkv.wkv_chunked(*jx), jwkv6(*jx, impl="interpret")):
        w_out = np.asarray(want[0].astype(jnp.float32))
        np.testing.assert_allclose(out.float().numpy(), w_out,
                                   atol=5e-4, rtol=2.0 ** -7 + 5e-4)
        np.testing.assert_allclose(sT.numpy(), np.asarray(want[1]), **FORMS)


def test_kernel_dispatch_upcasts_bf16_inputs(monkeypatch):
    """`wkv6` hands the kernel float32 r/k/v/logw (the kernel reads
    float32 only, as the reference's kernel upcasts inside) and returns
    the output in r's dtype."""
    seen = []

    def fake_kernel(r, k, v, logw, u, state, *, chunk):
        seen.append(tuple(a.dtype for a in (r, k, v, logw, u, state)))
        return twkv.wkv_chunked(r, k, v, logw, u, state, chunk=chunk)

    monkeypatch.setattr(tops, "wkv6_cuda", fake_kernel)
    x = _inputs(1, 40, 2, 16, seed=7)
    tx = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in x[:4]) \
        + tuple(torch.from_numpy(a) for a in x[4:])
    out, sT = twkv.wkv6(*tx, impl="cuda")
    assert seen == [(torch.float32,) * 6]
    assert out.dtype == torch.bfloat16 and sT.dtype == torch.float32
    want = twkv.wkv_chunked(*tx)
    assert torch.equal(out, want[0]) and torch.equal(sT, want[1])


def test_cpu_tensors_take_the_plain_chunked_form():
    x = _t(_inputs(2, 40, 3, 32, seed=4))
    twkv.launches.reset()
    for got, want in ((twkv.wkv6(*x), twkv.wkv_chunked(*x)),
                      (twkv.wkv6(*x, impl="ref", chunk=16),
                       twkv.wkv_chunked(*x, chunk=16)),
                      (twkv.wkv6(*x, impl="recurrent"),
                       twkv.wkv_recurrent(*x))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert twkv.launches.value == 0
    with pytest.raises(ValueError, match="unknown impl"):
        twkv.wkv6(*x, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        twkv.wkv6(*x, impl="cuda")


@pytest.mark.parametrize("logw,finite", [(-2.0, True), (-3.0, False)])
def test_reference_factorization_fault_is_shared(logw, finite):
    """The chunked factorization e^{cum_excl}·e^{-cum} overflows float32
    once 31·|logw| nears 88 (ROADMAP §C).  At logw = -2.0 both chunked
    forms equal the recurrence; at -3.0 both turn non-finite in the same
    places while the recurrence stays finite — the port's plain copy
    keeps the reference's fault.  (What stays finite there need not agree:
    the reference's values next to the overflow are off by up to 2.0,
    the port's are not.)"""
    x = _inputs(1, 64, 2, 16, logw=logw)
    got = twkv.wkv_chunked(*_t(x))
    want = jrwkv.wkv_chunked(*_j(x))
    rec = jrwkv.wkv_recurrent(*_j(x))
    assert all(np.isfinite(np.asarray(a)).all() for a in rec)
    for g, w, r in zip(got, want, rec):
        g, w, r = g.numpy(), np.asarray(w), np.asarray(r)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        if finite:
            np.testing.assert_allclose(g, w, **FORMS)
            np.testing.assert_allclose(g, r, **FORMS)
    assert np.isfinite(got[0].numpy()).all() == finite


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("reference", ["recurrent", "interpret"])
def test_plain_chunk_parallel_matches_reference(case, reference):
    """B5's split in plain torch against the reference's recurrence (2e-5)
    and its Pallas kernel in interpret mode (5e-4: the kernel's own
    factorization errs by up to 9.7e-5 here)."""
    B, S, H, dh, chunk = case
    x = _inputs(B, S, H, dh)
    got = twkv.wkv_chunk_parallel(*_t(x), chunk=chunk)
    assert got[0].shape == (B, S, H, dh) and got[1].shape == (B, H, dh, dh)
    if reference == "recurrent":
        _close(got, jrwkv.wkv_recurrent(*_j(x)), **PIVOTED)
    else:
        _close(got, jwkv6(*_j(x), impl="interpret", chunk=chunk), **FORMS)


@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 64, 65, 96, 97])
def test_plain_chunk_parallel_ragged_tail(S):
    """Chunk seams and ragged tails: one chunk (folded with s0, no carry),
    exactly one, two and three chunks, one token past them."""
    x = _inputs(2, S, 3, 32, seed=3)
    got = twkv.wkv_chunk_parallel(*_t(x))
    assert got[0].shape == (2, S, 3, 32)
    _close(got, jrwkv.wkv_recurrent(*_j(x)), **PIVOTED)


@pytest.mark.parametrize("logw", [-3.0, -4.0, -4.05])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_plain_chunk_parallel_strong_decay(logw, dh):
    """Where the reference's chunked form overflows, the pivoted split
    stays finite and holds to the recurrence, at every head dim B5
    takes."""
    x = _inputs(1, 64, 2, dh, logw=logw)
    assert not np.isfinite(np.asarray(jrwkv.wkv_chunked(*_j(x))[0])).all()
    got = twkv.wkv_chunk_parallel(*_t(x))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close(got, jrwkv.wkv_recurrent(*_j(x)), **PIVOTED)


@pytest.mark.parametrize("logw", [-0.05, -0.5])
def test_plain_chunk_parallel_weak_decay(logw):
    """Weak decay: at logw = -0.05 a chunk's state keeps e^{-1.6} of the
    one before it, so the carry reaches back over many chunks (at the
    drawn decays e^{tot} ~ e^{-65} erases a state within a chunk)."""
    x = _inputs(1, 300, 2, 32, seed=8, logw=logw)
    got = twkv.wkv_chunk_parallel(*_t(x))
    _close(got, jrwkv.wkv_recurrent(*_j(x)), **PIVOTED)
    _close(got, jrwkv.wkv_chunked(*_j(x)), **FORMS)


@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_plain_chunk_parallel_chunk_sizes(chunk):
    """Any chunk computes the same function (the pivot row moves with
    it: row chunk/2 - 1, row 0 below 4)."""
    x = _inputs(2, 70, 3, 32, seed=5)
    got = twkv.wkv_chunk_parallel(*_t(x), chunk=chunk)
    _close(got, jrwkv.wkv_recurrent(*_j(x)), **PIVOTED)


def test_plain_chunk_parallel_carries_the_state():
    """Splitting a prompt and chaining the states == one shot, as the
    engine's decode after a prefill chains them."""
    r, k, v, lw, u, s0 = _t(_inputs(1, 90, 2, 16, seed=9))
    o1, sm = twkv.wkv_chunk_parallel(r[:, :41], k[:, :41], v[:, :41],
                                     lw[:, :41], u, s0)
    o2, s2 = twkv.wkv_chunk_parallel(r[:, 41:], k[:, 41:], v[:, 41:],
                                     lw[:, 41:], u, sm)
    want = twkv.wkv_recurrent(r, k, v, lw, u, s0)
    _close((torch.cat([o1, o2], 1), s2), want, **PIVOTED)
