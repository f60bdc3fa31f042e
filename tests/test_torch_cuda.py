"""PyTorch port on the card: the CUDA paged decode-attention kernels —
B1 over per-slot stripes, B2 over the shared pool through page tables —,
the quantized GEMV kernel B3, the flash-attention kernel B4 and the RWKV6
wkv kernel B5, against their plain torch versions, their launch counters
and their input checks.

Every test needs a CUDA device; the `cuda_device` fixture skips it where
`torch.cuda.is_available()` is False (decided inside the fixture, never
at import).  The card's machine has no jax, so run these without the
suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: 2e-5 (atol and rtol) for f32 pools and for kv8/kv4 (codes are
contracted in f32 on both sides), 3e-2 for bf16 pools, where the plain
version rounds q and p to bf16 and the kernel keeps them in f32.  A bf16
pool is also held at 2e-5 against the plain version on the same pages
upcast to f32, which is the kernel's own arithmetic.  B2 is held to the
same tolerances against `paged_attention_shared_ref`.  Both are swept
over every head dim they take and, with the cluster size S forced to 1,
2, 4 and 8, over walks whose valid tokens fall in one rank.

B3: W8A8 within 1e-6 x max|y| of the plain version (only the order of the
float32 scale multiplies differs); W4A16 within 4e-3 x max|y| of the plain
version (which rounds the product to bf16, as the reference's
`quant_gemv_ref` does) and within 1e-5 x max|y| of the TPU kernel's own
function, `f32(bf16(x) @ w4) * scale`, taken here in float64; both of its
paths (stream and tile, forced through `plan=`) on x rows off a 16-byte
boundary and on the ragged (130, 77), M at the recorded crossover +-1,
repeated launches bit-identical, and the split-D tickets left at zero.

B4: the reference's flash-attention tolerances, 2e-5 (f32) and 2e-2
(bf16), atol = rtol; a bf16 output also within one bf16 rounding (2^-8
relative) + 2e-5 of the plain version on the inputs upcast to f32, the
kernel's own arithmetic before its output is rounded.  Under the host's
plan and with every cluster size S forced through `plan=`, repeated
launches bit-identical.

B5: within 5e-4 of the plain chunked form and 1e-4 of the plain
recurrence and of the plain version of its own split (|a - b| / (1 + |b|),
`WKV_TOL`), out and state each, decays drawn as the reference's tests
draw them; at constant logw -3.0 to -4.05, where the plain chunked form
overflows, within 1e-4 of the recurrence.  bf16 inputs: the output
within one bf16 ulp (2^-7 relative) plus those tolerances, the float32
state within them.  Repeated launches give the same bits.

The reduced qwen1.5-0.5b splice server (head dim 32, which B4 pads inside
shared memory) serves the CPU server's greedy tokens on the card.

Window rings: B1 and B2 over ring pages, whose bases rotate with the
ring and hold -1e9 where a slot is empty, at every cluster size and
partition count, against the plain versions; B4 at gemma3-12b's head
shape over a window; the reduced gemma3-12b servers (stripe, shared,
splice, discrete, speculative) serve the CPU servers' greedy tokens.
"""
import itertools

import pytest
import torch

from repro_torch.core.quant import (quantize_activations_int8,
                                    quantize_kv_page, quantize_params,
                                    quantize_weight, unpack_int4)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_gemv as tqg

pytestmark = pytest.mark.cuda

TOL = {"f32": 2e-5, "bf16": 3e-2, "kv8": 2e-5, "kv4": 2e-5}
B, K, NP, T = 4, 3, 8, 16
LENGTHS = (128, 37, 1, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(fmt, G, dh, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, K * G, dh, generator=gen, device=dev)
    kd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    vd = torch.randn(B, K, NP, T, dh, generator=gen, device=dev)
    base = (torch.arange(NP, dtype=torch.int32, device=dev) * T)[None]
    base = base.repeat(B, 1)
    base[1, 5:] = -1
    length = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
        return q, kp, vp, base, length, ks, vs, fmt
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    return q, kd.to(dt), vd.to(dt), base, length, None, None, "none"


@pytest.mark.parametrize("fmt,G,dh,window,partitions", list(itertools.product(
    ("f32", "bf16", "kv8", "kv4"), (1, 3, 8), tpa.HEAD_DIMS, (None, 40),
    (1, 4))))
def test_kernel_matches_plain_version(cuda_device, fmt, G, dh, window,
                                      partitions):
    q, kp, vp, base, length, ks, vs, kvq = _inputs(fmt, G, dh, cuda_device)
    got = tpa.paged_attention_partial(q, kp, vp, base, length, window=window,
                                      kv_quant=kvq, k_scale=ks, v_scale=vs,
                                      partitions=partitions)
    torch.cuda.synchronize()
    want = tpa.paged_attention_partial_ref(q, kp, vp, base, length,
                                           window=window, kv_quant=kvq,
                                           k_scale=ks, v_scale=vs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[fmt], rtol=TOL[fmt])
    if fmt == "bf16":
        want32 = tpa.paged_attention_partial_ref(q, kp.float(), vp.float(),
                                                 base, length, window=window)
        for g, w in zip(got, want32):
            torch.testing.assert_close(g, w, atol=TOL["f32"],
                                       rtol=TOL["f32"])
    o, m, l = got                       # the all-masked row
    assert torch.all(o[3] == 0) and torch.all(l[3] == 0)
    assert torch.all(m[3] == -1e30)


def test_one_launch_per_call(cuda_device):
    q, kp, vp, base, length, *_ = _inputs("bf16", 1, 64, cuda_device)
    tpa.launches.reset()
    for p in (1, 4):
        tpa.paged_attention_partial(q, kp, vp, base, length, partitions=p)
    assert tpa.launches.value == 2


@pytest.mark.parametrize("bad", ["dh", "group", "dtype", "layout"])
def test_unsupported_inputs_raise(cuda_device, bad):
    dh = 48 if bad == "dh" else 64
    G = 9 if bad == "group" else 1
    q, kp, vp, base, length, *_ = _inputs("f32", G, dh, cuda_device)
    if bad == "dtype":
        kp, vp = kp.half(), vp.half()
    if bad == "layout":
        kp = kp.transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(q.reshape(B, K, G, dh), kp, vp, base, length)


@pytest.mark.parametrize("fmt,G,partitions", list(itertools.product(
    ("f32", "bf16", "kv8", "kv4"), (1, 4), (1, 4))))
def test_head_range_matches_plain_version(cuda_device, fmt, G, partitions):
    """B1 over one kv head of the pool at a time (`head0`, the discrete
    variant's launch): each against the plain version on that head's
    slice of the pool, and the heads side by side against one all-heads
    launch within 2e-5 (the two may take other cluster splits)."""
    dh = 128
    q, kp, vp, base, length, ks, vs, kvq = _inputs(fmt, G, dh, cuda_device)
    kw = dict(kv_quant=kvq, k_scale=ks, v_scale=vs, partitions=partitions)
    allh = tpa.paged_attention_partial(q, kp, vp, base, length, **kw)
    tpa.launches.reset()
    groups = [tpa.paged_attention_partial(
        q[:, i * G:(i + 1) * G].contiguous(), kp, vp, base, length,
        kv_heads=(i, 1), **kw) for i in range(K)]
    torch.cuda.synchronize()
    assert tpa.launches.value == K
    for i, got in enumerate(groups):
        sc = {} if ks is None else dict(k_scale=ks[:, i:i + 1],
                                        v_scale=vs[:, i:i + 1])
        want = tpa.paged_attention_partial_ref(
            q[:, i * G:(i + 1) * G], kp[:, i:i + 1], vp[:, i:i + 1], base,
            length, kv_quant=kvq, **sc)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=TOL[fmt], rtol=TOL[fmt])
    for j in range(3):
        torch.testing.assert_close(torch.cat([g[j] for g in groups], 1),
                                   allh[j], atol=2e-5, rtol=2e-5)


def test_head_range_outside_the_pool_raises(cuda_device):
    q, kp, vp, base, length, *_ = _inputs("f32", 1, 64, cuda_device)
    with pytest.raises(ValueError, match="outside"):
        tpa.paged_attention_cuda(q.reshape(B, K, 1, 64)[:, :2].contiguous(),
                                 kp, vp, base, length, head0=2)


# ---------------------------------------------------------------------------
# B2: the shared pool through page tables
# ---------------------------------------------------------------------------

P_TOTAL = B * NP + 7


def _shared_inputs(fmt, G, dh, dev, seed=0):
    """A pool larger than the tables need, tables that permute it, a row
    whose entries past its length name pages other rows own, an
    all-masked row (length 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, K * G, dh, generator=gen, device=dev)
    kd = torch.randn(K, P_TOTAL, T, dh, generator=gen, device=dev)
    vd = torch.randn(K, P_TOTAL, T, dh, generator=gen, device=dev)
    perm = torch.randperm(P_TOTAL, generator=torch.Generator().manual_seed(
        seed))[:B * NP]
    table = perm.reshape(B, NP).to(torch.int32).to(dev)
    table[2, 1:] = table[0, 1:]         # row 2 holds 1 token: stale entries
    table[3] = table[0]
    base = (torch.arange(NP, dtype=torch.int32, device=dev) * T)[None]
    base = base.repeat(B, 1).contiguous()
    length = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
        return q, kp, vp, table, base, length, ks, vs, fmt
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    return q, kd.to(dt), vd.to(dt), table, base, length, None, None, "none"


@pytest.mark.parametrize("fmt,G,dh,window,partitions", list(itertools.product(
    ("f32", "bf16", "kv8", "kv4"), (1, 3, 8), tpa.HEAD_DIMS, (None, 40),
    (1, 4))))
def test_shared_kernel_matches_plain_version(cuda_device, fmt, G, dh, window,
                                             partitions):
    q, kp, vp, table, base, length, ks, vs, kvq = _shared_inputs(
        fmt, G, dh, cuda_device)
    got = tpa.paged_attention_partial(q, kp, vp, base, length, window=window,
                                      kv_quant=kvq, k_scale=ks, v_scale=vs,
                                      page_table=table,
                                      partitions=partitions)
    torch.cuda.synchronize()
    want = tpa.paged_attention_shared_ref(q, kp, vp, table, base, length,
                                          window=window, kv_quant=kvq,
                                          k_scale=ks, v_scale=vs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[fmt], rtol=TOL[fmt])
    if fmt == "bf16":
        want32 = tpa.paged_attention_shared_ref(q, kp.float(), vp.float(),
                                                table, base, length,
                                                window=window)
        for g, w in zip(got, want32):
            torch.testing.assert_close(g, w, atol=TOL["f32"],
                                       rtol=TOL["f32"])
    o, m, l = got                       # the all-masked row
    assert torch.all(o[3] == 0) and torch.all(l[3] == 0)
    assert torch.all(m[3] == -1e30)


def test_shared_kernel_matches_stripe_kernel_on_identity_tables(cuda_device):
    """One body, two page policies: a shared pool whose tables are the
    identity stripes gives B1's result on the same pages, bit for bit."""
    q, kp, vp, base, length, *_ = _inputs("bf16", 4, 64, cuda_device)
    pool_k = kp.permute(1, 0, 2, 3, 4).reshape(K, B * NP, T, 64).contiguous()
    pool_v = vp.permute(1, 0, 2, 3, 4).reshape(K, B * NP, T, 64).contiguous()
    table = torch.arange(B * NP, dtype=torch.int32,
                         device=cuda_device).reshape(B, NP)
    stripe = tpa.paged_attention_partial(q, kp, vp, base, length,
                                         partitions=2)
    shared = tpa.paged_attention_partial(q, pool_k, pool_v, base, length,
                                         page_table=table, partitions=2)
    for a, b in zip(stripe, shared):
        assert torch.equal(a, b)


def test_shared_one_launch_per_call(cuda_device):
    q, kp, vp, table, base, length, *_ = _shared_inputs("bf16", 1, 64,
                                                        cuda_device)
    tpa.launches.reset()
    tpa.launches_shared.reset()
    for p in (1, 4):
        tpa.paged_attention_partial(q, kp, vp, base, length, page_table=table,
                                    partitions=p)
    assert tpa.launches_shared.value == 2
    assert tpa.launches.value == 0


@pytest.mark.parametrize("bad", ["cpu", "dh", "dtype", "pool_shape",
                                 "table_dtype", "table_layout", "scales"])
def test_shared_unsupported_inputs_raise(cuda_device, bad):
    dh = 48 if bad == "dh" else 64
    fmt = "kv8" if bad == "scales" else "f32"
    q, kp, vp, table, base, length, ks, vs, kvq = _shared_inputs(
        fmt, 1, dh, cuda_device)
    q4 = q.reshape(B, K, 1, dh)
    if bad == "cpu":
        q4, kp, vp, table, base, length = (t.cpu() for t in (
            q4, kp, vp, table, base, length))
    if bad == "dtype":
        kp, vp = kp.half(), vp.half()
    if bad == "pool_shape":
        kp = kp[:, :-1]
    if bad == "table_dtype":
        table = table.long()
    if bad == "table_layout":
        table = table.t().contiguous().t()
    if bad == "scales":
        ks = ks.t().contiguous().t()
    with pytest.raises(ValueError):
        tpa.paged_attention_shared_cuda(q4, kp, vp, table, base, length,
                                        kv_quant=kvq, k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# B1/B2 with the cluster size forced
# ---------------------------------------------------------------------------

SPLIT_NP = 32                       # 512 slots: a warp's ring turns over
SPLIT_LENGTHS = (512, 300, 1, 0, 20)


def _split_inputs(layout, fmt, dh, dev, seed):
    """Row 0 full, row 1 ragged with unwritten pages past page 20, row 2
    one token (all in rank 0 of every split), row 3 empty, row 4 within
    the first two pages; shared: tables permute a larger pool and row 2's
    entries past its token name row 0's pages."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B_, G, NP_ = len(SPLIT_LENGTHS), 4, SPLIT_NP
    q = torch.randn(B_, 2 * G, dh, generator=gen, device=dev)
    P_tot = B_ * NP_ + 9
    shape = (B_, 2, NP_, T, dh) if layout == "stripe" else (2, P_tot, T, dh)
    kd = torch.randn(shape, generator=gen, device=dev)
    vd = torch.randn(shape, generator=gen, device=dev)
    base = (torch.arange(NP_, dtype=torch.int32, device=dev) * T)[None]
    base = base.repeat(B_, 1).contiguous()
    base[1, 20:] = -1
    table = None
    if layout == "shared":
        perm = torch.randperm(P_tot, generator=torch.Generator()
                              .manual_seed(seed))[:B_ * NP_]
        table = perm.reshape(B_, NP_).to(torch.int32).to(dev)
        table[2, 1:] = table[0, 1:]
    length = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
        return q, kp, vp, table, base, length, ks, vs, fmt
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    return q, kd.to(dt), vd.to(dt), table, base, length, None, None, "none"


@pytest.mark.parametrize("layout,fmt,dh,split,window", list(
    itertools.product(("stripe", "shared"), ("f32", "bf16", "kv8", "kv4"),
                      tpa.HEAD_DIMS, tpa.SPLITS, (None, 100))))
def test_forced_split_matches_plain_version(cuda_device, layout, fmt, dh,
                                            split, window):
    """Every cluster size on every head dim: the S ranks' partials merged
    through distributed shared memory give the plain version's (o, m, l)
    per caller partition (2 here), rows whose tokens all fall in one
    rank and an all-masked row included."""
    q, kp, vp, table, base, length, ks, vs, kvq = _split_inputs(
        layout, fmt, dh, cuda_device, seed=dh + split)
    B_, H, _ = q.shape
    q4 = q.reshape(B_, 2, H // 2, dh).contiguous()
    kw = dict(window=window, kv_quant=kvq, k_scale=ks, v_scale=vs,
              partitions=2, split=split)
    if layout == "stripe":
        o, m, l = tpa.paged_attention_cuda(q4, kp, vp, base, length, **kw)
        want = tpa.paged_attention_partial_ref(
            q, kp, vp, base, length, window=window, kv_quant=kvq,
            k_scale=ks, v_scale=vs)
    else:
        o, m, l = tpa.paged_attention_shared_cuda(q4, kp, vp, table, base,
                                                  length, **kw)
        want = tpa.paged_attention_shared_ref(
            q, kp, vp, table, base, length, window=window, kv_quant=kvq,
            k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert o.shape == (B_, 2, 2, H // 2, dh)
    got = tpa.merge_partials(o, m, l, axis=2)
    got = (got[0].reshape(B_, H, dh), got[1].reshape(B_, H),
           got[2].reshape(B_, H))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[fmt], rtol=TOL[fmt])
    assert torch.all(o[3] == 0) and torch.all(l[3] == 0)
    assert torch.all(m[3] == -1e30)
    # row 2's one token lies in the first partition: the second is empty
    assert torch.all(m[2, :, 1] == -1e30) and torch.all(l[2, :, 1] == 0)


def test_split_does_not_change_the_stripe_result(cuda_device):
    """One function whatever S: the four cluster sizes agree with each
    other to float32 summation order."""
    q, kp, vp, _, base, length, *_ = _split_inputs("stripe", "bf16", 64,
                                                   cuda_device, seed=3)
    B_, H, dh = q.shape
    q4 = q.reshape(B_, 2, H // 2, dh).contiguous()
    outs = [tpa.paged_attention_cuda(q4, kp, vp, base, length, split=s)
            for s in tpa.SPLITS]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("split", [3, 16])
def test_unknown_split_raises(cuda_device, split):
    q, kp, vp, base, length, *_ = _inputs("f32", 1, 64, cuda_device)
    tpa.launches.reset()
    with pytest.raises(ValueError, match="split"):
        tpa.paged_attention_cuda(q.reshape(B, K, 1, 64), kp, vp, base,
                                 length, split=split)
    assert tpa.launches.value == 0


# ---------------------------------------------------------------------------
# B3: the quantized GEMV
# ---------------------------------------------------------------------------

GEMV_TOL = {"w8a8": 1e-6, "w4a16": 4e-3}
GEMV_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024), (4096, 14336),
               (14336, 4096), (130, 77), (256, 384)]


def _gemv_case(scheme, M, D, F, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(D, F, generator=gen, device=dev) / D ** 0.5
    x = torch.randn(M, D, generator=gen, device=dev)
    return x, quantize_weight(w, scheme)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("M", [1, 4, 8, 64, 70])
@pytest.mark.parametrize("D,F", GEMV_SHAPES)
def test_quant_gemv_matches_plain_version(cuda_device, scheme, M, D, F):
    x, qw = _gemv_case(scheme, M, D, F, cuda_device)
    tqg.launches.reset()
    got = tqg.quant_gemv(x, qw)
    torch.cuda.synchronize()
    assert tqg.launches.value == 1
    assert got.shape == (M, F) and bool(torch.isfinite(got).all())
    want = tqg.quant_gemv_ref(x, qw.q, qw.scale, scheme)
    assert _rel(got, want) <= GEMV_TOL[scheme]
    if scheme == "w4a16":
        tpu = ((x.to(torch.bfloat16).double() @ unpack_int4(qw.q).double())
               * qw.scale.double())
        assert _rel(got, tpu) <= 1e-5


def test_quant_gemv_reads_no_padding_rows(cuda_device):
    """The kernel's rows are the first M of a larger buffer: what lies
    past them (NaN here) must not reach the output."""
    x, qw = _gemv_case("w4a16", 64, 1024, 2816, cuda_device)
    buf = torch.full((80, 1024), float("nan"), device=cuda_device,
                     dtype=torch.bfloat16)
    buf[:64] = x.to(torch.bfloat16)
    got = tqg.quant_gemv_cuda(buf[:64], qw.q, qw.scale, "w4a16")
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got, tqg.quant_gemv_cuda(x.to(torch.bfloat16), qw.q, qw.scale,
                                 "w4a16"), atol=0, rtol=0)


def _tpu_function(x, qw):
    """The TPU kernel's W4A16 function, f32(bf16(x) @ w4) * scale, in
    float64."""
    return ((x.to(torch.bfloat16).double() @ unpack_int4(qw.q).double())
            * qw.scale.double())


def _hold_gemv(got, x, qw, scheme):
    assert bool(torch.isfinite(got).all())
    assert _rel(got, tqg.quant_gemv_ref(x, qw.q, qw.scale, scheme)) \
        <= GEMV_TOL[scheme]
    if scheme == "w4a16":
        assert _rel(got, _tpu_function(x, qw)) <= 1e-5


def _kernel_input(scheme, x):
    if scheme == "w8a8":
        return quantize_activations_int8(x)
    return x.to(torch.bfloat16), None


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("dM", [-1, 0, 1])
@pytest.mark.parametrize("D,F", [(1024, 2816), (130, 77), (8960, 2560)])
def test_quant_gemv_at_the_crossover(cuda_device, scheme, dM, D, F):
    """M one below, at and one above the largest M of the stream path:
    each takes the path the plan names and matches the plain version."""
    from repro_torch.kernels.quant_gemv.kernel import (STREAM_MAX_M,
                                                       choose_gemv_plan)
    M = STREAM_MAX_M + dM
    assert choose_gemv_plan(M, D, F, scheme).path == (
        "stream" if dM <= 0 else "tile")
    x, qw = _gemv_case(scheme, M, D, F, cuda_device)
    got = tqg.quant_gemv(x, qw)
    torch.cuda.synchronize()
    _hold_gemv(got, x, qw, scheme)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("M,D,F", [(4, 14336, 4096), (64, 14336, 4096),
                                   (70, 1024, 2816), (1, 130, 77)])
def test_quant_gemv_repeated_launches_are_bit_identical(cuda_device, scheme,
                                                        M, D, F):
    """The split-D partials are summed in split order by the last split,
    not by float atomics: five launches give the same bits."""
    x, qw = _gemv_case(scheme, M, D, F, cuda_device)
    xk, _ = _kernel_input(scheme, x)
    first = tqg.quant_gemv_cuda(xk, qw.q, qw.scale, scheme)
    for _ in range(4):
        assert torch.equal(tqg.quant_gemv_cuda(xk, qw.q, qw.scale, scheme),
                           first)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("path", ["stream", "tile"])
def test_quant_gemv_split_launch_leaves_tickets_at_zero(cuda_device, scheme,
                                                        path):
    from repro_torch.kernels.quant_gemv import kernel as k
    M, D, F = (4 if path == "stream" else 64), 4096, 1024
    plan = k.choose_gemv_plan(M, D, F, scheme, path=path)
    assert plan.splits > 1
    x, qw = _gemv_case(scheme, M, D, F, cuda_device)
    xk, _ = _kernel_input(scheme, x)
    got = tqg.quant_gemv_cuda(xk, qw.q, qw.scale, scheme, plan=plan)
    torch.cuda.synchronize()
    # the stream path's splits meet through tickets, the tile path's in a
    # thread-block cluster, which takes none
    assert plan.cluster == (path == "tile")
    stream = torch.cuda.current_stream(cuda_device)
    tickets = k._tickets.get((xk.device, stream.cuda_stream))
    assert path == "tile" or tickets is not None
    assert tickets is None or int(tickets.abs().sum()) == 0
    assert torch.equal(tqg.quant_gemv_cuda(xk, qw.q, qw.scale, scheme,
                                           plan=plan), got)


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
@pytest.mark.parametrize("path", ["stream", "tile"])
@pytest.mark.parametrize("M", [3, 64, 70])
@pytest.mark.parametrize("D,F", [(130, 77), (1024, 2816), (2560, 8960)])
@pytest.mark.parametrize("splits", [1, 3])
def test_quant_gemv_both_paths_take_misaligned_and_ragged_inputs(
        cuda_device, scheme, path, M, D, F, splits):
    """Each path, forced, on x whose rows start off a 16-byte boundary (a
    view one element into a wider buffer) and on the ragged (130, 77)."""
    from repro_torch.kernels.quant_gemv import kernel as k
    x, qw = _gemv_case(scheme, M, D, F, cuda_device)
    xk, xs = _kernel_input(scheme, x)
    wide = torch.zeros((M, D + 3), dtype=xk.dtype, device=cuda_device)
    wide[:, 1:D + 1] = xk
    view = wide[:, 1:D + 1]
    assert view.data_ptr() % 16 and view.stride(1) == 1
    plan = k.choose_gemv_plan(M, D, F, scheme, path=path)
    plan = plan._replace(splits=splits, grid=plan.grid[:2] + (splits,))
    got = tqg.quant_gemv_cuda(view, qw.q, qw.scale, scheme, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, tqg.quant_gemv_cuda(xk.contiguous(), qw.q,
                                                qw.scale, scheme, plan=plan))
    _hold_gemv(got if xs is None else got * xs, x, qw, scheme)


def test_quant_gemv_expert_batched_weight_raises(cuda_device):
    w = torch.randn(2, 64, 32, device=cuda_device)
    qw = quantize_weight(w, "w8a8")
    tqg.launches.reset()
    with pytest.raises(NotImplementedError, match="A15"):
        tqg.quant_gemv(torch.randn(4, 64, device=cuda_device), qw)
    assert tqg.launches.value == 0


@pytest.mark.parametrize("bad", ["cpu", "x_dtype", "q_dtype", "q_shape",
                                 "q_layout", "scale_dtype"])
def test_quant_gemv_unsupported_inputs_raise(cuda_device, bad):
    x, qw = _gemv_case("w8a8", 4, 256, 128, cuda_device)
    xq = x.to(torch.int8)
    q, scale = qw.q, qw.scale
    if bad == "cpu":
        xq, q, scale = xq.cpu(), q.cpu(), scale.cpu()
    if bad == "x_dtype":
        xq = x
    if bad == "q_dtype":
        q = q.to(torch.uint8)
    if bad == "q_shape":
        q = q[:-4]
    if bad == "q_layout":
        q = q.t().contiguous().t()
    if bad == "scale_dtype":
        scale = scale.double()
    with pytest.raises(ValueError):
        tqg.quant_gemv_cuda(xq, q, scale, "w8a8")


@pytest.mark.parametrize("scheme", ["w4a16", "w8a8"])
def test_forward_launches_no_quant_gemv(cuda_device, scheme):
    """The reference forward stays kernel-free with quantized weights; a
    decode step of the engine launches B3 for wo, gate, up and down of
    every layer."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.models.registry import Model
    cfg = get_config("qwen1.5-0.5b").reduced()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = quantize_params(Model(cfg).init(gen), scheme)
    tokens = torch.randint(1, cfg.vocab_size, (2, 9), device=cuda_device)
    tqg.launches.reset()
    logits = Model(cfg).forward(params, {"tokens": tokens})
    assert bool(torch.isfinite(logits).all())
    assert tqg.launches.value == 0
    te = KVNANDEngine(cfg, EngineConfig(page_tokens=16,
                                        uniform_lengths=False),
                      device=cuda_device)
    cache = te.init_cache(2, 32)
    te.decode_step(params, cache, tokens[:, :1])
    torch.cuda.synchronize()
    assert tqg.launches.value == 4 * cfg.n_layers


# ---------------------------------------------------------------------------
# B4: flash attention (one-shot prefill)
# ---------------------------------------------------------------------------

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
# H, K, dh: qwen1.5-0.5b, llama3.1-8b, MQA, and the head dims B4 pads
# inside shared memory (32 of every reduced config, 112, 160, 256)
FLASH_HEADS = ((16, 16, 64), (32, 8, 128), (8, 1, 64), (4, 2, 32),
               (4, 2, 112), (4, 2, 160), (8, 4, 256))
# (B, Sq, Sk, q_offset): ragged prompts, and queries before or at the end
# of a longer key range
FLASH_LENGTHS = ((1, 1, 1, 0), (3, 70, 70, 0), (1, 255, 255, 0),
                 (3, 511, 511, 0), (1, 70, 255, 0), (1, 70, 255, 185))


def _flash_inputs(B, Sq, Sk, H, K, dh, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, n, dh, generator=gen, device=dev)
                 .to(dtype) for S, n in ((Sq, H), (Sk, K), (Sk, K)))


@pytest.mark.parametrize("fmt,heads,causal,window,lengths", list(
    itertools.product(("f32", "bf16"), FLASH_HEADS, (True, False),
                      (None, 16, 64), FLASH_LENGTHS)))
def test_flash_attention_matches_plain_version(cuda_device, fmt, heads,
                                               causal, window, lengths):
    (H, K, dh), (Bq, Sq, Sk, off) = heads, lengths
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    q, k, v = _flash_inputs(Bq, Sq, Sk, H, K, dh, dt, cuda_device)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tfa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=FLASH_TOL[fmt],
                               rtol=FLASH_TOL[fmt])
    if fmt == "bf16":
        w32 = tfa.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        bound = 2.0 ** -8 * w32.abs() + FLASH_TOL["f32"] * (1 + w32.abs())
        assert bool(((got.float() - w32).abs() <= bound).all())


@pytest.mark.parametrize("fmt,heads,split,causal,window,lengths", list(
    itertools.product(("f32", "bf16"), FLASH_HEADS, (1, 2, 4, 8),
                      (True, False), (None, 16), FLASH_LENGTHS)))
def test_flash_attention_forced_plan_matches_plain_version(
        cuda_device, fmt, heads, split, causal, window, lengths):
    """Every cluster size S forced through `plan=`, at every head dim
    (the padded ones through the split path too): within the same
    tolerances as the host's plan, and a repeated launch gives the same
    bits (the S partials merge in rank order)."""
    (H, K, dh), (Bq, Sq, Sk, off) = heads, lengths
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    q, k, v = _flash_inputs(Bq, Sq, Sk, H, K, dh, dt, cuda_device, seed=1)
    kw = dict(causal=causal, window=window, q_offset=off)
    plan = tfa.choose_flash_plan(Bq, Sq, Sk, H, causal, window, q_offset=off,
                                 dh=dh, dtype=dt, split=split)
    got = tfa.flash_attention_cuda(q, k, v, plan=plan, **kw)
    again = tfa.flash_attention_cuda(q, k, v, plan=plan, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = tfa.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=FLASH_TOL[fmt],
                               rtol=FLASH_TOL[fmt])
    if fmt == "bf16":
        w32 = tfa.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        bound = 2.0 ** -8 * w32.abs() + FLASH_TOL["f32"] * (1 + w32.abs())
        assert bool(((got.float() - w32).abs() <= bound).all())


@pytest.mark.parametrize("dh", [32, 112, 160, 256])
@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_flash_attention_split_path_at_padded_head_dims(cuda_device, dh,
                                                        fmt):
    """A B=1 short prompt, where the host splits the key range (S > 1),
    at each head dim B4 pads inside shared memory; the split result
    equals the plain version and does not depend on S beyond rounding."""
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    q, k, v = _flash_inputs(1, 256, 256, 4, 2, dh, dt, cuda_device, seed=2)
    plan = tfa.choose_flash_plan(1, 256, 256, 4, True, None, dh=dh, dtype=dt)
    assert plan.split > 1
    got = tfa.flash_attention_cuda(q, k, v, causal=True)
    one = tfa.flash_attention_cuda(q, k, v, causal=True,
                                   plan=plan._replace(split=1))
    torch.cuda.synchronize()
    want = tfa.flash_attention_ref(q, k, v, causal=True)
    for out in (got, one):
        torch.testing.assert_close(out, want, atol=FLASH_TOL[fmt],
                                   rtol=FLASH_TOL[fmt])


def test_flash_attention_bad_plan_raises(cuda_device):
    q, k, v = _flash_inputs(1, 16, 16, 4, 2, 64, torch.float32, cuda_device)
    plan = tfa.choose_flash_plan(1, 16, 16, 4, True, None, dh=128)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k, v, plan=plan)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k, v, plan=plan._replace(
            split=3, block_k=64))


def test_flash_attention_reads_strided_inputs(cuda_device):
    """q, k, v as views of head-major [B, heads, S, dh] tensors (and v of
    a fused QKV tensor): the kernel walks their strides, no copy."""
    q, k, v = _flash_inputs(2, 100, 100, 8, 2, 64, torch.float32,
                            cuda_device)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    ks = k.transpose(1, 2).contiguous().transpose(1, 2)
    fused = torch.cat([v, v], dim=2)[:, :, 2:]
    assert not qs.is_contiguous() and not fused.is_contiguous()
    got = tfa.flash_attention_cuda(qs, ks, fused, causal=True)
    want = tfa.flash_attention_cuda(q, k, v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_flash_attention_one_launch_per_call(cuda_device):
    q, k, v = _flash_inputs(1, 70, 70, 4, 2, 64, torch.float32, cuda_device)
    tfa.launches.reset()
    tfa.flash_attention(q, k, v)
    tfa.flash_attention(q, k, v, impl="ref")
    tfa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    tfa.flash_attention_cuda(q, k, v, causal=False, window=8)
    assert tfa.launches.value == 2


def test_flash_attention_padded_head_dim_keeps_its_scale(cuda_device):
    """dh 32 runs in the 64-wide instance and dh 160 in the 256-wide one:
    the softmax scale stays the unpadded dh^-0.5 (zero-padding q and k by
    hand and running the padded width gives the same output only with
    the scale of the true dh)."""
    for dh, wide in ((32, 64), (160, 256)):
        q, k, v = _flash_inputs(1, 40, 40, 4, 2, dh, torch.float32,
                                cuda_device)
        got = tfa.flash_attention_cuda(q, k, v, causal=True)
        pad = lambda t: torch.nn.functional.pad(t, (0, wide - dh))  # noqa
        padded = tfa.flash_attention_cuda(pad(q) * (wide / dh) ** 0.5,
                                          pad(k), pad(v), causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, padded[..., :dh], atol=2e-5,
                                   rtol=2e-5)
        torch.testing.assert_close(got, tfa.flash_attention_ref(
            q, k, v, causal=True), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bad", ["cpu", "dh", "dtype", "stride",
                                 "is_global", "tensor_offset", "window"])
def test_flash_attention_unsupported_inputs_raise(cuda_device, bad):
    dh = 48 if bad == "dh" else 64
    q, k, v = _flash_inputs(1, 16, 16, 4, 2, dh, torch.float32, cuda_device)
    kw = {}
    err = ValueError
    if bad == "cpu":
        q, k, v = q.cpu(), k.cpu(), v.cpu()
        kw["impl"] = "cuda"
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    if bad == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    if bad == "is_global":
        kw.update(window=8, is_global=torch.tensor(True, device=q.device))
        err = NotImplementedError
    if bad == "tensor_offset":
        kw["q_offset"] = torch.tensor(3, device=q.device)
        err = NotImplementedError
    if bad == "window":
        kw["window"] = 0
    with pytest.raises(err):
        tfa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("arch,d_head", [("qwen1.5-0.5b", 64),
                                         ("llama3.1-8b", 64),
                                         ("qwen1.5-0.5b", 32)])
def test_prefill_launches_b4_once_per_layer(cuda_device, arch, d_head):
    """`engine.prefill` on the card: one B4 launch per layer, logits and
    pools as the same prefill on the CPU.  The reduced config at its own
    head dim 32 and at 64, the width of the full-size archs."""
    import dataclasses
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.models.registry import Model
    cfg = dataclasses.replace(get_config(arch).reduced(), d_head=d_head)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    toks = torch.randint(1, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    tfa.launches.reset()
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, dev)
        e = KVNANDEngine(cfg, eng, device=dev)
        outs[dev] = e.prefill(p, {"tokens": toks.to(dev)}, 96, prompt_len=50)
    torch.cuda.synchronize()
    assert tfa.launches.value == cfg.n_layers
    (lc, cc), (lg, cg) = outs["cpu"], outs["cuda"]
    assert float((lg.cpu() - lc).abs().max() / lc.abs().max()) < 1e-4
    torch.testing.assert_close(cg.k_pages_g.cpu(), cc.k_pages_g, atol=1e-4,
                               rtol=1e-4)
    assert cg.lengths.tolist() == [50, 50]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# B5: the RWKV6 wkv recurrence
# ---------------------------------------------------------------------------

# B5 against the plain chunked form (the reference's factorization, whose
# e^{±65} factors amplify its own rounding: up to 2.6e-4 from the
# recurrence on chip_smoke.py's cases, so the reference's own 5e-4 between
# forms) and against the recurrence (B5's mid-chunk pivot keeps its factors
# small: within 4.6e-5 in a float32 emulation), |a - b| / (1 + |b|)
WKV_TOL = {"chunked": 5e-4, "recurrent": 1e-4}


def _wkv_inputs(B, S, H, dh, dev, seed=0, logw=None, zero_state=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, dh, generator=gen, device=dev)
               for _ in range(3))
    if logw is None:
        lw = -0.05 - 4.0 * torch.sigmoid(
            torch.randn(B, S, H, dh, generator=gen, device=dev))
    else:
        lw = torch.full((B, S, H, dh), float(logw), device=dev)
    u = torch.randn(H, dh, generator=gen, device=dev) * 0.5
    s0 = torch.randn(B, H, dh, dh, generator=gen, device=dev) * 0.1
    return r, k, v, lw, u, torch.zeros_like(s0) if zero_state else s0


def _wkv_err(got, want) -> float:
    return max(_wkv_errs(got, want))


def _wkv_errs(got, want) -> tuple:
    """(out, state) of max |a - b| / (1 + |b|)."""
    return tuple(float(((g.float() - w.float()).abs()
                        / (1 + w.float().abs())).max())
                 for g, w in zip(got, want))


def _wkv_within(got, want, tol):
    err_out, err_state = _wkv_errs(got, want)
    assert err_out <= tol, f"out {err_out:.3e} > {tol:.0e}"
    assert err_state <= tol, f"state {err_state:.3e} > {tol:.0e}"


@pytest.mark.parametrize("B,S,H,dh,zero_state", list(itertools.product(
    (1, 3), (1, 2, 31, 32, 33, 64, 65, 77, 300), (1, 5), (16, 32, 64),
    (False, True))))
def test_wkv6_matches_plain_versions(cuda_device, B, S, H, dh, zero_state):
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(B, S, H, dh, cuda_device, zero_state=zero_state)
    got = twkv.wkv6(*x)
    again = twkv.wkv6(*x)
    torch.cuda.synchronize()
    assert got[0].shape == (B, S, H, dh) and got[1].shape == (B, H, dh, dh)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _wkv_within(got, twkv.wkv_chunked(*x), WKV_TOL["chunked"])
    _wkv_within(got, twkv.wkv_recurrent(*x), WKV_TOL["recurrent"])
    _wkv_within(got, twkv.wkv_chunk_parallel(*x), WKV_TOL["recurrent"])


@pytest.mark.parametrize("logw", [-0.05, -0.5])
@pytest.mark.parametrize("dh", [16, 64])
def test_wkv6_weak_decay_carries_the_state(cuda_device, logw, dh):
    """At logw -0.05 a chunk's state keeps e^{-1.6} of the one before it,
    so the carry's decay reaches back over many chunks."""
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(2, 300, 3, dh, cuda_device, seed=dh, logw=logw)
    got = twkv.wkv6(*x)
    _wkv_within(got, twkv.wkv_recurrent(*x), WKV_TOL["recurrent"])
    _wkv_within(got, twkv.wkv_chunk_parallel(*x), WKV_TOL["recurrent"])
    _wkv_within(got, twkv.wkv_chunked(*x), WKV_TOL["chunked"])


def test_wkv6_long_prompt(cuda_device):
    """8192 tokens of one rwkv6-3b row: 256 chunks through the carry."""
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(1, 8192, 40, 64, cuda_device, seed=11)
    got = twkv.wkv6(*x)
    _wkv_within(got, twkv.wkv_recurrent(*x), WKV_TOL["recurrent"])
    _wkv_within(got, twkv.wkv_chunked(*x), WKV_TOL["chunked"])


@pytest.mark.parametrize("S,dh", [(2, 64), (77, 32), (300, 64)])
def test_wkv6_bf16_inputs_match_plain_version(cuda_device, S, dh):
    """r/k/v/logw in bf16, as an RWKV6 server with bf16 activations hands
    them over: `wkv6` upcasts them for B5, which reads float32, and
    returns bf16; held against the plain chunked form on the same bf16
    inputs (which upcasts inside as well)."""
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(2, S, 3, dh, cuda_device, seed=S)
    xb = tuple(a.to(torch.bfloat16) for a in x[:4]) + x[4:]
    twkv.launches.reset()
    out, sT = twkv.wkv6(*xb)
    torch.cuda.synchronize()
    assert twkv.launches.value == 1
    assert out.dtype == torch.bfloat16 and sT.dtype == torch.float32
    w_out, w_sT = twkv.wkv_chunked(*xb)
    bf16_ulp = 2.0 ** -7
    err = ((out.float() - w_out.float()).abs()
           / (WKV_TOL["chunked"] + (bf16_ulp + WKV_TOL["chunked"])
              * w_out.float().abs()))
    assert float(err.max()) <= 1
    assert _wkv_err((sT,), (w_sT,)) <= WKV_TOL["chunked"]
    r_out, r_sT = twkv.wkv_recurrent(*(a.float() for a in xb[:4]), *xb[4:])
    assert _wkv_err((sT,), (r_sT,)) <= WKV_TOL["recurrent"]


@pytest.mark.parametrize("logw", [-3.0, -4.0, -4.05])
@pytest.mark.parametrize("S,dh", [(33, 16), (300, 64)])
def test_wkv6_strong_decay_matches_recurrence(cuda_device, logw, S, dh):
    """Where the plain chunked form overflows, B5 stays finite and holds
    to the recurrence."""
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(2, S, 3, dh, cuda_device, logw=logw)
    got = twkv.wkv6(*x)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(twkv.wkv_chunked(*x)[0]).all())
    assert _wkv_err(got, twkv.wkv_recurrent(*x)) <= WKV_TOL["recurrent"]


@pytest.mark.parametrize("chunk", [1, 7, 16, 32, 64])
def test_wkv6_chunk_sizes(cuda_device, chunk):
    """Any chunk up to 32 computes the same function; 64 is clamped."""
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(2, 70, 3, 32, cuda_device)
    got = twkv.wkv6(*x, chunk=chunk)
    _wkv_within(got, twkv.wkv_recurrent(*x), WKV_TOL["recurrent"])
    _wkv_within(got, twkv.wkv_chunk_parallel(*x, chunk=min(chunk, 32)),
                WKV_TOL["recurrent"])


def test_wkv6_reads_strided_inputs(cuda_device):
    """r/k/v as views of one fused [B, S, H, 3·dh] projection, logw of a
    head-major tensor: the kernel walks their strides, no copy."""
    from repro_torch.kernels import wkv6 as twkv
    r, k, v, lw, u, s0 = _wkv_inputs(2, 45, 3, 64, cuda_device)
    fused = torch.cat([r, k, v], dim=3)
    rs, ks, vs = fused[..., :64], fused[..., 64:128], fused[..., 128:]
    lws = lw.transpose(1, 2).contiguous().transpose(1, 2)
    assert not rs.is_contiguous() and not lws.is_contiguous()
    got = twkv.wkv6_cuda(rs, ks, vs, lws, u, s0)
    want = twkv.wkv6_cuda(r, k, v, lw, u, s0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_wkv6_reads_rows_off_16_byte_boundaries(cuda_device):
    """Rows of r/k/v/logw that do not start 16-byte aligned (a row stride
    of 3·dh + 1 floats) are staged by 4-byte copies, with the same bits
    as the aligned tensors."""
    from repro_torch.kernels import wkv6 as twkv
    r, k, v, lw, u, s0 = _wkv_inputs(2, 45, 3, 32, cuda_device)
    wide = torch.zeros(2, 45, 3, 4 * 32 + 1, device=cuda_device)
    views = []
    for i, t in enumerate((r, k, v, lw)):
        sl = wide[..., 1 + 32 * i:1 + 32 * (i + 1)]
        sl.copy_(t)
        views.append(sl)
    assert views[0].data_ptr() % 16 != 0
    got = twkv.wkv6_cuda(*views, u, s0)
    want = twkv.wkv6_cuda(r, k, v, lw, u, s0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_wkv6_one_launch_per_call(cuda_device):
    from repro_torch.kernels import wkv6 as twkv
    x = _wkv_inputs(1, 40, 2, 32, cuda_device)
    twkv.launches.reset()
    twkv.wkv6(*x)
    twkv.wkv6(*x, impl="ref")
    twkv.wkv6(*x, impl="recurrent")
    twkv.wkv6(*(a.cpu() for a in x))
    twkv.wkv6_cuda(*x, chunk=8)
    assert twkv.launches.value == 2


@pytest.mark.parametrize("bad", ["cpu", "dh", "dtype", "stride", "shape",
                                 "state", "chunk", "u"])
def test_wkv6_unsupported_inputs_raise(cuda_device, bad):
    from repro_torch.kernels import wkv6 as twkv
    dh = 128 if bad == "dh" else 32
    r, k, v, lw, u, s0 = _wkv_inputs(1, 16, 2, dh, cuda_device)
    kw = {}
    if bad == "cpu":
        r, k, v, lw, u, s0 = (a.cpu() for a in (r, k, v, lw, u, s0))
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    if bad == "stride":
        v = v.transpose(2, 3).contiguous().transpose(2, 3)
    if bad == "shape":
        lw = lw[:, :8]
    if bad == "state":
        s0 = s0.transpose(2, 3)
    if bad == "chunk":
        kw["chunk"] = 0
    if bad == "u":
        u = u[:1]
    with pytest.raises(ValueError):
        twkv.wkv6_cuda(r, k, v, lw, u, s0, **kw)


def test_rwkv_chunk_prefill_launches_b5_once_per_layer(cuda_device):
    """`engine.prefill_chunk` of an RWKV6 prompt on the card: one B5
    launch per layer, logits and state leaves as the same chunk on the
    CPU; a one-token prompt and the decode step launch none."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.engine import KVNANDEngine
    from repro_torch.kernels import wkv6 as twkv
    from repro_torch.models.registry import Model
    cfg = get_config("rwkv6-3b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    eng = EngineConfig(page_tokens=16, uniform_lengths=False,
                       kv_dtype="float32")
    toks = torch.randint(1, cfg.vocab_size, (1, 77),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    twkv.launches.reset()
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, dev)
        e = KVNANDEngine(cfg, eng, device=dev)
        cache = e.init_cache(2, 128)
        lg, cache = e.prefill_chunk(p, cache, {"tokens": toks.to(dev)}, 1, 0,
                                    77, first=True)
        e.prefill_chunk(p, cache, {"tokens": toks[:, :1].to(dev)}, 0, 0, 1,
                        first=True)
        e.decode_step(p, cache, toks[:, :2].t().to(dev))
        outs[dev] = (lg, cache)
    torch.cuda.synchronize()
    assert twkv.launches.value == cfg.n_layers
    (lc, cc), (lg, cg) = outs["cpu"], outs["cuda"]
    assert float((lg.cpu() - lc).abs().max() / lc.abs().max()) < 1e-4
    torch.testing.assert_close(cg.rwkv_state.cpu(), cc.rwkv_state, atol=1e-4,
                               rtol=1e-4)
    assert cg.lengths.tolist() == [2, 78]


# ---------------------------------------------------------------------------
# The reduced splice server (head dim 32) on the card
# ---------------------------------------------------------------------------

def test_reduced_splice_server_serves_the_cpu_tokens(cuda_device):
    """The reduced splice server on the card: every admit one B4 launch a
    layer at head dim 32, and the greedy tokens of the same server (the
    same weights, float32 pools) on the CPU."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.models.registry import Model
    from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                         ServerConfig)
    cfg = get_config("qwen1.5-0.5b").reduced()
    assert cfg.d_head == 32
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    prompts = [[(7 * i + 3 * j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((5, 23, 40, 64, 90))]
    outs = {}
    for dev in ("cpu", "cuda"):
        tfa.launches.reset()
        srv = KVNANDServer(ServerConfig(
            arch="qwen1.5-0.5b", reduced=True, batch_slots=2,
            max_context=128, device=dev, scheduler="splice",
            engine=EngineConfig(page_tokens=16, uniform_lengths=False,
                                kv_dtype="float32")),
            params=params if dev == "cpu" else _tree_to(params, dev))
        outs[dev] = srv.generate(prompts, SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    assert tfa.launches.value == srv.stats["admits"] * cfg.n_layers > 0
    for c, g in zip(outs["cpu"], outs["cuda"]):
        assert g.token_ids == c.token_ids and len(g.token_ids) == 8


def test_launch_serve_reduced_splice_completes(cuda_device, capsys):
    """`python -m repro_torch.launch.serve --reduced --scheduler splice`,
    in process, on the card (its default device)."""
    from repro_torch.launch.serve import serve
    tfa.launches.reset()
    outs = serve(["--reduced", "--scheduler", "splice", "--requests", "4",
                  "--max-new", "4"])
    assert len(outs) == 4 and all(len(o.token_ids) == 4
                                  for o in outs.values())
    assert tfa.launches.value > 0
    assert "tok/s on" in capsys.readouterr().out


@pytest.mark.parametrize("shared", [False, True], ids=["stripe", "shared"])
def test_reduced_discrete_spec_server_serves_the_cpu_tokens(cuda_device,
                                                            shared):
    """Reduced llama2-7b under the DSE's pick (discrete, kv8) on the card,
    sequential and with speculation_k = 3: B1 (or B2) launched once per
    kv head a layer a decode step, and the greedy tokens of the same
    servers on the CPU."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.models.registry import Model
    from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                         ServerConfig)
    cfg = get_config("llama2-7b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    prompts = [[7, 8, 9, 10] * 5, [(5 * j) % 300 + 1 for j in range(29)],
               [3, 1, 4]]
    counter = tpa.launches_shared if shared else tpa.launches
    outs = {}
    for dev in ("cpu", "cuda"):
        for spec in (0, 3):
            counter.reset()
            srv = KVNANDServer(ServerConfig(
                arch="llama2-7b", reduced=True, batch_slots=2,
                max_context=128, device=dev, speculation_k=spec,
                engine=EngineConfig(variant="discrete", kv_quant="kv8",
                                    page_tokens=16, uniform_lengths=False,
                                    shared_pool=shared)),
                params=params if dev == "cpu" else _tree_to(params, dev))
            outs[dev, spec] = srv.generate(prompts,
                                           SamplingParams(max_new_tokens=8))
            if dev == "cuda":
                torch.cuda.synchronize()
                steps = srv.stats["decode_steps"]
                assert counter.value == steps * cfg.n_layers * cfg.n_kv_heads
                assert (srv.stats["verify_steps"] > 0) == (spec > 0)
    want = [o.token_ids for o in outs["cpu", 0]]
    for key, got in outs.items():
        assert [o.token_ids for o in got] == want, key


# ---------------------------------------------------------------------------
# window rings
# ---------------------------------------------------------------------------

RING_NP, RING_WINDOW = 9, 128          # ceil(128 / 16) + 1 ring pages
# a row short of one page, one that fills 3 ring pages, one wrapped once
# in the middle of a page, one wrapped twice on a page boundary
RING_LENGTHS = (9, 40, 200, 305)


def _ring_inputs(layout, fmt, dh, dev, seed):
    """Ring pages with the bases a ring leaves after each row's length
    (`window_page_positions`: rotated, RING_EMPTY where never written);
    shared: the ring slots reach a permuted larger pool."""
    from repro_torch.core import paged_kv
    gen = torch.Generator(device=dev).manual_seed(seed)
    B_, G = len(RING_LENGTHS), 2
    q = torch.randn(B_, 4 * G, dh, generator=gen, device=dev)
    P_tot = B_ * RING_NP + 5
    shape = ((B_, 4, RING_NP, T, dh) if layout == "stripe"
             else (4, P_tot, T, dh))
    kd = torch.randn(shape, generator=gen, device=dev)
    vd = torch.randn(shape, generator=gen, device=dev)
    base = torch.stack([torch.as_tensor(paged_kv.window_page_positions(
        n, RING_NP, T)) for n in RING_LENGTHS]).to(dev)
    table = None
    if layout == "shared":
        perm = torch.randperm(P_tot, generator=torch.Generator()
                              .manual_seed(seed))[:B_ * RING_NP]
        table = perm.reshape(B_, RING_NP).to(torch.int32).to(dev)
    length = torch.tensor(RING_LENGTHS, dtype=torch.int32, device=dev)
    if fmt in ("kv8", "kv4"):
        kp, ks = quantize_kv_page(kd, fmt)
        vp, vs = quantize_kv_page(vd, fmt)
        return q, kp, vp, table, base, length, ks, vs, fmt
    dt = torch.float32 if fmt == "f32" else torch.bfloat16
    return q, kd.to(dt), vd.to(dt), table, base, length, None, None, "none"


@pytest.mark.parametrize("layout,fmt,dh,split,partitions", list(
    itertools.product(("stripe", "shared"), ("f32", "bf16", "kv8", "kv4"),
                      (64, 256), tpa.SPLITS, (1, 3))))
def test_ring_bases_match_plain_version(cuda_device, layout, fmt, dh, split,
                                        partitions):
    """The walk covers all NPw ring slots whatever their bases' order,
    skips the empty ones, and masks by the window: each partition's
    merged partial equals the plain version's over the same ring, and a
    partition holding no live page is the empty partial."""
    q, kp, vp, table, base, length, ks, vs, kvq = _ring_inputs(
        layout, fmt, dh, cuda_device, seed=dh + split)
    B_, H, _ = q.shape
    q4 = q.reshape(B_, 4, H // 4, dh).contiguous()
    kw = dict(window=RING_WINDOW, kv_quant=kvq, k_scale=ks, v_scale=vs,
              partitions=partitions, split=split)
    npp = RING_NP // partitions
    if layout == "stripe":
        o, m, l = tpa.paged_attention_cuda(q4, kp, vp, base, length, **kw)
    else:
        o, m, l = tpa.paged_attention_shared_cuda(q4, kp, vp, table, base,
                                                  length, **kw)
    torch.cuda.synchronize()
    for p in range(partitions):
        sl = slice(p * npp, (p + 1) * npp)
        if layout == "stripe":
            want = tpa.paged_attention_partial_ref(
                q, kp[:, :, sl], vp[:, :, sl], base[:, sl], length,
                window=RING_WINDOW, kv_quant=kvq,
                k_scale=None if ks is None else ks[:, :, sl],
                v_scale=None if vs is None else vs[:, :, sl])
        else:
            want = tpa.paged_attention_shared_ref(
                q, kp, vp, table[:, sl].contiguous(), base[:, sl], length,
                window=RING_WINDOW, kv_quant=kvq, k_scale=ks, v_scale=vs)
        got = (o[:, :, p].reshape(B_, H, dh), m[:, :, p].reshape(B_, H),
               l[:, :, p].reshape(B_, H))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=TOL[fmt], rtol=TOL[fmt])
        live = ((base[:, sl] >= 0) & (base[:, sl] + T - 1
                                      > length[:, None] - 1 - RING_WINDOW))
        for b in range(B_):
            if not live[b].any():
                assert torch.all(l[b, :, p] == 0)
                assert torch.all(m[b, :, p] == -1e30)
    # row 0's 9 tokens sit in ring slot 0 alone
    assert (base[0] >= 0).sum() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 1024, 100])
def test_flash_attention_at_the_gemma3_head_shape(cuda_device, dtype,
                                                  window):
    """B4 at gemma3-12b's heads (16 x 256, 8 kv heads) over a 2047-token
    bucket (1100 real tokens: the splice scheduler's admit) with the
    local layers' window, against the plain version."""
    q, k, v = _flash_inputs(1, 2047, 2047, 16, 8, 256, dtype, cuda_device)
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = tfa.flash_attention_ref(q, k, v, causal=True, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["stripe", "shared", "splice", "discrete",
                                  "spec"])
def test_reduced_window_server_serves_the_cpu_tokens(cuda_device, case):
    """Reduced gemma3-12b (a local layer over a 64-token window, then a
    global one) with kv8 pages on the card: the greedy tokens of the same
    server on the CPU, prompts wrapping the 80-token ring in prefill and
    in decode, B1 / B2 / B4 launched where the path takes them."""
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.models.registry import Model
    from repro_torch.serving.api import (KVNANDServer, SamplingParams,
                                         ServerConfig)
    cfg = get_config("gemma3-12b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    prompts = [[(7 * i + 3 * j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((5, 70, 90, 23))]
    eng = dict(page_tokens=16, uniform_lengths=False, kv_quant="kv8",
               shared_pool=case == "shared",
               variant="discrete" if case == "discrete" else "compact")
    counters = (tpa.launches, tpa.launches_shared, tfa.launches)
    outs = {}
    for dev in ("cpu", "cuda"):
        for c in counters:
            c.reset()
        srv = KVNANDServer(ServerConfig(
            arch="gemma3-12b", reduced=True, batch_slots=2,
            max_context=128, device=dev, engine=EngineConfig(**eng),
            scheduler="splice" if case == "splice" else "interleaved",
            speculation_k=3 if case == "spec" else 0),
            params=params if dev == "cpu" else _tree_to(params, dev))
        outs[dev] = srv.generate(prompts, SamplingParams(max_new_tokens=16))
    torch.cuda.synchronize()
    b1, b2, b4 = (c.value for c in counters)
    assert (b2 > 0 and b1 == 0) if case == "shared" else (b1 > 0 and b2 == 0)
    assert (b4 == srv.stats["admits"] * cfg.n_layers) if case == "splice" \
        else b4 == 0
    for c, g in zip(outs["cpu"], outs["cuda"]):
        assert g.token_ids == c.token_ids and len(g.token_ids) == 16
