"""PyTorch port: the sharded G2 dataflow (`core/seqpar.py`) on a
(data 2, model 4) mesh of eight CPU entries, each function held to the
reference's own on the same numpy arrays.

The reference side runs once, in one subprocess with 8 fake host
devices (`tests/_mp.py`): a module fixture writes every input to an npz,
the subprocess jits each reference function under its mesh and writes
every output to another npz, and each test compares the port's run on
the same inputs.

  * Ring attention: causal, window 40, non-causal, and window 40 with
    `is_global` (3e-5, the reference's own bound against flash).
  * The sharded stripe decode and its fused append (3e-5 on o, the
    appended pools bit-equal); the stripe decode at kv8 and kv4 (1e-5:
    the same codes, two summation orders) and `sharded_append_uniform`'s
    requantized pages and scales (codes within one step at a rounding
    tie, scales within 1e-6).
  * The shared-pool sharded decode over a permuted table (f32 and kv8,
    3e-5 / 1e-5) and `sharded_append_shared` (f32 bit-equal, kv8 as the
    stripe append).
  * `sharded_prefill_fill`, `sharded_window_fill` and `sharded_chunk_fill`
    (f32 bit-equal, kv8 as above) and `sharded_chunk_attention` (3e-5 on
    o and l).
  * `combine_partials` against `merge_partials` of both packages on the
    stacked partials, one page shard entirely empty (1e-6).
"""
import numpy as np
import pytest
import torch

from tests._mp import run_multidevice
from repro_torch.core import quant, seqpar
from repro_torch.distributed.sharding import Mesh, P, ShardedTensor, shard
from repro_torch.kernels.paged_attention.merge import NEG_INF, merge_partials

torch.set_num_threads(2)

MESH = Mesh(["cpu"] * 8, ("data", "model"), shape=(2, 4))
B, K, G, NP, T, dh, L = 4, 2, 3, 8, 16, 32, 2
H = K * G
RING = (4, 128, 6, 3, 32)          # B, S, H, K, dh
RING_CASES = [("causal", True, None, False), ("window40", True, 40, False),
              ("noncausal", False, None, False),
              ("global", True, 40, True)]
FILL = dict(L=2, B=4, K=2, NP=8, T=8, dh=16, S=50, S_ring=150)
CHUNK = dict(S=16, slot=2, layer=1, page0=2, q_start=40, n_q=12)


def _inputs():
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {}
    Bq, S, Hq, Kq, dq = RING
    x["rq"], x["rk"], x["rv"] = f(Bq, S, Hq, dq), f(Bq, S, Kq, dq), \
        f(Bq, S, Kq, dq)
    # stripe decode over 8 pages of 16 tokens
    x["kp"], x["vp"] = f(B, K, NP, T, dh), f(B, K, NP, T, dh)
    x["q"] = f(B, H, dh)
    x["base"] = np.broadcast_to((np.arange(NP) * T)[None], (B, NP)).astype(
        np.int32).copy()
    x["length"] = np.array([100, 37, 128, 1], np.int32)
    x["k1"], x["v1"] = f(B, K, dh), f(B, K, dh)
    x["phys"] = np.full(B, 5, np.int32)          # page 5: model shard 2
    x["slot"] = np.full(B, 7, np.int32)
    x["pool_k"], x["pool_v"] = f(L, B, K, NP, T, dh), f(L, B, K, NP, T, dh)
    for fmt in ("kv8", "kv4"):
        for n in ("kp", "vp", "pool_k", "pool_v"):
            c, s = quant.quantize_kv_page(torch.from_numpy(x[n]), fmt)
            x[f"{n}_{fmt}"], x[f"{n}_{fmt}_s"] = c.numpy(), s.numpy()
    # shared pool [K, P, T, dh] walked through a permuted table
    Pt = B * NP
    x["sk"], x["sv"] = f(K, Pt, T, dh), f(K, Pt, T, dh)
    x["table"] = r.permutation(Pt).reshape(B, NP).astype(np.int32)
    x["slen"] = np.array([7, 33, 64, 128], np.int32)
    for n in ("sk", "sv"):
        c, s = quant.quantize_kv_page(torch.from_numpy(x[n]), "kv8")
        x[f"{n}_kv8"], x[f"{n}_kv8_s"] = c.numpy(), s.numpy()
    x["spool_k"], x["spool_v"] = f(L, K, Pt, T, dh), f(L, K, Pt, T, dh)
    for n in ("spool_k",):
        c, s = quant.quantize_kv_page(torch.from_numpy(x[n]), "kv8")
        x[f"{n}_kv8"], x[f"{n}_kv8_s"] = c.numpy(), s.numpy()
    x["sphys"] = np.array([3, 11, 19, 30], np.int32)
    x["sslot"] = np.array([0, 5, 15, 2], np.int32)
    x["skn"] = f(B, K, dh)
    # fills
    F = FILL
    x["fkv"] = f(F["B"], F["S"], F["K"], F["dh"])
    x["fkv_ring"] = f(F["B"], F["S_ring"], F["K"], F["dh"])
    x["ckv"] = f(1, CHUNK["S"], F["K"], F["dh"])
    x["cq"] = f(1, CHUNK["n_q"], H, F["dh"])
    x["ckp"], x["cvp"] = (f(1, F["K"], F["NP"], F["T"], F["dh"])
                          for _ in range(2))
    return x


REF = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.sharding import make_mesh_compat
from repro.core import seqpar, paged_kv
from repro.kernels.paged_attention.ref import paged_chunk_attention_ref
mesh = make_mesh_compat((2, 4), ("data", "model"))
assert len(jax.devices()) == 8
x = dict(np.load(sys.argv[1]))
a = {k: jnp.asarray(v) for k, v in x.items()}
out = {}
kw = dict(batch_axes=("data",), page_axes=("model",))
with mesh:
    for name, causal, window, glob in %(ring)r:
        g = jnp.asarray(True) if glob else None
        out["ring_" + name] = jax.jit(lambda q, k, v: seqpar.ring_attention(
            q, k, v, mesh, causal=causal, window=window, is_global=g))(
            a["rq"], a["rk"], a["rv"])
    dec = lambda *z: seqpar.paged_decode_attention_sharded(*z, mesh, **kw)
    out["dec"] = jax.jit(dec)(a["q"], a["kp"], a["vp"], a["base"],
                              a["length"])
    o, nk, nv = jax.jit(lambda q, kp, vp, b, ln, k1, v1, ph, sl:
        seqpar.paged_decode_attention_sharded(
            q, kp, vp, b, ln, mesh, append=(k1, v1, ph, sl), **kw))(
        a["q"], a["kp"], a["vp"], a["base"], a["length"] + 0, a["k1"],
        a["v1"], a["phys"], a["slot"])
    out["dec_app"], out["dec_app_k"], out["dec_app_v"] = o, nk, nv
    nk, nv = jax.jit(lambda *z: seqpar.sharded_append_uniform(
        *z, mesh, **kw))(a["pool_k"], a["pool_v"], 1, a["k1"], a["v1"],
                         a["phys"], a["slot"])
    out["app_k"], out["app_v"] = nk, nv
    for fmt in ("kv8", "kv4"):
        out["dec_" + fmt] = jax.jit(lambda q, kp, vp, b, ln, ks, vs:
            seqpar.paged_decode_attention_sharded(
                q, kp, vp, b, ln, mesh, kv_quant=fmt, k_scale=ks,
                v_scale=vs, **kw))(
            a["q"], a["kp_" + fmt], a["vp_" + fmt], a["base"], a["length"],
            a["kp_%%s_s" %% fmt], a["vp_%%s_s" %% fmt])
        r = jax.jit(lambda kp, vp, ks, vs, k1, v1, ph, sl:
            seqpar.sharded_append_uniform(
                kp, vp, 1, k1, v1, ph, sl, mesh, k_scale=ks, v_scale=vs,
                kv_quant=fmt, **kw))(
            a["pool_k_" + fmt], a["pool_v_" + fmt], a["pool_k_%%s_s" %% fmt],
            a["pool_v_%%s_s" %% fmt], a["k1"], a["v1"], a["phys"], a["slot"])
        for n, v in zip(("k", "v", "ks", "vs"), r):
            out["app_%%s_%%s" %% (fmt, n)] = v
    sh = lambda *z, **k2: seqpar.paged_decode_attention_sharded_shared(
        *z, mesh, **kw, **k2)
    out["sdec"] = jax.jit(sh)(a["q"], a["sk"], a["sv"], a["table"],
                              a["base"], a["slen"])
    out["sdec_kv8"] = jax.jit(lambda *z: sh(
        *z[:6], kv_quant="kv8", k_scale=z[6], v_scale=z[7]))(
        a["q"], a["sk_kv8"], a["sv_kv8"], a["table"], a["base"], a["slen"],
        a["sk_kv8_s"], a["sv_kv8_s"])
    ok, ov = jax.jit(lambda kp, vp, kn, ph, sl: seqpar.sharded_append_shared(
        kp, vp, 1, kn, -kn, ph, sl, mesh, **kw))(
        a["spool_k"], a["spool_v"], a["skn"], a["sphys"], a["sslot"])
    out["sapp_k"], out["sapp_v"] = ok, ov
    r = jax.jit(lambda kp, ks, kn, ph, sl: seqpar.sharded_append_shared(
        kp, kp, 1, kn, kn, ph, sl, mesh, k_scale=ks, v_scale=ks,
        kv_quant="kv8", **kw))(
        a["spool_k_kv8"], a["spool_k_kv8_s"], a["skn"], a["sphys"],
        a["sslot"])
    out["sapp_kv8_k"], out["sapp_kv8_ks"] = r[0], r[2]
    F = %(fill)r
    C = %(chunk)r
    for fmt in ("none", "kv8"):
        Ts = F["T"]
        dt = jnp.float32 if fmt == "none" else jnp.int8
        pool = jnp.zeros((F["L"], F["B"], F["K"], F["NP"], Ts, F["dh"]), dt)
        scale = (None if fmt == "none" else
                 jnp.zeros((F["L"], F["B"], F["K"], F["NP"]), jnp.float32))
        for name, fn, kv in (("pfill", seqpar.sharded_prefill_fill, "fkv"),
                             ("wfill", seqpar.sharded_window_fill,
                              "fkv_ring")):
            r = jax.jit(lambda p, s, z: fn(p, z, 1, mesh, scale=s,
                                           kv_quant=fmt, **kw))(
                pool, scale, a[kv])
            r = (r,) if fmt == "none" else r
            for n, v in zip(("", "_s"), r):
                out["%%s_%%s%%s" %% (name, fmt, n)] = v
        r = jax.jit(lambda p, s, z: seqpar.sharded_chunk_fill(
            p, z, C["layer"], C["slot"], C["page0"], C["S"], mesh, scale=s,
            kv_quant=fmt, **kw))(pool, scale, a["ckv"])
        r = (r,) if fmt == "none" else r
        for n, v in zip(("", "_s"), r):
            out["cfill_%%s%%s" %% (fmt, n)] = v
    base = (jnp.arange(F["NP"], dtype=jnp.int32) * F["T"])[None]
    qp = C["q_start"] + jnp.arange(C["n_q"], dtype=jnp.int32)
    o, m, l = jax.jit(lambda *z: seqpar.sharded_chunk_attention(
        *z, mesh, page_axes=("model",)))(
        a["cq"], a["ckp"], a["cvp"], base, jnp.asarray(C["q_start"]), qp)
    out["catt_o"], out["catt_m"], out["catt_l"] = o, m, l
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("seqpar reference OK")
""" % {"ring": RING_CASES, "fill": FILL, "chunk": CHUNK}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqpar")
    x = _inputs()
    np.savez(d / "in.npz", **x)
    code = ("import sys; sys.argv[1:] = [%r, %r]\n"
            % (str(d / "in.npz"), str(d / "out.npz"))) + REF
    run_multidevice(code, timeout=400)
    return x, dict(np.load(d / "out.npz"))


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.assemble() if isinstance(got, ShardedTensor) else got
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def codes_close(got, want):
    """Quantized codes: equal but for a rounding tie (one code step)."""
    got = (got.assemble() if isinstance(got, ShardedTensor) else got).numpy()
    if got.dtype == np.uint8:       # kv4: compare both packed nibbles
        got = np.stack([got >> 4, got & 15])
        want = np.stack([want >> 4, want & 15])
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, diff.max()


@pytest.mark.parametrize("name,causal,window,glob", RING_CASES,
                         ids=[c[0] for c in RING_CASES])
def test_ring_attention(data, name, causal, window, glob):
    x, ref = data
    o = seqpar.ring_attention(t(x["rq"]), t(x["rk"]), t(x["rv"]), MESH,
                              causal=causal, window=window,
                              is_global=True if glob else None)
    close(o, ref["ring_" + name], 3e-5)


def test_sharded_stripe_decode_and_fused_append(data):
    x, ref = data
    a = {k: t(v) for k, v in x.items()}
    o = seqpar.paged_decode_attention_sharded(
        a["q"], a["kp"], a["vp"], a["base"], a["length"], MESH)
    close(o, ref["dec"], 3e-5)
    o, nk, nv = seqpar.paged_decode_attention_sharded(
        a["q"], a["kp"], a["vp"], a["base"], a["length"], MESH,
        append=(a["k1"], a["v1"], a["phys"], a["slot"]))
    close(o, ref["dec_app"], 3e-5)
    close(nk, ref["dec_app_k"], 0)
    close(nv, ref["dec_app_v"], 0)
    assert isinstance(nk, ShardedTensor) and len(nk.shards) == 8
    nk, nv = seqpar.sharded_append_uniform(
        a["pool_k"], a["pool_v"], 1, a["k1"], a["v1"], a["phys"], a["slot"],
        MESH)
    close(nk, ref["app_k"], 0)
    close(nv, ref["app_v"], 0)


@pytest.mark.parametrize("fmt", ["kv8", "kv4"])
def test_sharded_stripe_decode_quantized_and_requantizing_append(data, fmt):
    x, ref = data
    a = {k: t(v) for k, v in x.items()}
    o = seqpar.paged_decode_attention_sharded(
        a["q"], a["kp_" + fmt], a["vp_" + fmt], a["base"], a["length"], MESH,
        kv_quant=fmt, k_scale=a[f"kp_{fmt}_s"], v_scale=a[f"vp_{fmt}_s"])
    close(o, ref["dec_" + fmt], 1e-5)
    out = seqpar.sharded_append_uniform(
        a["pool_k_" + fmt], a["pool_v_" + fmt], 1, a["k1"], a["v1"],
        a["phys"], a["slot"], MESH, k_scale=a[f"pool_k_{fmt}_s"],
        v_scale=a[f"pool_v_{fmt}_s"], kv_quant=fmt)
    for got, n in zip(out, ("k", "v", "ks", "vs")):
        want = ref[f"app_{fmt}_{n}"]
        if n.endswith("s"):
            close(got, want, 1e-6)
        else:
            codes_close(got, want)
    # only page 5 of layer 1 moved
    moved = (out[0].assemble().numpy() != x["pool_k_" + fmt]).any(
        axis=(1, 2, 4, 5))
    assert moved[1, 5] and moved.sum() == 1


def test_shared_pool_sharded_decode_and_append(data):
    x, ref = data
    a = {k: t(v) for k, v in x.items()}
    o = seqpar.paged_decode_attention_sharded_shared(
        a["q"], a["sk"], a["sv"], a["table"], a["base"], a["slen"], MESH)
    close(o, ref["sdec"], 3e-5)
    o = seqpar.paged_decode_attention_sharded_shared(
        a["q"], a["sk_kv8"], a["sv_kv8"], a["table"], a["base"], a["slen"],
        MESH, kv_quant="kv8", k_scale=a["sk_kv8_s"], v_scale=a["sv_kv8_s"])
    close(o, ref["sdec_kv8"], 1e-5)
    ok, ov = seqpar.sharded_append_shared(
        a["spool_k"], a["spool_v"], 1, a["skn"], -a["skn"], a["sphys"],
        a["sslot"], MESH)
    close(ok, ref["sapp_k"], 0)
    close(ov, ref["sapp_v"], 0)
    # the replicas over `data` hold equal copies
    assert all(torch.equal(ok.local({"data": 0, "model": m}),
                           ok.local({"data": 1, "model": m}))
               for m in range(4))
    kp, _, ks, _ = seqpar.sharded_append_shared(
        a["spool_k_kv8"], a["spool_k_kv8"].clone(), 1, a["skn"], a["skn"],
        a["sphys"], a["sslot"], MESH, k_scale=a["spool_k_kv8_s"],
        v_scale=a["spool_k_kv8_s"].clone(), kv_quant="kv8")
    codes_close(kp, ref["sapp_kv8_k"])
    close(ks, ref["sapp_kv8_ks"], 1e-6)


@pytest.mark.parametrize("fmt", ["none", "kv8"])
@pytest.mark.parametrize("name", ["pfill", "wfill", "cfill"])
def test_sharded_fills(data, name, fmt):
    x, ref = data
    F, C = FILL, CHUNK
    dt = torch.float32 if fmt == "none" else torch.int8
    pool = torch.zeros((F["L"], F["B"], F["K"], F["NP"], F["T"], F["dh"]),
                       dtype=dt)
    scale = None if fmt == "none" else torch.zeros(
        (F["L"], F["B"], F["K"], F["NP"]))
    if name == "cfill":
        out = seqpar.sharded_chunk_fill(
            pool, t(x["ckv"]), C["layer"], C["slot"], C["page0"], C["S"],
            MESH, scale=scale, kv_quant=fmt)
        key = f"cfill_{fmt}"
    else:
        fn = (seqpar.sharded_prefill_fill if name == "pfill"
              else seqpar.sharded_window_fill)
        out = fn(pool, t(x["fkv" if name == "pfill" else "fkv_ring"]), 1,
                 MESH, scale=scale, kv_quant=fmt)
        key = f"{name}_{fmt}"
    if fmt == "none":
        close(out, ref[key], 0)
        return
    codes_close(out[0], ref[key])
    close(out[1], ref[key + "_s"], 1e-6)


def test_sharded_chunk_attention(data):
    x, ref = data
    F, C = FILL, CHUNK
    base = (torch.arange(F["NP"], dtype=torch.int32) * F["T"])[None]
    q_pos = C["q_start"] + torch.arange(C["n_q"], dtype=torch.int32)
    o, m, l = seqpar.sharded_chunk_attention(
        t(x["cq"]), t(x["ckp"]), t(x["cvp"]), base, C["q_start"], q_pos, MESH)
    close(o, ref["catt_o"], 3e-5)
    close(l, ref["catt_l"], 3e-5)
    close(m, ref["catt_m"], 3e-5)


def test_combine_partials_matches_merge_partials_with_an_empty_shard():
    """Page shard 2 (model index 2) holds no valid page: m = NEG_INF,
    l = 0; its weight is zero and the combine equals the stacked merge
    of either package."""
    from repro.kernels.paged_attention.merge import merge_partials as jmerge
    r = np.random.default_rng(3)
    o = r.standard_normal((4, B, H, dh)).astype(np.float32)   # per model
    m = r.standard_normal((4, B, H)).astype(np.float32)
    l = r.uniform(0.5, 3.0, (4, B, H)).astype(np.float32)
    m[2], l[2], o[2] = NEG_INF, 0.0, 0.0

    def sharded(a, spec):
        return ShardedTensor(MESH, spec, [
            torch.from_numpy(a[c["model"]][c["data"] * 2:(c["data"] + 1) * 2])
            for c in MESH.coords()])

    so, sm, sl = (sharded(a, s) for a, s in ((o, P("data", None, None)),
                                             (m, P("data", None)),
                                             (l, P("data", None))))
    got_o, got_m, got_l = seqpar.combine_partials_stats(so, sm, sl,
                                                        ("model",))
    want = merge_partials(*(torch.from_numpy(a) for a in (o, m, l)), axis=0)
    jwant = jmerge(o, m, l, axis=0)
    for g, w, jw in zip((got_o, got_m, got_l), want, jwant):
        close(g, w.numpy(), 1e-6)
        close(g, np.asarray(jw), 1e-6)
    assert torch.equal(seqpar.combine_partials(so, sm, sl, ("model",))
                       .assemble(), got_o.assemble())
    # every model shard of a data row holds the same combined result
    assert all(torch.equal(got_o.local({"data": d, "model": 0}),
                           got_o.local({"data": d, "model": k}))
               for d in range(2) for k in range(4))
    # shard() of a replicated spec and a split one agree with assemble
    assert torch.equal(shard(torch.from_numpy(o[0]), MESH,
                             P("data", None, None)).assemble(),
                       torch.from_numpy(o[0]))
