"""PyTorch port: hymba's selective-SSM mixer (`repro_torch.models.ssm`)
against the reference's (`repro.models.ssm`) on the same numpy inputs.

Held: the causal conv with its carried tail, the chunked scan (S not a
multiple of the 64-token chunk, a nonzero initial state, the padded
steps that must keep the state), the whole mixer and the one-token
update, from the reference's initial parameters and from drawn ones
(nonzero `a_log`, a bias on Δ), with quantized projections too.  Outputs,
states and tails agree within 1e-5 relative (|diff|max / |ref|max; the
two frameworks' float32 matmuls and exps differ in the last bits).

A decay that underflows inside a chunk (a = exp(Δ·A) below float32's
smallest normal, down to 0) is held against the reference and a float64
step loop: the port composes decays only by multiplication, so the
state stays finite and exact where a form that divides by a cumulative
decay product would divide by 0.  The mixer over S tokens equals S
one-token updates, so a decode step continues a prefill exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.quant import quantize_params
from repro.models import ssm as jssm
from repro.models.layers import ParamBuilder
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)

TOL = 1e-5
ARCH = "hymba-1.5b"


def _rel(t, j):
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float32)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _params(seed=0, drawn=False, quant="none"):
    """(reference cfg, reference params, port cfg, port params) of one
    reduced hymba SSM block.  drawn=True gives nonzero a_log (decays of
    every strength) and a Δ bias, where the init has a_log = 0."""
    cfg = get_config(ARCH).reduced()
    b = ParamBuilder(jax.random.PRNGKey(seed))
    jssm.init_ssm(b, cfg)
    p = jax.tree.map(np.asarray, b.params)
    if drawn:
        g = np.random.default_rng(seed)
        p["a_log"] = g.uniform(-2.0, 2.0, p["a_log"].shape).astype(np.float32)
        p["w_dt_b"] = g.uniform(-1.0, 1.0, p["w_dt_b"].shape).astype(
            np.float32)
        p["conv_b"] = (g.standard_normal(p["conv_b"].shape) * 0.1).astype(
            np.float32)
    p = quantize_params(jax.tree.map(jnp.asarray, p), quant)
    return (cfg, p, tget(ARCH).reduced(),
            bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu"))


def _inputs(cfg, B, S, seed=1):
    g = np.random.default_rng(seed)
    D, N = cfg.d_model, cfg.ssm_state
    x = g.standard_normal((B, S, D)).astype(np.float32)
    h0 = (g.standard_normal((B, D, N)) * 0.5).astype(np.float32)
    tail = g.standard_normal((B, jssm.CONV_K - 1, D)).astype(np.float32)
    return x, h0, tail


@pytest.mark.parametrize("S", [1, 2, 7, 64])
def test_conv_with_tail_matches_reference(S):
    cfg, p, _, tp = _params(drawn=True)
    x, _, tail = _inputs(cfg, 2, S)
    jo, jt = jssm._conv(p, jnp.asarray(x), jnp.asarray(tail))
    to, tt = tssm._conv(tp, torch.from_numpy(x), torch.from_numpy(tail))
    assert _rel(to, jo) < TOL
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _scan_inputs(B, S, D, N, seed=2, strong=False):
    g = np.random.default_rng(seed)
    if strong:
        # Δ·A reaches -700: exp underflows to 0 inside every chunk
        dtA = -np.exp(g.uniform(-3.0, np.log(700.0), (B, S, D, N)))
    else:
        dtA = -np.exp(g.uniform(-6.0, 1.0, (B, S, D, N)))
    a = np.exp(dtA).astype(np.float32)
    bx = g.standard_normal((B, S, D, N)).astype(np.float32)
    C = g.standard_normal((B, S, N)).astype(np.float32)
    h0 = g.standard_normal((B, D, N)).astype(np.float32)
    return a, bx, C, h0


def _step_loop(a, bx, C, h0):
    """The recurrence token by token in float64."""
    h = h0.astype(np.float64)
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(np.einsum("bdn,bn->bd", h, C[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S", [1, 63, 64, 150, 200])
@pytest.mark.parametrize("strong", [False, True], ids=["mixed", "underflow"])
def test_selective_scan_matches_reference(S, strong):
    a, bx, C, h0 = _scan_inputs(2, S, 16, 8, strong=strong)
    if strong:
        tiny = np.finfo(np.float32).tiny
        assert (a == 0).any() and (a < tiny).mean() > 0.15
    jy, jh = jssm.selective_scan_chunked(*(jnp.asarray(v)
                                           for v in (a, bx, C, h0)))
    ty, th = tssm.selective_scan_chunked(*(torch.from_numpy(v)
                                           for v in (a, bx, C, h0)))
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    assert _rel(ty, jy) < TOL
    assert _rel(th, jh) < TOL
    ly, lh = _step_loop(a, bx, C, h0)
    assert _rel(ty, ly) < TOL
    assert _rel(th, lh) < TOL


def test_cumulative_product_form_fails_where_the_scan_holds():
    """Why the in-chunk scan composes instead of dividing: the form
    h_t = P_t · (h0 + Σ bx_s / P_s) with P_t = Π a_s turns non-finite once
    P underflows inside a chunk, on inputs the port's scan serves
    exactly."""
    a, bx, C, h0 = _scan_inputs(1, 64, 16, 8, strong=True)
    P = np.cumprod(a, axis=1, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        h = P * (h0[:, None] + np.cumsum(bx / P, axis=1, dtype=np.float32))
    assert not np.isfinite(h).all()
    ty, th = tssm.selective_scan_chunked(*(torch.from_numpy(v)
                                           for v in (a, bx, C, h0)))
    ly, lh = _step_loop(a, bx, C, h0)
    assert _rel(ty, ly) < TOL and _rel(th, lh) < TOL


@pytest.mark.parametrize("drawn", [False, True], ids=["init", "drawn"])
@pytest.mark.parametrize("S", [1, 37, 130])
def test_mixer_matches_reference(S, drawn):
    cfg, p, tcfg, tp = _params(drawn=drawn)
    x, h0, tail = _inputs(cfg, 2, S)
    jo, jh, jt = jssm.ssm_mixer(p, cfg, jnp.asarray(x), jnp.asarray(h0),
                                jnp.asarray(tail))
    to, th, tt = tssm.ssm_mixer(tp, tcfg, *(torch.from_numpy(v)
                                            for v in (x, h0, tail)))
    assert _rel(to, jo) < TOL
    assert _rel(th, jh) < TOL
    assert _rel(tt, jt) < TOL


@pytest.mark.parametrize("drawn", [False, True], ids=["init", "drawn"])
def test_decode_step_matches_reference(drawn):
    cfg, p, tcfg, tp = _params(drawn=drawn)
    x, h0, tail = _inputs(cfg, 3, 1)
    jo, jh, jt = jssm.ssm_decode_step(p, cfg, jnp.asarray(x),
                                      jnp.asarray(h0), jnp.asarray(tail))
    to, th, tt = tssm.ssm_decode_step(tp, tcfg, *(torch.from_numpy(v)
                                                  for v in (x, h0, tail)))
    assert _rel(to, jo) < TOL
    assert _rel(th, jh) < TOL
    assert _rel(tt, jt) < TOL


@pytest.mark.parametrize("quant", ["w4a16", "w8a8"])
def test_quantized_mixer_matches_reference(quant):
    """Quantized projections (the DSE's W4A16 pick; `w_dt` is a
    D x 1 weight, `w_b` / `w_c` D x N) through the plain B3 version."""
    cfg, p, tcfg, tp = _params(drawn=True, quant=quant)
    assert isinstance(tp["w_dt_w"], type(tp["in_x_w"]))
    assert "conv_w" in tp and isinstance(tp["conv_w"], torch.Tensor)
    x, h0, tail = _inputs(cfg, 2, 20)
    jo, jh, _ = jssm.ssm_mixer(p, cfg, jnp.asarray(x), jnp.asarray(h0),
                               jnp.asarray(tail))
    to, th, _ = tssm.ssm_mixer(tp, tcfg, *(torch.from_numpy(v)
                                           for v in (x, h0, tail)))
    # a quantized activation may round to the neighbouring code
    assert _rel(to, jo) < 2e-2
    assert _rel(th, jh) < 2e-2


def test_mixer_equals_token_by_token_updates():
    """Prefill then decode: the mixer over S tokens and S one-token
    updates from the same state and tail give the same outputs, state
    and tail."""
    _, _, tcfg, tp = _params(drawn=True)
    x, h0, tail = (torch.from_numpy(v) for v in _inputs(tcfg, 2, 70))
    out, h, t = tssm.ssm_mixer(tp, tcfg, x, h0, tail)
    hs, ts, outs = h0, tail, []
    for s in range(x.shape[1]):
        o, hs, ts = tssm.ssm_decode_step(tp, tcfg, x[:, s:s + 1], hs, ts)
        outs.append(o)
    assert _rel(torch.cat(outs, 1), out) < TOL
    assert _rel(hs, h) < TOL
    assert _rel(ts, t) < TOL       # one matmul over S rows vs S of one


def test_state_shape_and_init():
    cfg, p, tcfg, tp = _params()
    assert tssm.ssm_state_shape(tcfg, 3) == jssm.ssm_state_shape(cfg, 3)
    assert (tssm.CONV_K, tssm.CHUNK) == (jssm.CONV_K, jssm.CHUNK)
    from repro_torch.models.layers import ParamInit
    b = ParamInit(torch.Generator().manual_seed(0), "cpu")
    tssm.init_ssm(b, tcfg)
    assert sorted(b.params) == sorted(tp)
    for k, v in b.params.items():
        assert tuple(v.shape) == tuple(tp[k].shape), k
    assert (b.params["a_log"] == 0).all() and (b.params["d_skip"] == 1).all()
    assert (b.params["w_dt_b"] == 0).all() and (b.params["conv_b"] == 0).all()
    # conv_w is drawn at scale 0.5, the projections at fan-in scale
    assert 0.3 < float(b.params["conv_w"].std()) < 0.7
