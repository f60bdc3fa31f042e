"""PyTorch port: RWKV6 (`rwkv6-3b` reduced: 2 layers, d_model 128, 4 wkv
heads x 32) against the reference on the same weights and inputs — the
parameter tree and its bridge, the time-mix layer, the full forward, and
the engine: whole-prompt chunks, a continuation chunk, decode steps with
an inactive row, the one-shot prefill and the slot splice of the state
leaves.

Tolerances: the time-mix layer within 1e-5 relative (max |d| / max
|ref|), the full forward and engine logits within 1e-4 relative (the
forward measured 4.3e-5: each layer's chunked wkv adds its rounding
differences, below) and states /
shifts within 5e-5 (atol = rtol) at float32 shifts — on the same inputs
the two packages' chunked wkv differ by up to 1.1e-4 of the output and
1.1e-5 of the state (`test_torch_wkv6.py`), and the second layer's
inputs inherit the first layer's differences.  bf16 shifts (the serving default) round the carried shift tokens
to bf16 on both sides, and a value within float rounding of a bf16
boundary may round the other way: logits within 1e-2 there.  The golden
test holds chunked prefill + decode to the port's own full forward at
the reference's 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import EngineConfig, get_config
from repro.core import paged_kv as jpk
from repro.core.engine import KVNANDEngine
from repro.models import rwkv6 as jrwkv
from repro.models.registry import Model
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.core import paged_kv as tpk
from repro_torch.core.engine import KVNANDEngine as TEngine
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.layers import layer_slice
from repro_torch.models.registry import Model as TModel

torch.set_num_threads(2)

ARCH = "rwkv6-3b"
STATE_LEAVES = ("rwkv_state", "rwkv_shift", "rwkv_shift2")
_CACHE = {}


def _weights():
    if not _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
        _CACHE["w"] = (cfg, params, tparams)
    return _CACHE["w"]


def _rel(t, j) -> float:
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.uint8).numpy()


def test_config_copy_equals_the_reference():
    """The port's copy of rwkv6-3b and of its reduced form, field for
    field (the reduced form is the slice's test shape)."""
    cfg = tget(ARCH).reduced()
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.d_head) == ("ssm", 2, 128, 4, 32)
    ref = get_config(ARCH)
    for port, want in ((tget(ARCH), ref), (cfg, ref.reduced())):
        assert {f: getattr(port, f) for f in port.__dataclass_fields__} == \
            {f: getattr(want, f) for f in want.__dataclass_fields__}


def test_init_builds_the_reference_tree():
    """Same leaf paths, shapes and dtypes as the reference's init; zeros
    and ones where it has them, normals at its scales."""
    cfg, params, _ = _weights()
    ref = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    port = bridge.flatten_with_paths(
        TModel(tget(ARCH).reduced()).init(torch.Generator().manual_seed(0)))
    assert sorted(port) == sorted(ref)
    for name, arr in ref.items():
        t = port[name]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32, name
        if np.all(arr == arr.flat[0]):                 # zeros / ones
            assert torch.equal(t, torch.tensor(arr)), name
        else:
            assert abs(float(t.std()) / float(arr.std()) - 1) < 0.2, name
    assert port["layers/tmix/ln_scale"].eq(1).all()
    assert tuple(port["layers/tmix/lora_b"].shape) == (2, 32, 5, 128)
    assert tuple(port["layers/tmix/mu_base"].shape) == (2, 5, 128)


def test_rwkv_tree_round_trips_bit_exactly():
    """Every leaf of the reference's RWKV tree — the 3-D `lora_b
    [L, R, 5, D]` and `mu_base [L, 5, D]` included — carries over bit for
    bit under its reference path name."""
    _, params, tparams = _weights()
    ref = _flatten_with_paths(params)
    port = bridge.flatten_with_paths(tparams)
    assert sorted(port) == sorted(ref)
    for name, arr in ref.items():
        arr = np.asarray(arr)
        assert tuple(port[name].shape) == arr.shape, name
        assert np.array_equal(_bits(port[name]).reshape(-1),
                              arr.reshape(-1).view(np.uint8)), name


@pytest.mark.parametrize("S", [1, 7, 40])
@pytest.mark.parametrize("chunked", [True, False])
def test_timemix_matches_reference(S, chunked):
    """Layer 1's time-mix from a nonzero state and shift: output, new
    state and new shift (S = 1 and chunked=False take the recurrence,
    S = 40 crosses a 32-token chunk)."""
    cfg, params, tparams = _weights()
    g = np.random.default_rng(S)
    B, D, H, dh = 2, cfg.d_model, cfg.n_heads, cfg.d_head
    x = g.standard_normal((B, S, D)).astype(np.float32)
    state = (g.standard_normal((B, H, dh, dh)) * 0.1).astype(np.float32)
    shift = g.standard_normal((B, D)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], params["layers"]["tmix"])
    want = jrwkv.rwkv_timemix(jp, cfg, jnp.asarray(x), jnp.asarray(state),
                              jnp.asarray(shift), chunked=chunked)
    got = trwkv.rwkv_timemix(layer_slice(tparams["layers"], 1)["tmix"],
                             tget(ARCH).reduced(), torch.from_numpy(x),
                             torch.from_numpy(state), torch.from_numpy(shift),
                             chunked=chunked)
    for t, j in zip(got, want):
        assert t.shape == j.shape
        assert _rel(t, j) < 1e-5


def test_forward_matches_reference():
    cfg, params, tparams = _weights()
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    want, _ = Model(cfg).forward(params, {"tokens": jnp.asarray(toks)})
    got = TModel(tget(ARCH).reduced()).forward(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4


def _engines(kv_dtype):
    cfg, params, tparams = _weights()
    kw = dict(page_tokens=8, kv_dtype=kv_dtype, uniform_lengths=False)
    return (cfg, params, tparams, KVNANDEngine(cfg, EngineConfig(**kw)),
            TEngine(tget(ARCH).reduced(), TEngineConfig(**kw), device="cpu"))


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4),
                                          ("bfloat16", 1e-2)])
def test_engine_trace_matches_reference(kv_dtype, tol):
    """Slot 0 takes a 20-token prompt as a whole chunk, slot 1 a 7-token
    prompt as a 4-token chunk and a 3-token continuation (first=False: the
    state is read from the slot); then decode steps with both slots, and
    with slot 1 inactive once — its state and shifts must stay exactly as
    they were.  Logits after every call, and the state leaves at the end,
    against the JAX engine."""
    cfg, params, tparams, je, te = _engines(kv_dtype)
    jc, tc = je.init_cache(2, 64), te.init_cache(2, 64)
    assert tc.k_pages_g is None and tc.page_table_g is None
    assert tc.rwkv_state.shape == (2, 2, 4, 32, 32)
    assert tc.rwkv_shift.dtype == getattr(torch, kv_dtype)
    r = np.random.default_rng(0)
    p0, p1 = (r.integers(1, cfg.vocab_size, n) for n in (20, 7))
    errs = []

    def chunk(toks, slot, start, first):
        nonlocal jc
        jl, jc = je.prefill_chunk(params, jc,
                                  {"tokens": jnp.asarray(toks)[None]}, slot,
                                  start, len(toks), first=first)
        tl, _ = te.prefill_chunk(tparams, tc,
                                 {"tokens": torch.from_numpy(toks)[None]},
                                 slot, start, len(toks), first=first)
        errs.append(_rel(tl, jl))

    chunk(p0, 0, 0, True)
    chunk(p1[:4], 1, 0, True)
    chunk(p1[4:], 1, 4, False)
    for step in range(4):
        toks = r.integers(1, cfg.vocab_size, 2)
        active = np.array([True, step != 2])
        before = [getattr(tc, n)[:, 1].clone() for n in STATE_LEAVES]
        jl, jc = je.decode_step(params, jc, jnp.asarray(toks)[:, None],
                                active=jnp.asarray(active))
        tl, _ = te.decode_step(tparams, tc, torch.from_numpy(toks)[:, None],
                               active=torch.from_numpy(active))
        errs.append(_rel(tl, jl))
        if not active[1]:
            for b, n in zip(before, STATE_LEAVES):
                assert torch.equal(getattr(tc, n)[:, 1], b), n
    assert max(errs) < tol, errs
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [24, 10]
    if kv_dtype == "float32":
        for n in STATE_LEAVES:
            np.testing.assert_allclose(getattr(tc, n).numpy(),
                                       np.asarray(getattr(jc, n)),
                                       atol=5e-5, rtol=5e-5)


def test_decode_matches_full_forward():
    """Port of test_engine_golden for RWKV6: a 21-token whole-prompt chunk
    per slot plus 3 decode steps reproduce the port's own full forward."""
    cfg = tget(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    model = TModel(cfg)
    params = model.init(gen)
    eng = TEngine(cfg, TEngineConfig(page_tokens=8, kv_dtype="float32",
                                     uniform_lengths=False), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    full = model.forward(params, {"tokens": toks})
    cache = eng.init_cache(2, 32)
    errs = []
    for b in range(2):
        lg, cache = eng.prefill_chunk(params, cache, {"tokens": toks[b:b + 1,
                                                                     :21]},
                                      b, 0, 21, first=True)
        errs.append(float((lg[0] - full[b, 20]).abs().max()))
    for t in range(21, 24):
        lg, cache = eng.decode_step(params, cache, toks[:, t:t + 1])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-4


def test_prefill_matches_reference_and_splices():
    """One-shot prefill of two 24-token prompts: last-token logits and
    state leaves against the JAX prefill; a bucketed prompt_len raises as
    in the reference; `splice_slot` copies a one-row prefill's state
    leaves and length into a slot as the reference's splice does."""
    cfg, params, tparams, je, te = _engines("float32")
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 24))
    jl, jc = je.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)}, 48)
    tl, tc = te.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 48)
    assert _rel(tl, jl) < 1e-4
    assert tc.lengths.tolist() == [24, 24]
    for n in STATE_LEAVES:
        np.testing.assert_allclose(getattr(tc, n).numpy(),
                                   np.asarray(getattr(jc, n)),
                                   atol=5e-5, rtol=5e-5)
    with pytest.raises(ValueError, match="recurrent state"):
        te.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 48,
                   prompt_len=20)
    # splice the one-row prefill of prompt 1 into slot 2 of a 3-slot cache
    _, j1 = je.prefill(params, {"tokens": jnp.asarray(toks[1:], jnp.int32)},
                       48)
    _, t1 = te.prefill(tparams, {"tokens": torch.from_numpy(toks[1:])}, 48)
    jbig = jpk.splice_slot_ref(je.init_cache(3, 48), j1, 2)
    tbig = tpk.splice_slot(te.init_cache(3, 48), t1, 2)
    assert tbig.lengths.tolist() == np.asarray(jbig.lengths).tolist() == \
        [0, 0, 24]
    for n in STATE_LEAVES:
        got = getattr(tbig, n)
        assert torch.equal(got[:, 2], getattr(t1, n)[:, 0])
        assert not got[:, :2].any()
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jbig, n)),
                                   atol=5e-5, rtol=5e-5)
