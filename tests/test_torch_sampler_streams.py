"""PyTorch port: the reference's sampling streams (threefry) on the CPU.

The port draws a seeded row's Gumbel noise from the reference's key,
``fold_in(PRNGKey(seed), position)``, through its own torch
`threefry2x32` / `random_bits` / `uniform` / `gumbel`:

  * the hash, the keys and the random bits equal jax's bit for bit, for
    several seeds, positions and widths (V = 151936, qwen's vocabulary,
    and odd widths);
  * the uniform floats equal jax's bit for bit; the Gumbel noise is
    -log(-log(u)) on those floats, and torch's float32 `log` and XLA's
    differ in the last bit on some inputs (each log within 1 ulp of the
    other on the same input, checked), so the noise is held to 2^-22 (1
    + |n|), what its two logs allow even 2 ulps apart (as a card's and a
    CPU's may be), and most elements are equal;
  * a seeded stochastic `KVNANDServer` (temperature 0.9 with top_k 20,
    top_p 0.9 with seed 123) serves the reference server's tokens, with
    logprobs within 1e-4 at a float32 pool, sequentially and with
    speculation_k = 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.configs import EngineConfig, get_config
from repro.models.registry import Model
from repro.serving.api import KVNANDServer as JServer
from repro.serving.api import SamplingParams as JParams
from repro.serving.api import ServerConfig as JConfig
from repro.serving.sampler import _noise, request_keys
from repro_torch import bridge
from repro_torch.configs import EngineConfig as TEngineConfig
from repro_torch.configs import get_config as tget
from repro_torch.serving import sampler as ts
from repro_torch.serving.api import KVNANDServer, SamplingParams, ServerConfig

torch.set_num_threads(2)

SEEDS = np.array([0, 1, 7, 123, 0x9E3779B1, 2 ** 32 - 1], np.uint32)
POSITIONS = np.array([0, 1, 5, 64, 99_999, 2 ** 31 - 1], np.int64)
TINY = np.finfo(np.float32).tiny


def _jax_keys():
    return np.asarray(request_keys(SEEDS, POSITIONS)).astype(np.int64)


def test_threefry2x32_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for key in ([0, 0], [0, 123], [2 ** 32 - 1, 17]):
        count = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(
            np.uint32)
        want = np.asarray(jprng.threefry_2x32(
            jnp.asarray(key, jnp.uint32), jnp.asarray(count)))
        x = torch.from_numpy(count.astype(np.int64))
        y0, y1 = ts.threefry2x32(torch.tensor(key[0]), torch.tensor(key[1]),
                                 x[:32], x[32:])
        assert np.array_equal(torch.cat([y0, y1]).numpy(),
                              want.astype(np.int64))


def test_keys_and_fold_in_are_jax_bit_for_bit():
    for s in SEEDS:
        want = np.asarray(jax.random.PRNGKey(s)).astype(np.int64)
        assert ts.PRNGKey([s]).numpy()[0].tolist() == want.tolist()
    got = ts.fold_in(ts.PRNGKey(SEEDS), POSITIONS)
    assert np.array_equal(got.numpy(), _jax_keys())
    # a fold of a fold, as jax chains them
    twice = ts.fold_in(got, POSITIONS[::-1].copy())
    want = np.stack([np.asarray(jax.random.fold_in(
        jnp.asarray(k, jnp.uint32), p)) for k, p in zip(
        _jax_keys(), POSITIONS[::-1])]).astype(np.int64)
    assert np.array_equal(twice.numpy(), want)


@pytest.mark.parametrize("V", [151936, 517, 1])
def test_random_bits_are_jax_bit_for_bit(V):
    keys = _jax_keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (V,)))(
        jnp.asarray(keys, jnp.uint32))).astype(np.int64)
    got = ts.random_bits(torch.from_numpy(keys), V).numpy()
    assert got.shape == (len(SEEDS), V)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("V", [151936, 517])
def test_gumbel_noise_is_the_reference_stream(V):
    """uniform: bit for bit.  Noise: equal up to the last bit of each of
    the two logs (the bound in the module docstring)."""
    keys = _jax_keys()
    jk = jnp.asarray(keys, jnp.uint32)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), minval=TINY))(jk))
    tu = ts.uniform(torch.from_numpy(keys), V, minval=float(TINY)).numpy()
    assert np.array_equal(ju.view(np.int32), tu.view(np.int32))
    want = np.asarray(_noise(jk, (len(SEEDS), V)))
    got = ts.request_noise(SEEDS, POSITIONS, V, "cpu").numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 2.0 ** -22 * (1.0 + np.abs(want))).all(), err.max()
    assert (err == 0).mean() > 0.5
    # each log alone: within 1 ulp of XLA's on the same input
    for x in (tu, -np.asarray(jnp.log(jnp.asarray(tu)))):
        a = np.asarray(jnp.log(jnp.asarray(x))).view(np.int32)
        b = torch.log(torch.from_numpy(x.copy())).numpy().view(np.int32)
        assert np.abs(a.astype(np.int64) - b).max() <= 1


# ---------------------------------------------------------------------------
# a seeded stochastic server serves the reference's tokens
# ---------------------------------------------------------------------------

ARCH = "qwen1.5-0.5b"
_CACHE = {}


def _weights():
    if "w" not in _CACHE:
        cfg = get_config(ARCH).reduced()
        params = Model(cfg).init(jax.random.PRNGKey(0))
        _CACHE["w"] = (cfg, params, tget(ARCH).reduced(),
                       bridge.params_from_numpy(
                           jax.tree.map(np.asarray, params), "cpu"))
    return _CACHE["w"]


def _prompts(vocab):
    r = np.random.default_rng(5)
    return ([r.integers(1, vocab, n).tolist() for n in (6, 23, 11)]
            + [list(range(40, 60)) * 2])


STOCHASTIC = [dict(temperature=0.9, top_k=20),
              dict(temperature=0.7, top_p=0.9, seed=123)]


@pytest.mark.parametrize("spec_k", [0, 4], ids=["sequential", "spec4"])
def test_seeded_server_serves_the_reference_tokens(spec_k):
    cfg, params, tcfg, tparams = _weights()
    prompts = _prompts(cfg.vocab_size)
    serve = dict(batch_slots=2, max_context=96, prefill_chunk_tokens=16,
                 speculation_k=spec_k, seed=3)
    kinds = [STOCHASTIC[i % 2] for i in range(len(prompts))]
    ref = JServer(JConfig(engine=EngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype="float32"), **serve),
        cfg=cfg, params=params)
    want = ref.generate(prompts, [JParams(max_new_tokens=12, logprobs=True,
                                          **k) for k in kinds])
    srv = KVNANDServer(ServerConfig(engine=TEngineConfig(
        page_tokens=16, uniform_lengths=False, kv_dtype="float32"),
        device="cpu", **serve), cfg=tcfg, params=tparams)
    got = srv.generate(prompts, [SamplingParams(max_new_tokens=12,
                                                logprobs=True, **k)
                                 for k in kinds])
    greedy = ref.generate(prompts, JParams(max_new_tokens=12))
    assert any(g.token_ids != w.token_ids for g, w in zip(greedy, want)), \
        "the sampled streams never left the greedy path"
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    if spec_k:
        assert srv.stats["spec_steps"] > 0
