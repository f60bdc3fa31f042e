"""PyTorch port: the vectorized sampler against the JAX reference.

Both sides get the same Gumbel noise — the reference draws it from its
per-row keys, and the port takes it as a tensor — so greedy,
temperature, top-k and top-p rows must pick identical tokens, with
logprobs within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import request_keys, sample_with_logprobs
from repro_torch.serving import sampler as ts

torch.set_num_threads(2)

B, V, TRUE_V = 8, 640, 600
# per row: (temperature, top_k, top_p) — greedy, plain temperature,
# top-k, top-p, and both filters composed
ROWS = [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8),
        (0.9, 20, 0.5), (0.0, 3, 0.3), (2.5, 0, 0.95), (0.5, 1, 1.0)]


def _logits(seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, V)) * 3).astype(np.float32)


def _noise(seeds, positions):
    keys = request_keys(jnp.asarray(seeds, jnp.uint32),
                        jnp.asarray(positions, jnp.int32))
    return keys, np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
        keys))


@pytest.mark.parametrize("seed", range(6))
def test_rows_match_reference_given_the_same_noise(seed):
    logits = _logits(seed)
    t, k, p = (np.asarray(c) for c in zip(*ROWS))
    keys, noise = _noise(np.arange(B) + 100 * seed, np.full(B, seed))
    jt, jl = sample_with_logprobs(
        jnp.asarray(logits), keys, true_vocab=TRUE_V,
        temperature=jnp.asarray(t, jnp.float32),
        top_k=jnp.asarray(k, jnp.int32), top_p=jnp.asarray(p, jnp.float32))
    tt, tl = ts.sample_with_logprobs(
        torch.from_numpy(logits), torch.from_numpy(noise), true_vocab=TRUE_V,
        temperature=torch.tensor(t, dtype=torch.float32),
        top_k=torch.tensor(k), top_p=torch.tensor(p, dtype=torch.float32))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_greedy_batch_needs_no_noise():
    logits = _logits(7)
    keys, _ = _noise(np.arange(B), np.zeros(B))
    jt, jl = sample_with_logprobs(jnp.asarray(logits), keys,
                                  true_vocab=TRUE_V)
    tt, tl = ts.sample_with_logprobs(torch.from_numpy(logits), None,
                                     true_vocab=TRUE_V)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("temperature", [1.0, 50.0, 1e4])
def test_pad_ids_never_sampled(temperature):
    """Padded vocab lanes hold a floor below any noise at any temperature
    (a deterministic sweep; property tests here would set deadline=None)."""
    logits = np.zeros((64, V), np.float32)
    logits[:, TRUE_V:] = 1e4               # padding would win if unmasked
    for pos in range(4):
        noise = ts.request_noise(range(64), [pos] * 64, V, "cpu")
        toks, lps = ts.sample_with_logprobs(
            torch.from_numpy(logits), noise, true_vocab=TRUE_V,
            temperature=temperature)
        assert int(toks.max()) < TRUE_V
        assert bool(torch.isfinite(lps).all())


def test_request_noise_is_a_function_of_seed_and_position():
    a = ts.request_noise([3, 9], [5, 0], V, "cpu")
    b = ts.request_noise([9, 3, 4], [0, 5, 5], V, "cpu")
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0])
    assert not torch.equal(b[1], b[2])
    assert bool(torch.isfinite(a).all())
