"""PyTorch port: dense-forward building blocks against the JAX reference
at float32, on the same numpy inputs (atol = rtol = 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rms_norm():
    r = _rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = r.standard_normal(64).astype(np.float32) * 0.1
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    r = _rng(1)
    x = r.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = r.integers(0, 200, (2, 6)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_dense_and_mlp():
    r = _rng(2)
    d, f = 48, 96
    p = {"gate_w": r.standard_normal((d, f)).astype(np.float32) / 7,
         "up_w": r.standard_normal((d, f)).astype(np.float32) / 7,
         "down_w": r.standard_normal((f, d)).astype(np.float32) / 10,
         "up_b": r.standard_normal(f).astype(np.float32)}
    x = r.standard_normal((3, 4, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tl.dense(tp, "up", tx), jl.dense(jp, "up", jx))
    for gated in (True, False):
        _close(tl.mlp(tp, tx, gated), jl.mlp(jp, jx, gated))


@pytest.mark.parametrize("arch,bias", [("qwen1.5-0.5b", True),
                                       ("llama3.1-8b", False)])
def test_project_qkv_and_out(arch, bias):
    cfg = get_config(arch).reduced()
    assert cfg.attn_bias == bias
    K, G, dh, d = cfg.n_kv_heads, cfg.group_size, cfg.d_head, cfg.d_model
    r = _rng(3)
    p = {"wq_w": r.standard_normal((K, d, G * dh)) / np.sqrt(d),
         "wk_w": r.standard_normal((K, d, dh)) / np.sqrt(d),
         "wv_w": r.standard_normal((K, d, dh)) / np.sqrt(d),
         "wo_w": r.standard_normal((cfg.q_dim, d)) / np.sqrt(cfg.q_dim)}
    if bias:   # non-zero biases, so the bias add is really exercised
        p.update(wq_b=r.standard_normal((K, G * dh)),
                 wk_b=r.standard_normal((K, dh)),
                 wv_b=r.standard_normal((K, dh)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tq = tattn.project_qkv(tp, tget(arch).reduced(), torch.from_numpy(x),
                           torch.from_numpy(pos))
    jq = jattn.project_qkv(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    for t, j in zip(tq, jq):
        _close(t, j)
    _close(tattn.project_out(tp, tget(arch).reduced(), tq[0]),
           jattn.project_out(jp, cfg, jq[0]))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.1-8b"])
def test_lm_head_logits(arch):
    """Tied (qwen) and untied (llama) heads over the padded vocab."""
    cfg = get_config(arch).reduced()
    r = _rng(4)
    p = {"embedding": r.standard_normal((cfg.padded_vocab, cfg.d_model)),
         "final_norm": r.standard_normal(cfg.d_model) * 0.1}
    if not cfg.tie_embeddings:
        p["lm_head"] = r.standard_normal((cfg.padded_vocab, cfg.d_model))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    _close(ttf.lm_head_logits({k: torch.from_numpy(v) for k, v in p.items()},
                              tget(arch).reduced(), torch.from_numpy(x)),
           jtf.lm_head_logits({k: jnp.asarray(v) for k, v in p.items()},
                              cfg, jnp.asarray(x)))
