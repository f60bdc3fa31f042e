"""PyTorch port: the data pipeline and AdamW against the JAX reference,
on the CPU.

  * `SyntheticLM` batches (tokens and labels, dtype and bytes) equal the
    reference's for several seeds and indices, a restored cursor yields
    the reference's next batch, and `TokenFile` reads the same windows.
  * `lr_schedule`, `adamw_update` (f32 and bf16 moments, over several
    steps, decay on matrices only), `global_norm` and
    `clip_by_global_norm` equal the reference's functions at rtol 1e-5;
    the step leaf is a 0-d int32 and the state the reference's
    `AdamWState(step, m, v)`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.training import optimizer as jopt
from repro_torch.data import pipeline as tpipe
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)

RTOL = 1e-5


@pytest.mark.parametrize("seed,vocab", [(0, 97), (3, 151936), (7, 50)])
def test_synthetic_batches_equal_the_reference(seed, vocab):
    jsrc = jpipe.make_source(jpipe.DataConfig(seq_len=33, global_batch=3,
                                              vocab_size=vocab, seed=seed))
    tsrc = tpipe.make_source(tpipe.DataConfig(seq_len=33, global_batch=3,
                                              vocab_size=vocab, seed=seed))
    for i in (0, 1, 5, 1000):
        want, got = jsrc.batch(i), tsrc.batch(i)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), (i, k)


def test_cursor_restore_equals_the_reference():
    cfg = dict(seq_len=8, global_batch=2, vocab_size=50, seed=1)
    jit = jpipe.DataIterator(jpipe.make_source(jpipe.DataConfig(**cfg)))
    tit = tpipe.DataIterator(tpipe.make_source(tpipe.DataConfig(**cfg)))
    for _ in range(4):
        next(jit), next(tit)
    assert jit.state() == tit.state() == 4
    tit2 = tpipe.DataIterator(tpipe.make_source(tpipe.DataConfig(**cfg)))
    tit2.restore(jit.state())
    np.testing.assert_array_equal(next(tit2)["tokens"], next(jit)["tokens"])


def test_token_file_reads_the_reference_windows(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    cfg = dict(seq_len=16, global_batch=4, vocab_size=1000, seed=2,
               path=str(path))
    jsrc = jpipe.make_source(jpipe.DataConfig(**cfg))
    tsrc = tpipe.make_source(tpipe.DataConfig(**cfg))
    assert isinstance(tsrc, tpipe.TokenFile)
    for i in (0, 3):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tsrc.batch(i)[k],
                                          jsrc.batch(i)[k])


def test_lr_schedule_equals_the_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-3, warmup_steps=2, total_steps=6),
               dict(lr=1e-2, warmup_steps=0, total_steps=1,
                    min_lr_ratio=0.3)):
        jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for s in (0, 1, 2, 3, 5, 10, 55, 100, 200):
            want = float(jopt.lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
            got = topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12)


def _tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "layers": {"b": rng.standard_normal((5,)).astype(dtype),
                       "k": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _close(jtree, ttree, rtol=RTOL, atol=0.0):
    for k, v in jtree.items():
        if isinstance(v, dict):
            _close(v, ttree[k], rtol, atol)
        else:
            np.testing.assert_allclose(ttree[k].float().numpy(),
                                       np.asarray(v, np.float32),
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(moments):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg = jopt.AdamWConfig(**kw, moment_dtype=getattr(jnp, moments))
    tcfg = topt.AdamWConfig(**kw, moment_dtype=getattr(torch, moments))
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = jopt.init_adamw(jp, jcfg), topt.init_adamw(tp, tcfg)
    assert ts.step.dtype == torch.int32 and ts.step.ndim == 0
    assert type(ts).__name__ == "AdamWState" and ts._fields == js._fields
    for _ in range(4):
        g = _tree(rng)
        jp, js, jlr = jopt.adamw_update(jp, _jax(g), js, jcfg)
        tp, ts, tlr = topt.adamw_update(tp, _torch(g), ts, tcfg)
        assert float(tlr) == pytest.approx(float(jlr), rel=RTOL)
        assert int(ts.step) == int(js.step)
        assert ts.m["w"].dtype == getattr(torch, moments)
        _close(jp, tp, atol=1e-7)
        _close(js.m, ts.m)
        _close(js.v, ts.v)


def test_weight_decay_touches_matrices_only():
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10 ** 9,
                           min_lr_ratio=1.0, weight_decay=0.5)
    params = {"w": torch.ones((3, 3)), "b": torch.ones((3,))}
    zero = {"w": torch.zeros((3, 3)), "b": torch.zeros((3,))}
    new, _, _ = topt.adamw_update(params, zero, topt.init_adamw(params, cfg),
                                  cfg)
    assert torch.allclose(new["w"], torch.full((3, 3), 1 - 1e-2 * 0.5))
    assert torch.equal(new["b"], torch.ones(3))


def test_global_norm_and_clipping_equal_the_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(_jax(g), max_norm)
        tc, tn = topt.clip_by_global_norm(_torch(g), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=RTOL)
        assert float(topt.global_norm(_torch(g))) == pytest.approx(
            float(jopt.global_norm(_jax(g))), rel=RTOL)
        _close(jc, tc)
