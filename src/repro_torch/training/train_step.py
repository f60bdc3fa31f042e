"""The train step (port of `repro.training.train_step`): microbatched
gradients, global-norm clipping, AdamW.

`make_train_step` is the reference's pjit step: `loss_fn` under autograd
(every attention forward through kernel B4 on a card, its backward in
torch ops, `kernels/flash_attention/autograd.py`; ring attention over the
ambient mesh's `model` axis when one is entered), the gradients
accumulated over `EngineConfig.microbatches` in float32, then clipped
and applied.

`make_compressed_train_step` is manual data parallelism over the mesh's
(pod, data) axes: each (pod, data) coordinate computes gradients on its
slice of the batch, on that coordinate's device (the `model` axis stays
free, so the attention inside runs the ring over it), an exact `pmean`
over `data`, then the int8 error-feedback sum over `pod`
(`grad_compress.py`); clipping and AdamW then run once, on the mesh's
first device, where the weights live.  `TrainState.ef` keeps one
residual per pod (a ShardedTensor [n_pods, ...] over the pod axis),
which is what the reference's devices hold: its step returns the
residual as if replicated (`out_specs=P()` under `check_vma=False`), so
a host read or a checkpoint of the reference sees one device's copy
(ROADMAP §C).  A plain residual (`init_train_state(compressed=True)`, or
a reference state through `bridge`) goes to every pod, as a replicated
input does in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.distributed.sharding import (P, ShardedTensor,
                                              manual_axes, pmean)
from repro_torch.models.transformer import Runtime, loss_fn
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.grad_compress import (compressed_cross_pod_psum,
                                                init_error_feedback)
from repro_torch.bridge import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.AdamWState
    ef: Optional[Any] = None      # error-feedback residuals (compressed DP)


def init_train_state(params, acfg: opt_mod.AdamWConfig,
                     compressed: bool = False) -> TrainState:
    return TrainState(params=params, opt=opt_mod.init_adamw(params, acfg),
                      ef=init_error_feedback(params) if compressed else None)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    def split(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"global batch {B} does not split into {n} "
                             "microbatches")
        return x.reshape(n, B // n, *x.shape[1:])
    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()} for i in range(n)]


def _value_and_grad(params, batch, cfg: ModelConfig, rt: Runtime,
                    remat: str):
    """(loss, metrics, grads) of one (micro)batch.  The gradients are
    taken with respect to detached views of the leaves (no copy), so the
    parameters themselves never require grad and the optimizer may update
    them in place."""
    p_grad = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p_grad, cfg, batch, rt, remat)
        grads = torch.autograd.grad(loss, tree_leaves(p_grad),
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def grads_and_metrics(params, batch, cfg: ModelConfig, rt: Runtime,
                      remat: str, microbatches: int):
    """Microbatch-accumulated mean grads: a Python loop in place of the
    reference's `lax.scan`, the sum in float32, divided by n; the loss
    and every metric are means over the microbatches."""
    if microbatches <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg, rt, remat)
        return grads, dict(metrics, loss=loss)
    acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    acc_l, acc_m = 0.0, {}
    for mb in _split_microbatches(batch, microbatches):
        loss, metrics, grads = _value_and_grad(params, mb, cfg, rt, remat)
        for a, g in zip(tree_leaves(acc_g), tree_leaves(grads)):
            a.add_(g.float())
        del grads
        acc_l = acc_l + loss
        for k, v in metrics.items():
            acc_m[k] = acc_m.get(k, 0.0) + v
    grads = tree_map(lambda g: g / microbatches, acc_g)
    metrics = {k: v / microbatches for k, v in acc_m.items()}
    return grads, dict(metrics, loss=acc_l / microbatches)


def make_train_step(cfg: ModelConfig, rt: Runtime,
                    acfg: opt_mod.AdamWConfig, eng: EngineConfig,
                    max_grad_norm: float = 1.0):
    """The train step: state, batch -> (new state, metrics {loss, ce,
    aux, grad_norm, lr}).  The state's leaves are updated in place (the
    reference donates its state to the jitted step)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = grads_and_metrics(
            state.params, batch, cfg, rt, eng.remat, eng.microbatches)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, max_grad_norm)
        new_params, new_opt, lr = opt_mod.adamw_update(
            state.params, grads, state.opt, acfg)
        metrics.update(grad_norm=gnorm, lr=lr)
        return TrainState(new_params, new_opt, state.ef), metrics

    return train_step


def make_compressed_train_step(cfg: ModelConfig, rt: Runtime,
                               acfg: opt_mod.AdamWConfig, eng: EngineConfig,
                               mesh, max_grad_norm: float = 1.0):
    """Manual-DP train step with int8 cross-pod gradient compression on
    `mesh` (axes among pod, data, model): the state's params live on the
    mesh's first device; the batch's rows split over (pod, data) in
    row-major order, as the reference's batch spec P(("pod", "data"))."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_pods = mesh.shape.get("pod", 1)
    n_data = mesh.shape.get("data", 1)
    # one device per (pod, data) coordinate: its model-axis index 0
    dp = mesh.submesh({a: 0 for a in mesh.axis_names if a not in dp_axes})
    home = mesh.first_device

    def per_shard(tree_list):
        """Per-coordinate trees -> a tree of ShardedTensors on `dp`."""
        return tree_unflatten(tree_list[0], [
            ShardedTensor(dp, P(), list(ts))
            for ts in zip(*(tree_leaves(t) for t in tree_list))])

    def pod_residuals(ef):
        """Each coordinate's residual: a plain leaf at every coordinate,
        a per-pod leaf at its pod's coordinates."""
        def one(e):
            if isinstance(e, ShardedTensor):
                return ShardedTensor(dp, P(), [t[0] for t in e.shards])
            return ShardedTensor(dp, P(), [e.to(dp.device(i))
                                           for i in range(dp.size)])
        return tree_map(one, ef)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if state.ef is None and n_pods > 1:
            raise ValueError("the compressed step needs the error-feedback "
                             "residuals: init_train_state(compressed=True)")
        B = next(iter(batch.values())).shape[0]
        if B % dp.size:
            raise ValueError(f"batch {B} does not split over {dp.shape}")
        Bl = B // dp.size
        grads_l, metrics_l = [], []
        with mesh:
            for i, coord in enumerate(dp.coords()):
                dev = dp.device(i)
                mb = {k: v[i * Bl:(i + 1) * Bl].to(dev)
                      for k, v in batch.items()}
                params = tree_map(lambda p: p.to(dev), state.params)
                with manual_axes(**coord):
                    g, m = grads_and_metrics(params, mb, cfg, rt, eng.remat,
                                             eng.microbatches)
                grads_l.append(g)
                metrics_l.append(m)
        grads, metrics = per_shard(grads_l), per_shard(metrics_l)
        del grads_l, metrics_l
        ef = state.ef
        # exact reduction inside the pod
        if "data" in dp_axes and n_data > 1:
            grads = tree_map(lambda g: pmean(g.map(lambda t: t.float()),
                                             "data"), grads)
            metrics = tree_map(lambda m: pmean(m, "data"), metrics)
        # compressed reduction across pods
        if "pod" in dp_axes and n_pods > 1:
            grads, new_e = compressed_cross_pod_psum(
                grads, pod_residuals(state.ef), n_pods=n_pods)
            ef = tree_map(lambda e: ShardedTensor(
                dp, P("pod"), [t[None] for t in e.shards]), new_e)
            metrics = tree_map(lambda m: pmean(m, "pod"), metrics)
        grads = tree_map(lambda g: g.shards[0].to(home), grads)
        metrics = tree_map(lambda m: m.shards[0].to(home), metrics)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, max_grad_norm)
        new_params, new_opt, lr = opt_mod.adamw_update(
            state.params, grads, state.opt, acfg)
        metrics.update(grad_norm=gnorm, lr=lr)
        return TrainState(new_params, new_opt, ef), metrics

    return train_step
