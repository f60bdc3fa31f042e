"""The train step (port of `repro.training.train_step`): microbatched
gradients, global-norm clipping, AdamW.

`make_train_step` is the reference's single-device step: `loss_fn` under
autograd (every attention forward through kernel B4 on a card, its
backward in torch ops, `kernels/flash_attention/autograd.py`), the
gradients accumulated over `EngineConfig.microbatches` in float32, then
clipped and applied.  The reference's `make_compressed_train_step`
(manual data parallelism across pods with int8 error feedback,
`grad_compress.py`) needs collectives and waits for the multi-GPU port
(ROADMAP A17); `TrainState.ef` stays None.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.models.transformer import Runtime, loss_fn
from repro_torch.training import optimizer as opt_mod
from repro_torch.bridge import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.AdamWState
    ef: Optional[Any] = None      # error-feedback residuals (compressed DP)


def init_train_state(params, acfg: opt_mod.AdamWConfig) -> TrainState:
    return TrainState(params=params, opt=opt_mod.init_adamw(params, acfg))


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
