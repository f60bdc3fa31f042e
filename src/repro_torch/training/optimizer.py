"""AdamW from scratch (port of `repro.training.optimizer`).

The reference's arithmetic, leaf for leaf: float32 moment math and bias
correction, weight decay added to the update of matrices only (leaves
with ndim >= 2, not norms or biases), moments stored in `moment_dtype`
(bfloat16 halves the optimizer state, the large-MoE recipe).
`torch.optim.AdamW` is not used: it decays every leaf and keeps a state
of its own, where checkpoints need the reference's `AdamWState(step, m,
v)` tree.

`adamw_update` writes the new parameters and moments into the leaves it
is given (the reference donates its train state to the jitted step), so
a step allocates no second copy of a 20 GB state; it returns the same
trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.bridge import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32: updates applied
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32, as the
    reference computes it)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, lr); the leaves of `params` and of
    the moments are updated in place."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + torch.square(gf) * (1 - b2)
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (not norms/biases)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, AdamWState(step, state.m, state.v), lr


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
