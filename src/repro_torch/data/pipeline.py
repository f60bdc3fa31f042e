"""Deterministic, restart-safe data pipeline (port of
`repro.data.pipeline`, which is numpy only: the same code, so batch `i`
is byte-identical to the reference's batch `i`).

Index-based: batch `i` is a pure function of (seed, i), so any host can
produce any shard and resuming from a checkpointed step cursor is exact —
no iterator state to persist, no skip-ahead replay cost (the paper-scale
fault-tolerance requirement).

Sources:
  * SyntheticLM — zipf-ish token stream with structure (next-token
    correlations) so smoke-training visibly learns.
  * TokenFile   — memory-mapped flat token file (np.memmap), strided
    deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None     # None -> synthetic


class SyntheticLM:
    """Markov-ish synthetic stream: token_{t+1} = f(token_t) + noise.

    Learnable structure: each token deterministically prefers a successor
    (permutation) with 80% probability — a model that trains will drop
    loss well below ln(V).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        follow = rng.random((B, S)) < 0.8
        noise = rng.integers(0, cfg.vocab_size, (B, S))
        for t in range(S):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenFile:
    """Flat int32 token file; batch i reads a deterministic stride."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        starts = rng.integers(0, self.n_windows, cfg.global_batch) \
            * cfg.seq_len
        toks = np.stack([self.data[s:s + cfg.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    return TokenFile(cfg) if cfg.path else SyntheticLM(cfg)


class DataIterator:
    """Cursor-based iterator; `state()`/`restore()` are just an int."""

    def __init__(self, source, start_index: int = 0):
        self.source = source
        self.index = start_index

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.source.batch(self.index)
        self.index += 1
        return b

    def state(self) -> int:
        return self.index

    def restore(self, index: int):
        self.index = index
