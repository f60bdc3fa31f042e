"""Prompt-lookup (n-gram) self-drafting for speculative decoding.

KVNAND's premise is that single-batch decode is bandwidth-bound: every
emitted token pays a full weight load and KV walk.  Draft-and-verify
speculative decoding amortizes that traffic — the engine verifies k
drafted tokens in ONE forward pass (`KVNANDEngine.verify_step`), so a
step that accepts a tokens emits a+1 for one weight load instead of
a+1 of them.  On-device there is no room for a second draft model, so
the drafter is the cheapest one that works: PROMPT LOOKUP.  The
request's own token history is scanned for the most recent earlier
occurrence of its trailing n-gram, and the tokens that followed that
occurrence become the draft — free to propose, and highly effective on
the repetitive spans (code, quoted context, structured output) where
decode spends most of its tokens.

Drafts carry no probabilities: verification samples the TARGET
distribution at every span position from the request's own
``fold_in(seed, position)`` stream and accepts a draft token only when
the sampled token equals it (`serving.sampler.speculative_accept`).
The emitted sequence is therefore distributed exactly as non-speculative
decoding — bit-equal greedy at temperature 0, same-stream sampling
otherwise — whatever the drafter proposes; draft quality only changes
how many tokens each verify step emits.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def propose_draft(tokens: Sequence[int], k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Propose ``k`` draft tokens continuing ``tokens`` by prompt lookup.

    Scans for the most recent earlier occurrence of the longest trailing
    n-gram (``max_ngram`` down to ``min_ngram``) and returns the tokens
    that followed it, padded by repeating the last token when the match
    sits near the end.  With no match the draft is the last token
    repeated — still correct (verification rejects bad drafts), and the
    right guess on degenerate repetitive tails.

    The scan is vectorized (one shifted-slice comparison per n-gram
    position) — it runs once per active slot per verify step, so the
    per-step host cost stays a handful of numpy passes over the
    history, not a Python loop.
    """
    n = len(tokens)
    if k <= 0 or n == 0:
        return []
    arr = np.asarray(tokens, np.int64)
    for g in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        pat = arr[-g:]
        # candidate starts 0..n-g-1 (strictly before the trailing
        # n-gram itself, so at least one continuation token exists)
        ok = np.ones(n - g, bool)
        for j in range(g):
            ok &= arr[j:n - g + j] == pat[j]
        hits = np.flatnonzero(ok)
        if hits.size:
            i = int(hits[-1])                  # most recent occurrence
            cont = arr[i + g:i + g + k].tolist()
            return cont + [int(arr[-1])] * (k - len(cont))
    return [int(arr[-1])] * k
