"""The one traffic generator: a closed loop of clients, read from a mix's
data file (`traffic/<name>.json`).  Nothing here imports the program.

A mix file gives:

  * ``prompt_tokens`` and ``output_tokens``: {"dist": "lognormal",
    "median", "sigma", "min", "max"}, the lengths of a request's own
    prompt (after any document) and of its reply;
  * ``documents`` (optional): {"count", "tokens"}: shared documents that
    each prompt starts with, picked uniformly; ``prefill_in_setup``:
    each document is prefilled once before the window;
  * ``requests_per_client``: how many rounds the pool holds (a client
    that runs past them starts over);
  * ``first_request``: "residual" gives each client's first reply the
    length that a reply in progress at a random moment has left (L
    drawn with probability proportional to L, since a long reply is
    more likely to be in progress, times u uniform in (0, 1]), so that
    the loop starts with its completions spread as in its steady state
    instead of every reply starting together.

Every seed gets the same work: the seed draws the token ids, the
documents and which document each request asks about, never a length.
Round k (the k-th request of every client) holds the distribution's
quantiles at (i + offset_k) / clients, clipped, offset_k a fixed
sequence that fills in the quantiles over the rounds, spread over the
clients by a fixed shuffle (prompts and replies apart); the residual
first replies are likewise fixed quantiles of a fixed large sample of
the residual distribution.  With the seed permuting the lengths too,
mixtral's tokens/s spread 12-15% over six seeds against 2-5% between two
runs of one seed (PERF.md): in a window of ~40 completions, which
client holds which length changes the work.  Request k of client c is a
pure function of (seed, c, k), whatever order the loop asks for it in.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    client: int
    index: int
    prompt: List[int]
    max_new: int
    doc: int = -1              # document id, -1 for none
    prefix_len: int = 0        # tokens of the document it starts with


# round k's quantiles sit at (i + offset_k) / clients, offset_k the
# fractional part of 1/2 + k / golden ratio: the same for every seed
GOLDEN = (5 ** 0.5 - 1) / 2


def lengths(spec: Dict, n: int, offset: float = 0.5) -> np.ndarray:
    """The n stratified quantiles at (i + offset) / n of a length
    distribution, clipped."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = NormalDist()
    offset = min(max(offset, 1e-3), 1 - 1e-3)
    z = np.array([nd.inv_cdf((i + offset) / n) for i in range(n)])
    v = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def residual_lengths(spec: Dict, n: int) -> np.ndarray:
    """n stratified quantiles of the residual reply length, max(min,
    ceil(u L)), L length-biased: from a fixed sample of 65536 draws."""
    rng = np.random.default_rng(0)
    pool = lengths(spec, 4096)
    big = pool[rng.choice(len(pool), 65536, p=pool / pool.sum())]
    res = np.maximum(spec["min"], np.ceil((1.0 - rng.random(65536)) * big))
    q = np.quantile(res, (np.arange(n) + 0.5) / n, method="nearest")
    return q.astype(np.int64)


class Traffic:
    """The requests of one run of a closed-loop mix."""

    def __init__(self, mix: Dict, seed: int, clients: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.per_client = mix["requests_per_client"]
        rng = np.random.default_rng(0)          # the same for every seed
        offsets = [(0.5 + k * GOLDEN) % 1.0 for k in range(self.per_client)]
        # [round, client]
        self.prompt_len = np.stack([
            rng.permutation(lengths(mix["prompt_tokens"], clients, o))
            for o in offsets])
        self.output_len = np.stack([
            rng.permutation(lengths(mix["output_tokens"], clients, o))
            for o in offsets])
        self.residual = rng.permutation(
            residual_lengths(mix["output_tokens"], clients))
        docs = mix.get("documents")
        self.docs: List[List[int]] = []
        if docs:
            drng = np.random.default_rng([seed, 1])
            self.docs = drng.integers(0, vocab, (docs["count"],
                                                 docs["tokens"])).tolist()

    def request(self, client: int, k: int) -> Request:
        r = k % self.per_client
        rng = np.random.default_rng([self.seed, 2, client, k])
        n_prompt = int(self.prompt_len[r, client])
        n_out = int(self.output_len[r, client])
        if k == 0 and self.mix.get("first_request") == "residual":
            n_out = int(self.residual[client])
        prompt = rng.integers(0, self.vocab, n_prompt).tolist()
        doc, prefix = -1, 0
        if self.docs:
            doc = int(rng.integers(0, len(self.docs)))
            prefix = len(self.docs[doc])
            prompt = self.docs[doc] + prompt
        return Request(client, k, prompt, n_out, doc, prefix)

    def warm_requests(self) -> List[Request]:
        """One request a document, prefilled in set-up so that its pages
        are cached: the document and a short question, one reply
        token."""
        out = []
        for d, doc in enumerate(self.docs):
            rng = np.random.default_rng([self.seed, 3, d])
            q = rng.integers(0, self.vocab,
                             self.mix["prompt_tokens"]["min"]).tolist()
            out.append(Request(-1, d, doc + q, 1, d, len(doc)))
        return out

    @property
    def prefill_documents(self) -> bool:
        docs: Optional[Dict] = self.mix.get("documents")
        return bool(docs and docs.get("prefill_in_setup"))
