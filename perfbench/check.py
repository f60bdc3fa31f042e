"""The comparison that decides `correct`.  Nothing here imports the
program.

Once the window has closed and the program's state is freed, a sample
of the requests the server finished in the window is drawn from the seed:
the one with the most served tokens, then others in the seed's order
(those that share its document first, so that one document's forward
serves them) until `sample_tokens` served tokens and `sample_requests`
requests are in (or none is left).  The plain
reference (`reference.py`) runs once over each prompt followed by its
served tokens.  For every served token (greedy), the gap is how far its
logit lies below the reference's best logit at that position, and the
logprob error how far the program's logprob of it lies from the
reference's.  The numbers a cell compares, each with its limit in the
cell's file: `logit_gap`, the widest gap of the sample, and, where that
alone does not separate a sound run from the control,
`logprob_err_median`, the median logprob error, and
`logprob_err_req_max`, the largest of the requests' own median logprob
errors, which a fault that touches any one request of the sample fails.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import Reference, Seq


def draw_sample(finished: List, seed: int, sample_tokens: int,
                sample_requests: int = 1) -> List:
    """`finished`: records with .tokens, .logprobs, .req
    (traffic.Request)."""
    if not finished:
        return []
    rng = np.random.default_rng([seed, 7])
    longest = max(finished, key=lambda r: (len(r.tokens), len(r.req.prompt),
                                           -r.uid))
    rest = [finished[i] for i in rng.permutation(len(finished))
            if finished[i] is not longest]
    rest.sort(key=lambda r: r.req.doc != longest.req.doc)   # stable
    out, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= sample_tokens and len(out) >= sample_requests:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def compare(model: Dict, weights: Dict, sample: List, chunk: int,
            device) -> Dict:
    """Run the reference over the sample -> {"logit_gap",
    "logprob_err_median", "logprob_err_req_max", "logprob_err_max",
    "mismatch" (the share of served tokens off the reference's argmax),
    "tokens", "requests", "dropped_pairs", "routed_pairs"}."""
    seqs: List[Seq] = []
    prefix_of: Dict[int, int] = {}
    owners = []
    for r in sample:
        prompt, served = r.req.prompt, r.tokens
        n = len(prompt)
        if r.req.doc >= 0:
            if r.req.doc not in prefix_of:
                prefix_of[r.req.doc] = len(seqs)
                doc = prompt[:r.req.prefix_len]
                seqs.append(Seq(torch.tensor(doc, device=device), 0,
                                len(doc)))
            p0 = r.req.prefix_len
            toks = prompt[p0:] + served[:-1]
            seqs.append(Seq(torch.tensor(toks, device=device), p0, n,
                            prefix=prefix_of[r.req.doc], logits_from=n - 1))
        else:
            seqs.append(Seq(torch.tensor(prompt + served[:-1], device=device),
                            0, n, logits_from=n - 1))
        owners.append(len(seqs) - 1)
    ref = Reference(model, weights, chunk)
    if not seqs:
        return {"logit_gap": 0.0, "logprob_err_median": 0.0,
                "logprob_err_req_max": 0.0, "logprob_err_max": 0.0,
                "mismatch": 0.0, "tokens": 0, "requests": 0,
                "dropped_pairs": 0, "routed_pairs": 0}
    logits = ref.forward(seqs)
    gaps, errs = [], []
    for r, i in zip(sample, owners):
        lg = logits[i]
        rows = torch.arange(len(r.tokens), device=lg.device)
        tok = torch.tensor(r.tokens, device=lg.device)
        gaps.append(lg.max(-1).values - lg[rows, tok])
        lp = torch.log_softmax(lg, dim=-1)[rows, tok]
        errs.append((lp - torch.tensor(r.logprobs, device=lg.device)).abs())
    req_err = max(float(e.median()) for e in errs)
    gaps, errs = torch.cat(gaps), torch.cat(errs)
    return {"logit_gap": float(gaps.max()),
            "logprob_err_median": float(errs.median()),
            "logprob_err_req_max": req_err,
            "logprob_err_max": float(errs.max()),
            "mismatch": float((gaps > 0).float().mean()),
            "tokens": len(gaps), "requests": len(sample),
            "dropped_pairs": ref.dropped_pairs,
            "routed_pairs": ref.routed_pairs}
