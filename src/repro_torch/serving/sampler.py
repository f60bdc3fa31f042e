"""Vectorized token sampling (port of `repro.serving.sampler`).

Per ROW greedy / temperature / top-k / top-p over a batch; every knob may
be a scalar or a per-row [B] tensor.  Randomness is the Gumbel-argmax
form of categorical sampling, and the Gumbel noise is an explicit
argument: the scheduler draws each row's noise from a `torch.Generator`
keyed by (request seed, tokens emitted) (`request_noise`), so a request's
stream never depends on the batch it shares, and tests can hand both
frameworks the same noise.  The streams are torch's, not jax's threefry:
bit-identity with the reference's random draws is a later item (ROADMAP,
beside cross-framework envelope import).

`speculative_accept` is the accept rule of draft-and-verify decoding: it
samples every span position from the same per-position stream that
sequential decode would use there, so speculation changes how many tokens
a step emits, never which.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (the public serving surface).

    temperature <= 0 is greedy (argmax); `top_k=0` / `top_p=1.0` disable
    their filters.  `seed=None` derives a per-request stream from the
    server seed and the request uid.  `stop_token_ids`: generation
    finishes (reason "stop") the step a listed id is sampled, and the
    stop token is part of the output.  `logprobs=True` records the
    log-probability (raw, pad-masked distribution) of each sampled token.
    `speculation` caps the drafts verified for this request per step when
    the server runs speculative decoding: None takes the server's k, 0
    opts the request out.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_new_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    logprobs: bool = False
    speculation: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        if self.speculation is not None and self.speculation < 0:
            raise ValueError(f"speculation must be >= 0 (0 disables, "
                             f"None takes the server default), "
                             f"got {self.speculation}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))


_M64 = (1 << 64) - 1


def _stream_seed(seed: int, pos: int) -> int:
    """(seed, position) -> one 32-bit generator seed by a splitmix64 mix
    (torch's CPU generator keeps only the low 32 bits of a seed)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 32


def request_noise(seeds: Sequence[int], positions: Sequence[int], V: int,
                  device) -> torch.Tensor:
    """Gumbel noise [B, V]: row i from a generator seeded by
    (seeds[i], positions[i]) — a pure function of the request's seed and
    how many tokens it has emitted."""
    rows = []
    for s, p in zip(seeds, positions):
        g = torch.Generator(device=device)
        g.manual_seed(_stream_seed(s, p))
        u = torch.rand(V, generator=g, device=device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def sample_with_logprobs(logits: torch.Tensor,
                         noise: Optional[torch.Tensor], *, true_vocab: int,
                         temperature=0.0, top_k=0, top_p=1.0):
    """logits: [B, V_padded] -> (token ids [B] int64, logprobs [B] f32).

    Per row: temperature <= 0 takes the argmax; otherwise the logits are
    temperature-scaled, top-k filtered, top-p filtered over the
    renormalized top-k survivors, and sampled by Gumbel-argmax with that
    row's `noise` [B, V] (may be None when every row is greedy).  Vocab
    padding (ids >= true_vocab) is floored below any noise and can never
    be sampled.  The logprob is log_softmax of the raw pad-masked logits
    at the chosen token, independent of the sampling knobs."""
    B, V = logits.shape
    dev = logits.device
    logits = logits.float()
    invalid = torch.zeros((1, V), dtype=torch.bool, device=dev)
    if true_vocab < V:
        invalid = (torch.arange(V, device=dev) >= true_vocab)[None]
        logits = logits.masked_fill(invalid, NEG)
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=dev).expand(B)
    tks = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(B)
    tps = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(B)

    toks = logits.argmax(dim=-1)
    if bool((temps > 0.0).any()):
        if noise is None:
            raise ValueError("stochastic rows need Gumbel noise")
        # re-floor invalid lanes AFTER the division so huge temperatures
        # cannot lift padding into noise range
        safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
        scaled = (logits / safe_t[:, None]).masked_fill(invalid, NEG)
        sorted_desc = -torch.sort(-scaled, dim=-1).values
        kth = torch.gather(sorted_desc, 1,
                           (tks - 1).clamp(0, V - 1)[:, None])
        keep_k = (tks <= 0)[:, None] | (scaled >= kth)
        # top-p over the top-k survivors: a token survives iff the mass
        # BEFORE it is < top_p (the argmax always survives)
        eff_k = torch.where(tks <= 0, torch.full_like(tks, V), tks)[:, None]
        sorted_f = torch.where(torch.arange(V, device=dev)[None] < eff_k,
                               sorted_desc, torch.full_like(sorted_desc, NEG))
        p_sorted = torch.softmax(sorted_f, dim=-1)
        mass_before = torch.cumsum(p_sorted, dim=-1) - p_sorted
        n_keep = (mass_before < tps[:, None]).sum(dim=-1)
        pth = torch.gather(sorted_f, 1, (n_keep - 1).clamp(0, V - 1)[:, None])
        keep = keep_k & ((tps >= 1.0)[:, None] | (scaled >= pth))
        masked = torch.where(keep & ~invalid, scaled,
                             torch.full_like(scaled, NEG))
        stoch = (masked + noise.to(dev).float()).argmax(dim=-1)
        toks = torch.where(temps > 0.0, stoch, toks)
    lps = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                       toks[:, None])[:, 0]
    return toks, lps


def speculative_accept(logits: torch.Tensor, drafts: torch.Tensor,
                       seeds: Sequence[int], positions: Sequence[int],
                       allowed: torch.Tensor, *, true_vocab: int,
                       temperature=0.0, top_k=0, top_p=1.0):
    """Draft-and-verify acceptance over a span (port of the reference's
    `speculative_accept`).

    logits: [B, S, V], position j scoring the j-th span input (the last
    emitted token for j = 0, drafts after it), so logits[:, j] is the
    target distribution of output token ``positions + j``; drafts: [B,
    S-1]; seeds / positions: host [B] stream state (tokens emitted so
    far); allowed: [B] cap on accepted drafts (0: a plain decode step);
    temperature / top_k / top_p: scalars or host [B] arrays.

    Every span position is sampled from `request_noise(seed, positions +
    j)`, the stream sequential decode uses at that position, and draft j
    is accepted while the sampled token equals it; the emitted tokens are
    the sampled ones.  Returns (tokens [B, S], logprobs [B, S], acc [B]):
    row i emits ``tokens[i, :acc[i] + 1]``."""
    B, S, V = logits.shape
    dev = logits.device

    def rows(a, dtype):
        return np.repeat(np.broadcast_to(np.asarray(a, dtype), (B,)), S)

    temps = rows(temperature, np.float32)
    noise = None
    if (temps > 0).any():
        pos = (np.asarray(positions, np.int64)[:, None]
               + np.arange(S)[None]).reshape(-1)
        noise = request_noise(rows(seeds, np.int64), pos, V, dev)
    toks, lps = sample_with_logprobs(
        logits.reshape(B * S, V), noise, true_vocab=true_vocab,
        temperature=torch.as_tensor(temps, device=dev),
        top_k=torch.as_tensor(rows(top_k, np.int64), device=dev),
        top_p=torch.as_tensor(rows(top_p, np.float32), device=dev))
    toks, lps = toks.reshape(B, S), lps.reshape(B, S)
    match = ((toks[:, :-1] == drafts.to(toks.dtype))
             & (torch.arange(S - 1, device=dev)[None]
                < allowed.to(dev)[:, None]))
    acc = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
    return toks, lps, acc
