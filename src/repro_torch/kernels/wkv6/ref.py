"""Plain torch versions of the RWKV6 wkv recurrence (port of
`repro.models.rwkv6.wkv_recurrent` / `wkv_chunked`, which
`repro.kernels.wkv6.ref` re-exports).

Per head, per step (state S [dh_k, dh_v], decay and bonus per k-channel):

    out_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ)
    S_t   = diag(e^{logw_t}) S_{t-1} + k_t v_tᵀ

`wkv_recurrent` is the token-by-token scan (the oracle, and the decode
path); `wkv_chunked` the reference's chunked parallel form, copied with
its cumprod factorization and its zero padding of a ragged S.  That
factorization multiplies `e^{cum_excl}` by `e^{-cum}`, and `e^{-cum}`
overflows float32 once the chunk's summed log-decay passes ~88: at chunk
32 it is exact only for |logw| below ~2.8 (ROADMAP §C), a fault of the
reference kept here so the two packages agree.  `wkv_chunked` is the CPU
path of `wkv6` and the version kernel B5 is held against on the card;
at strong decay B5 is held against `wkv_recurrent`.

`wkv_chunk_parallel` is the plain version of B5's own split (the
pivoted local pass of every chunk at once, the state carry over chunks,
the correction of each chunk's output by its incoming state), finite
over the model's whole decay range.

Layouts are the reference's: r/k/v/logw [B, S, H, dh], u [H, dh], state
[B, H, dh, dh]; both return (out [B, S, H, dh] in r's dtype, state f32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32


def wkv_recurrent(r, k, v, logw, u, state):
    """Token-by-token scan (oracle + decode path)."""
    rf, kf, vf, lw = (a.float() for a in (r, k, v, logw))
    S0 = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 S0 + u[None, :, :, None] * kv))
        S0 = torch.exp(lw[:, t])[..., None] * S0 + kv
    return torch.stack(outs, 1).to(r.dtype), S0


def wkv_chunked(r, k, v, logw, u, state, chunk: int = CHUNK):
    """Chunked parallel form (cumprod factorization); == recurrent where
    it does not overflow (see the module docstring)."""
    B, S, H, dh = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    n = r.shape[1] // chunk
    shp = (B, n, chunk, H, dh)
    rf, kf, vf, lw = (a.float().reshape(shp) for a in (r, k, v, logw))

    # cumulative log-decay within chunk; a_t = exp(cum_t) (exclusive)
    cum = torch.cumsum(lw, dim=2)                             # inclusive
    cum_excl = cum - lw                                       # exclusive
    total = cum[:, :, -1]                                     # [B, n, H, dh]

    r_a = rf * torch.exp(cum_excl)                            # r_t · a_t
    k_b = kf * torch.exp(-cum)                                # k_i / (a_i w_i)
    k_last = kf * torch.exp(total[:, :, None] - cum)          # state update

    # intra-chunk attention-like term: A[t,i] = (r_t a_t)·(k_i e^{-cum_i}), i<t
    A = torch.einsum("bnthd,bnihd->bnhti", r_a, k_b)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    A = torch.where(tri, A, torch.zeros((), device=r.device))
    intra = torch.einsum("bnhti,bnihd->bnthd", A, vf)
    # bonus term (current token through u)
    diag = torch.einsum("bnthk,hk,bnthk->bnth", rf, u, kf)
    intra = intra + diag[..., None] * vf

    # inter-chunk: out += (r_t a_t) S_chunk_start
    S0 = state.float()
    inters = []
    for c in range(n):
        inters.append(torch.einsum("bthk,bhkv->bthv", r_a[:, c], S0))
        kv = torch.einsum("bthk,bthv->bhkv", k_last[:, c], vf[:, c])
        S0 = torch.exp(total[:, c])[..., None] * S0 + kv
    out = intra + torch.stack(inters, 1)
    out = out.reshape(B, n * chunk, H, dh)[:, :S]
    return out.to(r.dtype), S0


def pivot_row(chunk: int) -> int:
    """The row whose cumulative decay B5 factors each chunk around."""
    return max(chunk // 2 - 1, 0)


def wkv_chunk_parallel(r, k, v, logw, u, state, chunk: int = CHUNK):
    """Kernel B5's decomposition in plain torch.

    Local pass, for every chunk c at once (cum the inclusive cumulative
    log-decay inside the chunk, ce = cum - logw the exclusive one, p the
    cum of row `pivot_row(chunk)`, tot the chunk's total):

        intra_c = (A ⊙ tril) v + diag(r·u·k) v,  A = ra kbᵀ,
                  ra = r e^{ce - p}, kb = k e^{p - cum}
        rs_c    = r e^{ce}
        dS_c    = (k e^{tot - cum})ᵀ v

    Each factor spans at most half a chunk of decay, so none overflows
    where the reference's e^{-cum} does; the pairs s >= t are discarded
    by a select.  The decay is scanned in float64 and taken relative to
    the pivot before it is rounded to float32, d = f32(cum - p): a
    float32 cumsum carries an error of ~eps·|cum| into every exponent
    (|cum| reaches 130 in a chunk of 32), which the near-diagonal scores,
    whose true exponent is near 0, would take as a relative error of up
    to ~1e-4.  Then, in float32 as the kernel does it: ce - p = d of the
    row before (-p at row 0), ce = (ce - p) + p, tot - cum = (tot - p) -
    d.  The carry walks the chunks from S_0 = state: out_c = intra_c +
    rs_c S_c, S_{c+1} = e^{tot_c} S_c + dS_c (a lone chunk: B5's local
    pass does this step itself).  A ragged S is zero-padded (no decay, no
    value), so the returned state is the one after the last valid
    token."""
    B, S, H, dh = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    n = r.shape[1] // chunk
    shp = (B, n, chunk, H, dh)
    rf, kf, vf, lw = (a.float().reshape(shp) for a in (r, k, v, logw))

    cum = torch.cumsum(lw.double(), dim=2)
    piv = cum[:, :, pivot_row(chunk)][:, :, None]
    d = (cum - piv).float()                                   # cum - p
    dex = torch.cat([(-piv).float(), d[:, :, :-1]], dim=2)    # ce - p
    p32 = piv.float()
    tot_p = (cum[:, :, -1:] - piv).float()                    # tot - p

    ra = rf * torch.exp(dex)
    kb = kf * torch.exp(-d)
    rs = rf * torch.exp(dex + p32)
    kl = kf * torch.exp(tot_p - d)
    etot = torch.exp(cum[:, :, -1].float())                   # [B, n, H, dh]

    A = torch.einsum("bnthd,bnihd->bnhti", ra, kb)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    A = torch.where(tri, A, torch.zeros((), device=r.device))
    intra = torch.einsum("bnhti,bnihd->bnthd", A, vf)
    diag = torch.einsum("bnthk,hk,bnthk->bnth", rf, u.float(), kf)
    intra = intra + diag[..., None] * vf
    dS = torch.einsum("bnthk,bnthv->bnhkv", kl, vf)           # [B, n, H, dh, dh]

    S0 = state.float()
    outs = []
    for c in range(n):
        outs.append(intra[:, c] + torch.einsum("bthk,bhkv->bthv", rs[:, c],
                                               S0))
        S0 = etot[:, c][..., None] * S0 + dS[:, c]
    out = torch.stack(outs, 1).reshape(B, n * chunk, H, dh)[:, :S]
    return out.to(r.dtype), S0
