"""Flash attention under autograd: kernel B4's forward, the backward in
torch ops.

The reference has no backward kernel (no `custom_vjp` anywhere in it):
its gradients are XLA's autodiff of the jnp attention.  Here the forward
of a training step runs B4 (`flash_attention_cuda`) through
`FlashAttentionFn`, which saves q, k, v and the output; the backward is
the standard attention gradient, computed from them in float32 (float64
for float64 inputs) one block of keys at a time, so its memory is
O(Sq · block) a head:

    P  = softmax(scale · q kᵀ + mask)      recomputed from the row
                                           log-sum-exp (a first pass)
    dV = Pᵀ dO          dP = dO Vᵀ          D = rowsum(dO ∘ O)
    dS = P ∘ (dP − D)   dQ = scale · dS K   dK = scale · dSᵀ Q

with the causal, window and q_offset masks B4 applies (a masked score is
the plain version's finite NEG_INF, so a row with no valid key is the
same uniform average there).  Under GQA, dK and dV sum over the G query
heads of each kv head.  No plain forward runs: the only output used is
the kernel's.

`FlashAttentionFn.apply(q, k, v, causal, window, q_offset, forward)`
takes the forward as its last argument: B4 on a card
(`ops.flash_attention` passes `flash_attention_cuda` when grad mode is
on and an input requires grad), the plain version in the CPU tests that
hold the backward's formulas.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention.ref import NEG_INF, _mask

BLOCK_K = 512                     # keys a block of the backward's walk


def _heads(x: torch.Tensor, K: int, ct) -> torch.Tensor:
    """[B, S, K·G, dh] -> [B, K, G, S, dh] in the compute dtype."""
    B, S, H, dh = x.shape
    return x.to(ct).reshape(B, S, K, H // K, dh).permute(0, 2, 3, 1, 4)


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0,
                             block_k: int = BLOCK_K):
    """(dq, dk, dv) of o = attention(q, k, v) for the output gradient
    dout.  q/out/dout [B, Sq, H, dh], k/v [B, Sk, K, dh]; the gradients
    come back in the inputs' dtypes."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = dh ** -0.5
    qs = _heads(q, K, ct) * scale                        # [B, K, G, Sq, dh]
    do = _heads(dout, K, ct)
    D = (do * _heads(out, K, ct)).sum(-1)                 # [B, K, G, Sq]
    kf = k.to(ct).permute(0, 2, 1, 3)                     # [B, K, Sk, dh]
    vf = v.to(ct).permute(0, 2, 1, 3)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    spans = [(c0, min(c0 + block_k, Sk)) for c0 in range(0, Sk, block_k)]

    def scores(c0, c1):
        k_pos = torch.arange(c0, c1, device=q.device)
        mask = _mask(q_pos, k_pos, Sk, causal=causal, window=window,
                     is_global=None)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kf[:, :, c0:c1])
        return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask

    # pass 1: each row's log-sum-exp over every key block
    m = torch.full(D.shape, NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros_like(m)
    for c0, c1 in spans:
        s, _ = scores(c0, c1)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    lse = (m + torch.log(l))[..., None]
    # pass 2: the gradients, block by block
    dq = torch.zeros_like(qs)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for c0, c1 in spans:
        s, mask = scores(c0, c1)
        p = torch.exp(s - lse)                            # [B, K, G, Sq, c]
        kb, vb = kf[:, :, c0:c1], vf[:, :, c0:c1]
        dv[:, :, c0:c1] = torch.einsum("bkgqc,bkgqd->bkcd", p, do)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", do, vb)
        ds = torch.where(mask, p * (dp - D[..., None]), torch.zeros_like(p))
        dq += torch.einsum("bkgqc,bkcd->bkgqd", ds, kb)
        dk[:, :, c0:c1] = torch.einsum("bkgqc,bkgqd->bkcd", ds, qs)
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """o = forward(q, k, v, causal=, window=, q_offset=), differentiable
    through `flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                q_offset: int, forward: Callable):
        out = forward(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout, causal=ctx.causal, window=ctx.window,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None
