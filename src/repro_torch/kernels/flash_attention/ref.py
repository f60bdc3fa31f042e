"""Plain torch versions of flash attention (port of
`repro.kernels.flash_attention.ref`).

`flash_attention_ref` is the blocked online softmax over k chunks, with
the reference's numerics: q·scale in float32, the finite NEG_INF = -1e30
for masked scores, `l` clamped at 1e-30, the output cast back to q's
dtype.  It is the CPU path of `flash_attention` and the version kernel B4
is held against on the card.  `dense_attention_ref` is the naive softmax
oracle of both.

Layouts are the reference's public ones: q [B, Sq, H, dh], k/v
[B, Sk, K, dh]; query head h reads kv head h // (H / K).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _expand_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, K, dh] -> [B, S, K*G, dh] by repeating each KV head G times."""
    if groups == 1:
        return x
    return x.repeat_interleave(groups, dim=2)


def _mask(q_pos, k_pos, Sk: int, *, causal, window, is_global):
    """[Sq, n] validity of (query, key) pairs, as the reference masks them."""
    mask = (k_pos < Sk)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        in_window = k_pos[None, :] > q_pos[:, None] - window
        if is_global is not None:
            in_window = in_window | torch.as_tensor(is_global,
                                                    device=q_pos.device)
        mask = mask & in_window
    return mask


def _q_positions(q_offset, Sq: int, device) -> torch.Tensor:
    return torch.as_tensor(q_offset, device=device) + torch.arange(
        Sq, device=device)


def flash_attention_ref(
    q: torch.Tensor,                # [B, Sq, H, dh]
    k: torch.Tensor,                # [B, Sk, K, dh]
    v: torch.Tensor,                # [B, Sk, K, dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,   # sliding window (tokens), None = full
    q_offset=0,                     # absolute position of q[0] (int/tensor)
    chunk_k: int = 512,
    is_global=None,                 # optional bool overriding the window
) -> torch.Tensor:
    """Blocked attention with online softmax; GQA and sliding window."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    groups = H // K
    orig_dtype = q.dtype
    scale = dh ** -0.5
    qf = (q.float() * scale).transpose(1, 2)                  # [B, H, Sq, dh]
    kf = _expand_kv(k, groups).float().transpose(1, 2)        # [B, H, Sk, dh]
    vf = _expand_kv(v, groups).float().transpose(1, 2)
    q_pos = _q_positions(q_offset, Sq, q.device)
    chunk_k = min(chunk_k, Sk)
    pad = -Sk % chunk_k
    if pad:                        # zero keys, masked by k_pos < Sk
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk + pad, chunk_k):
        kb, vb = kf[:, :, c0:c0 + chunk_k], vf[:, :, c0:c0 + chunk_k]
        k_pos = c0 + torch.arange(chunk_k, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        mask = _mask(q_pos, k_pos, Sk, causal=causal, window=window,
                     is_global=is_global)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(orig_dtype)                 # [B, Sq, H, dh]


def dense_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        is_global=None):
    """Naive dense softmax attention — the oracle of the oracle."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    k = _expand_kv(k, H // K)
    v = _expand_kv(v, H // K)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
    q_pos = _q_positions(q_offset, Sq, q.device)
    mask = _mask(q_pos, torch.arange(Sk, device=q.device), Sk, causal=causal,
                 window=window, is_global=is_global)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
