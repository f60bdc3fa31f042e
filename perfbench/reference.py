"""The plain PyTorch reference of the served decoders.

A Mistral-family decoder (pre-norm, RoPE split-half, GQA, SwiGLU or a
top-k MoE of SwiGLU experts, RMSNorm, untied LM head) computed in
float32 with TF32 off, from the raw weights of `weights.py`.  It imports
nothing of the program, of the JAX package or of JAX.

It computes the precision that the configurations state, at the points
where they state it:

  * W4A16: every weight is int4 code x float32 scale.  A 2-D projection
    (attention's wo; the dense SwiGLU's gate, up and down) takes its
    input rounded to bfloat16, then sums code products in float32 and
    scales the sums.  The per-head q/k/v projections and the experts
    take float32 inputs on weights dequantized to float32.
  * bf16 KV pages: a key or value read back from the cache is its
    bfloat16 rounding; the score against it uses q x dh^-0.5 rounded to
    bfloat16, and the unnormalized probabilities are rounded to
    bfloat16 before they weight the values (sums in float32).  A prompt
    chunk attends to its own keys before they are stored, in float32,
    and to the earlier positions through the cache; the two parts are
    merged by their log-sum-exp.  A decoded token is stored first and
    attends to every position, itself included, through the cache.
  * chunked prefill: a prompt is prefilled in chunks of `chunk` tokens
    on a grid from position 0 (a cached prefix ends on the grid).  An
    MoE layer routes each prompt chunk as one call padded to `chunk`
    rows, so an expert holds at most C = ceil(capacity_factor x top_k x
    chunk / n_experts) of the chunk's (token, choice) pairs, taken in
    token order; a decoded token is a call of one row (C = 1).  A
    dropped pair adds nothing.

A forward runs layer by layer over every sequence at once, so only one
layer's dequantized weights live at a time; a shared prefix (a document)
is computed once per layer and its keys and values serve every sequence
that continues it, which is the full forward of each sequence since
attention is causal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench.weights import Packed, dequant, unpack

NEG = -1e30


@dataclass
class Seq:
    """One part of a forward: `tokens` at positions p0 .. p0 + len - 1.
    Positions below `n_prompt` are prompt (chunked prefill), the rest
    decoded tokens.  `prefix` indexes the part whose keys and values
    come first (p0 is then that part's length); logits are returned for
    positions >= `logits_from` (none when it is None)."""
    tokens: torch.Tensor
    p0: int
    n_prompt: int
    prefix: Optional[int] = None
    logits_from: Optional[int] = None


def r16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 rounding, kept in float32."""
    return x.to(torch.bfloat16).float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [N, heads, dh] at positions pos [N], split-half rotation."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def gemv_w4a16(x: torch.Tensor, w: Packed) -> torch.Tensor:
    """A 2-D W4A16 projection: bf16(x) @ codes, float32 sums, x scale."""
    return torch.matmul(r16(x), unpack(w.codes)) * w.scale


def _partial(q, k, v, qpos, kpos, cached: bool):
    """One attention partial of q [S, K, G, dh] (already x dh^-0.5) over
    k, v [T, K, dh] at positions kpos, causal -> (o [S, K, G, dh] locally
    normalized, m, l [S, K, G])."""
    if cached:
        q = r16(q)
    s = torch.einsum("skgd,tkd->kgst", q, k)
    mask = kpos[None, :] <= qpos[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("kgst,tkd->skgd", r16(p) if cached else p, v)
    o = o / l.clamp_min(1e-30).permute(2, 0, 1)[..., None]
    return o, m.permute(2, 0, 1), l.permute(2, 0, 1)


def _merge(a, b):
    (o1, m1, l1), (o2, m2, l2) = a, b
    mx = torch.maximum(m1, m2)
    w1, w2 = l1 * torch.exp(m1 - mx), l2 * torch.exp(m2 - mx)
    return (o1 * w1[..., None] + o2 * w2[..., None]) / (w1 + w2)[..., None]


class Reference:
    """`model`: a configuration's "model" block; `w`: `weights.draw`'s
    tree; `chunk`: the prefill chunk of the cell."""

    def __init__(self, model: Dict, w: Dict, chunk: int, block: int = 512):
        self.m, self.w, self.chunk, self.block = model, w, chunk, block
        self.dropped_pairs = 0
        self.routed_pairs = 0

    # -- attention ------------------------------------------------------
    def _attend(self, q, k, v, seq: Seq, past) -> torch.Tensor:
        """q [N, H, dh], k/v [N, K, dh] of `seq` (roped, float32); past:
        the prefix's bf16-rounded (k, v) or None -> o [N, H * dh]."""
        N, H, dh = q.shape
        K = k.shape[1]
        q = (q * dh ** -0.5).reshape(N, K, H // K, dh)
        kb, vb = r16(k), r16(v)
        if past is not None:
            kb, vb = torch.cat([past[0], kb]), torch.cat([past[1], vb])
        p_start = seq.p0 if past is None else 0
        allpos = torch.arange(p_start, seq.p0 + N, device=q.device)
        out = torch.empty_like(q)
        a = seq.p0
        while a < seq.p0 + N:
            if a < seq.n_prompt:
                b = min((a // self.chunk + 1) * self.chunk, seq.n_prompt,
                        seq.p0 + N)
            else:
                b = min(a + self.block, seq.p0 + N)
            i0, i1 = a - seq.p0, b - seq.p0
            qpos = torch.arange(a, b, device=q.device)
            if a < seq.n_prompt:
                c0 = (a // self.chunk) * self.chunk
                j0 = c0 - seq.p0
                own = _partial(q[i0:i1], k[j0:i1], v[j0:i1], qpos,
                               qpos.new_tensor(range(c0, b)), False)
                if c0 > 0:
                    n_past = c0 - p_start
                    past_part = _partial(q[i0:i1], kb[:n_past], vb[:n_past],
                                         qpos, allpos[:n_past], True)
                    out[i0:i1] = _merge(own, past_part)
                else:
                    out[i0:i1] = own[0]
            else:
                n_keys = b - p_start
                out[i0:i1] = _partial(q[i0:i1], kb[:n_keys], vb[:n_keys],
                                      qpos, allpos[:n_keys], True)[0]
            a = b
        return out.reshape(N, H * dh)

    # -- feed-forward ---------------------------------------------------
    def _groups(self, seq: Seq, N: int):
        """Row ranges of `seq` that an MoE routes as one call, with the
        padded length of that call."""
        out, a = [], seq.p0
        while a < seq.p0 + N:
            if a < seq.n_prompt:
                b = min((a // self.chunk + 1) * self.chunk, seq.n_prompt,
                        seq.p0 + N)
                out.append((a - seq.p0, b - seq.p0, self.chunk))
            else:
                b = a + 1
                out.append((a - seq.p0, b - seq.p0, 1))
            a = b
        return out

    def _moe_plan(self, x: torch.Tensor, router: torch.Tensor, seq: Seq):
        """(top experts [N, k], gates [N, k], kept [N, k])."""
        m = self.m
        E, k = m["n_experts"], m["top_k"]
        gates = torch.softmax(x @ router, dim=-1)
        vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
        kept = torch.zeros_like(idx, dtype=torch.bool)
        for i0, i1, padded in self._groups(seq, x.shape[0]):
            cap = max(1, math.ceil(m["capacity_factor"] * k * padded / E))
            fe = idx[i0:i1].reshape(-1)                 # token-major pairs
            onehot = F.one_hot(fe, E)
            rank = (onehot.cumsum(0) - onehot).gather(1, fe[:, None])[:, 0]
            kept[i0:i1] = (rank < cap).reshape(i1 - i0, k)
        self.routed_pairs += kept.numel()
        self.dropped_pairs += int((~kept).sum())
        return idx, vals, kept

    def _mlp(self, lw: Dict, x: torch.Tensor) -> torch.Tensor:
        g = gemv_w4a16(x, lw["gate"])
        u = gemv_w4a16(x, lw["up"])
        return gemv_w4a16(F.silu(g) * u, lw["down"])

    # -- forward --------------------------------------------------------
    @torch.no_grad()
    def forward(self, seqs: List[Seq]) -> List[Optional[torch.Tensor]]:
        """Logits [positions >= logits_from, V] of each part (None where
        none are asked).  Prefix parts come before the parts that
        continue them."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._forward(seqs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    def _forward(self, seqs: List[Seq]):
        for s in seqs:
            if s.prefix is not None and s.p0 % self.chunk:
                raise ValueError("a cached prefix must end on the chunk "
                                 f"grid: {s.p0} tokens, chunks of "
                                 f"{self.chunk}")
        m, w = self.m, self.w
        eps, theta = m["norm_eps"], m["rope_theta"]
        L, H, dh = m["n_layers"], m["n_heads"], m["d_head"]
        moe = bool(m.get("n_experts", 0))
        xs = [w["embedding"][s.tokens] for s in seqs]
        pos = [torch.arange(s.p0, s.p0 + len(s.tokens), device=xs[0].device)
               for s in seqs]
        for li in range(L):
            lw = {k: (Packed(v.codes[li], v.scale[li])
                      if isinstance(v, Packed) else v[li])
                  for k, v in w["layers"].items()}
            wq, wk, wv = (dequant(lw[n]) for n in ("wq", "wk", "wv"))
            kv: Dict[int, tuple] = {}
            plans = []
            for i, s in enumerate(seqs):
                a = rms_norm(xs[i], lw["ln1"], eps)
                N = a.shape[0]
                q = torch.einsum("nd,kdf->nkf", a, wq).reshape(N, H, dh)
                k = torch.einsum("nd,kdf->nkf", a, wk)
                v = torch.einsum("nd,kdf->nkf", a, wv)
                q, k = rope(q, pos[i], theta), rope(k, pos[i], theta)
                past = kv[s.prefix] if s.prefix is not None else None
                o = self._attend(q, k, v, s, past)
                xs[i] = xs[i] + gemv_w4a16(o, lw["wo"])
                kv[i] = (r16(k), r16(v))
                a = rms_norm(xs[i], lw["ln2"], eps)
                if moe:
                    plans.append((a, self._moe_plan(a, lw["router"], s)))
                else:
                    xs[i] = xs[i] + self._mlp(lw, a)
            del wq, wk, wv, kv
            if moe:
                self._experts(lw, xs, plans)
        out = []
        for i, s in enumerate(seqs):
            if s.logits_from is None:
                out.append(None)
                continue
            x = xs[i][s.logits_from - s.p0:]
            x = rms_norm(x, w["final_norm"], eps)
            out.append(x @ w["lm_head"].t())
        return out

    def _experts(self, lw, xs, plans):
        """Each expert's SwiGLU on its kept pairs, one expert's float32
        weights at a time; a token's output sums its choices in order."""
        E, k = self.m["n_experts"], self.m["top_k"]
        ys = [torch.zeros((a.shape[0], k, a.shape[1]), device=a.device)
              for a, _ in plans]
        for e in range(E):
            wg = dequant(Packed(lw["w_gate"].codes[e], lw["w_gate"].scale[e]))
            wu = dequant(Packed(lw["w_up"].codes[e], lw["w_up"].scale[e]))
            wd = dequant(Packed(lw["w_down"].codes[e], lw["w_down"].scale[e]))
            for (a, (idx, vals, kept)), y in zip(plans, ys):
                t, c = torch.nonzero((idx == e) & kept, as_tuple=True)
                if t.numel() == 0:
                    continue
                h = a[t]
                out = (F.silu(h @ wg) * (h @ wu)) @ wd
                y[t, c] = out * vals[t, c][:, None]
            del wg, wu, wd
        for i, y in enumerate(ys):
            xs[i] = xs[i] + y.sum(1)
