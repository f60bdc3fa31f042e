"""Core layers and the parameter initializer (port of `repro.models.layers`).

Parameters are the reference's tree, as plain nested dicts of tensors:
`bridge.params_from_numpy` carries a reference tree over leaf for leaf,
and `ParamInit` draws a fresh one with the reference's initializers from
an explicit `torch.Generator` (same shapes and scales, different random
numbers — torch's generator is not jax's threefry).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantizedWeight, dequantize
from repro_torch.kernels.quant_gemv import quant_gemv

# ---------------------------------------------------------------------------
# Parameter init (counterpart of ParamBuilder's fan-in normal init)
# ---------------------------------------------------------------------------


class ParamInit:
    """Builds a parameter tree and its logical-axis spec tree with the
    reference initializers (`ParamBuilder`).

    `param` mirrors `ParamBuilder.param`: "zeros", "ones", or a fan-in
    scaled normal (fan_in = shape[0] for 1-D, else shape[-2]) drawn in
    float32 on `device` from `generator`, then cast to `dtype`; `axes`
    (one logical name or None a dimension) goes into `specs`.
    `stack` prepends a layer axis WITHOUT changing fan-in, as the
    reference's vmapped per-layer init does, and "layer" to each spec.
    On the meta device nothing is drawn or allocated (`generator` may be
    None): the leaves carry shapes and dtypes only.
    """

    def __init__(self, generator: Optional[torch.Generator], device,
                 stack: int = 0, dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.stack = stack
        self.dtype = dtype
        self.params: Dict[str, Any] = {}
        self.specs: Dict[str, Any] = {}

    def param(self, name: str, shape: Sequence[int],
              axes: Sequence[Optional[str]], *, init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {tuple(shape)}, axes {axes}")
        lead = (self.stack,) if self.stack else ()
        full = lead + tuple(shape)
        if self.device.type == "meta":
            val = torch.empty(full, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            val = torch.zeros(full, dtype=self.dtype, device=self.device)
        elif init == "ones":
            val = torch.ones(full, dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) == 1 else shape[-2]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            val = (torch.randn(full, generator=self.generator,
                               device=self.device) * scale).to(self.dtype)
        self.params[name] = val
        self.specs[name] = (("layer",) if self.stack else ()) + tuple(axes)
        return val

    def scope(self, name: str) -> "ParamInit":
        sub = ParamInit(self.generator, self.device, self.stack, self.dtype)
        self.params[name] = sub.params
        self.specs[name] = sub.specs
        return sub


def layer_slice(tree, i: int):
    """Per-layer view of a stacked parameter tree (leading layer axis)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with a `1 + w` scale, computed in float32."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int).

    Split-half rotation with the angles in float32."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)           # [half]
    angles = positions[..., :, None].float() * freqs            # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]                    # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def init_dense(b: ParamInit, name: str, in_dim: int, out_dim: int,
               axes: Tuple[Optional[str], Optional[str]],
               bias: bool = False):
    b.param(f"{name}_w", (in_dim, out_dim), axes)
    if bias:
        b.param(f"{name}_b", (out_dim,), (axes[1],), init="zeros")


def dense(params: Dict[str, Any], name: str, x: torch.Tensor, *,
          impl: str = "auto") -> torch.Tensor:
    """`x @ w (+ b)`.  A float weight is a plain matrix product, left to
    torch.matmul as the reference leaves it to XLA; a quantized weight goes
    through `quant_gemv` (kernel B3 on a card; impl="ref" asks for its
    plain version on any device)."""
    w = params[f"{name}_w"]
    if isinstance(w, QuantizedWeight):
        y = quant_gemv(x, w, impl=impl)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    b = params.get(f"{name}_b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_mlp(b: ParamInit, d_model: int, d_ff: int, gated: bool):
    if gated:
        init_dense(b, "gate", d_model, d_ff, ("embed", "mlp"))
    init_dense(b, "up", d_model, d_ff, ("embed", "mlp"))
    init_dense(b, "down", d_ff, d_model, ("mlp", "embed"))


def mlp(params: Dict[str, Any], x: torch.Tensor, gated: bool, *,
        impl: str = "auto") -> torch.Tensor:
    if gated:
        h = (F.silu(dense(params, "gate", x, impl=impl))
             * dense(params, "up", x, impl=impl))
    else:
        h = F.gelu(dense(params, "up", x, impl=impl), approximate="tanh")
    return dense(params, "down", h, impl=impl)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based top-k dispatch, per batch row)
# ---------------------------------------------------------------------------

def init_moe(b: ParamInit, d_model: int, d_ff: int, n_experts: int):
    b.param("router_w", (d_model, n_experts), ("embed", None))
    b.param("w_gate", (n_experts, d_model, d_ff),
            ("expert", "embed", "moe_mlp"))
    b.param("w_up", (n_experts, d_model, d_ff),
            ("expert", "embed", "moe_mlp"))
    b.param("w_down", (n_experts, d_ff, d_model),
            ("expert", "moe_mlp", "embed"))


def moe_capacity(seq_len: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert and batch row: C = max(1, ceil(f · k · S / E)),
    taken from the padded length S of the call, as in the reference."""
    return max(1, math.ceil(capacity_factor * top_k * seq_len / n_experts))


class MoeRoute(NamedTuple):
    """Where `moe` sends each (token, choice) pair of every row.

    top_idx, top_vals: [B, S, k] chosen experts (ties to the lower id) and
    their renormalized gates; slot: [B, S·k] the pair's row in the
    dispatch buffer (expert · C + position, or E · C when dropped); keep:
    [B, S·k] the pairs within capacity; capacity: C."""
    top_idx: torch.Tensor
    top_vals: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(params: Dict[str, Any], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> MoeRoute:
    """The router and the dispatch plan of `moe` for x [B, S, D].

    The router runs in float32: softmax, top-k, renormalization with
    + 1e-9.  The top k come from a stable descending sort, so equal gates
    pick the lower expert id first, as `jax.lax.top_k` does (`torch.topk`
    promises no order on ties).  A pair's position within its expert is
    its rank in a stable sort of the row's flattened [S·k] expert ids,
    counted from the expert's start; pairs at positions >= C are dropped.
    Static shapes only, and no read on the host."""
    B, S, _ = x.shape
    E = params["router_w"].shape[-1]
    Tk = S * top_k
    C = moe_capacity(S, E, top_k, capacity_factor)
    logits = torch.matmul(x.float(), params["router_w"].float())   # [B, S, E]
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[..., :top_k], idx[..., :top_k]
    top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
    fe = top_idx.reshape(B, Tk)
    order = torch.sort(fe, dim=-1, stable=True).indices
    counts = torch.zeros((B, E), dtype=fe.dtype, device=x.device)
    counts.scatter_add_(1, fe, torch.ones_like(fe))
    starts = counts.cumsum(-1) - counts                            # [B, E]
    rank = torch.arange(Tk, device=x.device)[None]
    pos_sorted = rank - starts.gather(1, fe.gather(1, order))
    pos = torch.empty_like(fe).scatter_(1, order, pos_sorted)
    keep = pos < C
    slot = torch.where(keep, fe * C + pos, torch.full_like(fe, E * C))
    return MoeRoute(top_idx, top_vals, slot, keep, C)


def _expert_weight(w, dtype) -> torch.Tensor:
    """An expert stack [E, ., .] in `dtype`, a quantized one dequantized
    (the reference's `_maybe_dequant`)."""
    if isinstance(w, QuantizedWeight):
        return dequantize(w, dtype)
    return w.to(dtype)


def moe(params: Dict[str, Any], x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based top-k MoE: x [B, S, D] -> [B, S, D].

    Dispatch is per batch row (`moe_route`): each kept (token, choice)
    pair is copied to its expert's slot of a [B, E, C, D] buffer, the
    experts run their SwiGLU on it as one batched product per weight
    (each weight dequantized to x.dtype first when quantized, as in the
    reference), and each token's output is the gate-weighted sum of its
    kept choices, a dropped one adding zero.  The sum runs over the k
    choices in order, which is the reference's scatter-add over the
    token ids.  Plain torch on every device."""
    B, S, D = x.shape
    r = moe_route(params, x, top_k=top_k, capacity_factor=capacity_factor)
    E, C = params["router_w"].shape[-1], r.capacity
    rows = torch.arange(B, device=x.device)[:, None]
    tok = torch.arange(S, device=x.device).repeat_interleave(top_k)
    # dropped pairs all land on the extra row E·C, which is cut off
    buf = x.new_zeros((B, E * C + 1, D))
    buf[rows, r.slot] = x[:, tok]
    xe = buf[:, :-1].reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = F.silu(torch.bmm(xe, _expert_weight(params["w_gate"], x.dtype)))
    h = h * torch.bmm(xe, _expert_weight(params["w_up"], x.dtype))
    out = torch.bmm(h, _expert_weight(params["w_down"], x.dtype))
    out = out.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    out = torch.cat([out, out.new_zeros((B, 1, D))], dim=1)
    weighted = out[rows, r.slot] * r.top_vals.reshape(B, -1, 1).to(out.dtype)
    return weighted.reshape(B, S, top_k, D).sum(2)


def moe_aux_loss(params: Dict[str, Any], x: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction·prob product):
    E · sum_e frac_e · prob_e, frac_e the share of (token, choice) pairs
    routed to expert e (top k by the stable sort of `moe_route`), prob_e
    its mean gate.  Only prob carries a gradient, as in the reference."""
    E = params["router_w"].shape[-1]
    logits = torch.matmul(x.float(), params["router_w"].float())
    gates = torch.softmax(logits, dim=-1)                          # [B, S, E]
    top_idx = torch.sort(gates, dim=-1, descending=True,
                         stable=True).indices[..., :top_k]
    frac = F.one_hot(top_idx, E).float().mean(dim=(0, 1, 2))
    prob = gates.mean(dim=(0, 1))
    return E * torch.sum(frac * prob)


# ---------------------------------------------------------------------------
# Embedding / loss
# ---------------------------------------------------------------------------

def init_embedding(b: ParamInit, vocab: int, d_model: int,
                   name: str = "embedding"):
    # 1/sqrt(d) keeps tied-lm-head logits O(1) at init
    b.param(name, (vocab, d_model), ("vocab", "embed"),
            scale=d_model ** -0.5)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The rows of `table` at `ids`, in `dtype`.  `F.embedding` gathers
    the same rows as indexing does; its backward sums each row's
    gradient in a fixed order on the CPU too, where indexing's
    accumulates in the order the threads run (so a resumed train step
    repeats the straight run's bits)."""
    return F.embedding(ids.long(), table).to(dtype)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            true_vocab: int):
    """(sum of the negative log-likelihoods over labels >= 0, their
    count), in float32, the padded vocab entries (ids >= true_vocab)
    pushed down by -1e9 as in the reference."""
    V = logits.shape[-1]
    logits = logits.float()
    if true_vocab < V:
        neg = torch.zeros(V, dtype=logits.dtype, device=logits.device)
        neg[true_vocab:] = -1e9
        logits = logits + neg
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       true_vocab: int) -> torch.Tensor:
    """Mean CE over labels >= 0, masking padded vocab entries."""
    nll, count = nll_sum(logits, labels, true_vocab)
    return nll / torch.clamp(count, min=1.0)
