"""The yardstick's arithmetic: peaks, and the FLOPs and bytes that the
served function needs, from a configuration's "model" block and the
shapes of the work.  Nothing here imports the program.

Peaks: one NVIDIA H100 SXM's published dense rates at its 700 W limit
(NVIDIA's data sheet): 989 TFLOP/s of bf16 on the tensor cores and
3.35 TB/s of HBM3.  The accounting is the one of the port's
`launch/steps.py` (`function_flops`, `_layer_weights`) and
`launch/roofline.py` at the time this benchmark was written, frozen
here: it counts the work of the function, never the eager program's
operations, so a change that removes waste is read against the same
bound.

  * FLOPs of a token: 2 a layer weight it multiplies (an expert's at
    top_k / n_experts), 2 V D when its logits are computed, and 4 H dh
    a (query, key) pair that attention scores.
  * Bytes of a pass (one engine call: a decode step or a prefill
    chunk): every weight byte once (codes, scales and float leaves; of
    the embedding only the rows looked up), the distinct cached keys and
    values that its queries read once, and the keys and values it
    writes once.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12        # bf16 dense, one H100 SXM at 700 W
HBM_BW = 3.35e12           # bytes/s, one H100 SXM


def dims(m: Dict) -> Tuple[int, ...]:
    """(L, D, H, K, dh, F, V, E, top_k)."""
    return (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"],
            m["d_head"], m["d_ff"], m["vocab_size"], m.get("n_experts", 0),
            m.get("top_k", 0))


def layer_weights(m: Dict) -> float:
    """Weights one token multiplies in one layer (norms excluded)."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    attn = D * (H * dh + 2 * K * dh) + H * dh * D
    ffn = (D * E + 3 * D * F * k) if E else 3 * D * F
    return float(attn + ffn)


def param_count(m: Dict) -> int:
    """Every parameter (all experts, both vocabulary tables, norms)."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    attn = D * (H * dh + 2 * K * dh) + H * dh * D
    ffn = (E * 3 * D * F + D * E) if E else 3 * D * F
    tables = V * D * (1 if m.get("tie_embeddings") else 2)
    return L * (attn + ffn + 2 * D) + tables + D


def token_flops(m: Dict, context: int, logits: bool) -> float:
    """FLOPs of one token that attends over `context` positions (itself
    included) in every layer."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    f = 2.0 * L * layer_weights(m) + 4.0 * L * H * dh * context
    return f + (2.0 * V * D if logits else 0.0)


def chunk_flops(m: Dict, start: int, length: int) -> float:
    """A prefill chunk of `length` valid tokens from position `start`;
    logits for its last token."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    pairs = length * start + length * (length + 1) / 2
    return (2.0 * L * layer_weights(m) * length + 4.0 * L * H * dh * pairs
            + 2.0 * V * D)


def kv_bytes_per_token(m: Dict, elem: int = 2) -> float:
    """Keys and values of one position over every layer."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    return 2.0 * L * K * dh * elem


def weight_bytes_per_pass(m: Dict, weight_bytes: float, tokens: int) -> float:
    """Bytes of the weights a pass over `tokens` rows reads: all of them,
    but of the input embedding (float32 [V, D]) only the rows looked
    up."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    return weight_bytes - 4.0 * V * D + 4.0 * D * min(tokens, V)


def decode_pass(m: Dict, contexts: Iterable[int], weight_bytes: float,
                shared_tokens: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of a decode pass whose rows attend over `contexts`
    positions each (the new token included); `shared_tokens` of those
    positions are pages that several rows map and are counted once."""
    ctx = list(contexts)
    flops = sum(token_flops(m, c, True) for c in ctx)
    read = sum(ctx) - shared_tokens
    nbytes = (weight_bytes_per_pass(m, weight_bytes, len(ctx))
              + kv_bytes_per_token(m) * (read + len(ctx)))
    return flops, nbytes


def chunk_pass(m: Dict, start: int, length: int,
               weight_bytes: float) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill chunk: the cached positions below
    `start` read once, the chunk's keys and values written once."""
    nbytes = (weight_bytes_per_pass(m, weight_bytes, length)
              + kv_bytes_per_token(m) * (start + length))
    return chunk_flops(m, start, length), nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of work needing `flops` and `nbytes`."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def paged_attention_bound(m: Dict, contexts: Iterable[int],
                          shared_tokens: int = 0) -> float:
    """One layer's decode attention launch (B1 / B2): each row's cached
    keys and values read once (positions that several rows map counted
    once), q read and o, m, l written in float32, 4 H dh FLOPs a pair."""
    L, D, H, K, dh, F, V, E, k = dims(m)
    ctx = list(contexts)
    kv = 2.0 * K * dh * 2 * (sum(ctx) - shared_tokens)
    io = len(ctx) * (2 * H * dh * 4 + 2 * H * 4)
    return bound_s(4.0 * H * dh * sum(ctx), kv + io)


def quant_gemv_bound(rows: int, d_in: int, d_out: int) -> float:
    """One W4A16 launch (B3) over `rows` valid rows: codes and scales
    read once, x read in bf16, y written in float32; 2 rows d_in d_out
    FLOPs at the bf16 peak."""
    nbytes = d_in * d_out / 2 + 4.0 * d_out + rows * (2.0 * d_in + 4.0 * d_out)
    return bound_s(2.0 * rows * d_in * d_out, nbytes)
