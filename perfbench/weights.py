"""Random W4A16 weights drawn from a seed, in the benchmark's own layout.

Both sides read these tensors: the program through `adapter.params`
(which wraps them, without a copy, as the port's `QuantizedWeight`
leaves) and the plain reference (`reference.py`), which unpacks and
scales them itself.  Nothing here imports the program.

Layout (L layers, D model width, K kv heads of dh, G query heads a kv
head, F feed-forward width, E experts, V vocabulary):

    embedding, lm_head   float32 [V, D]
    final_norm           float32 [D]
    layers.ln1, ln2      float32 [L, D]
    layers.wq            Packed [L, K, D/2, G*dh]   (head h = k*G + g)
    layers.wk, wv        Packed [L, K, D/2, dh]
    layers.wo            Packed [L, G*K*dh/2, D]
    layers.gate, up      Packed [L, D/2, F]          (dense SwiGLU)
    layers.down          Packed [L, F/2, D]
    layers.router        float32 [L, D, E]           (MoE)
    layers.w_gate, w_up  Packed [L, E, D/2, F]
    layers.w_down        Packed [L, E, F/2, D]

A `Packed` weight holds int4 codes as offset-binary nibbles packed along
the input dim (row 2i in the high nibble, row 2i + 1 in the low one,
value = nibble - 8) and one float32 scale per output column; the
weight is code x scale.  Codes are drawn uniformly over -7..7 with 0 at
twice the weight (a drawn nibble 0 becomes 8), so they are symmetric as
symmetric quantization makes them; scales are uniform in [0.75, 1.25] x
1 / (sigma_code * sqrt(fan_in)), the fan-in scale of the port's
initializer.  Norm weights are 0.1 x N(0, 1) (applied as 1 + w), the
embedding N(0, 1/D), the LM head N(0, 1/V), the router N(0, 1/D).

Every draw runs on `device` from one `torch.Generator` seeded with the
run's seed, one call a stacked leaf, in the order below.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

CODE_STD = math.sqrt(17.5)       # std of the code distribution above


class Packed(NamedTuple):
    codes: torch.Tensor          # uint8 [..., R/2, C]
    scale: torch.Tensor          # float32 [..., C]


def _fix_nibbles(codes: torch.Tensor) -> None:
    """A nibble 0 (value -8) becomes 8 (value 0), in place, one leading
    slice at a time to keep the temporaries small."""
    for i in range(codes.shape[0]):
        s = codes[i]
        s.bitwise_or_(((s >> 4) == 0).to(torch.uint8) << 7)
        s.bitwise_or_(((s & 15) == 0).to(torch.uint8) << 3)


def _packed(gen, device, lead, rows: int, cols: int) -> Packed:
    codes = torch.randint(0, 256, (*lead, rows // 2, cols),
                          dtype=torch.uint8, generator=gen, device=device)
    _fix_nibbles(codes.reshape(-1, rows // 2, cols))
    scale = torch.rand((*lead, cols), generator=gen, device=device)
    scale.mul_(0.5).add_(0.75).mul_(1.0 / (CODE_STD * math.sqrt(rows)))
    return Packed(codes, scale)


def _normal(gen, device, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).mul_(std)


def draw(model: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of `model` (a configuration's "model" block) for
    `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    L, D = model["n_layers"], model["d_model"]
    K, dh = model["n_kv_heads"], model["d_head"]
    G = model["n_heads"] // K
    F, V = model["d_ff"], model["vocab_size"]
    layers: Dict[str, Any] = {
        "ln1": _normal(gen, device, (L, D), 0.1),
        "ln2": _normal(gen, device, (L, D), 0.1),
        "wq": _packed(gen, device, (L, K), D, G * dh),
        "wk": _packed(gen, device, (L, K), D, dh),
        "wv": _packed(gen, device, (L, K), D, dh),
        "wo": _packed(gen, device, (L,), K * G * dh, D),
    }
    E = model.get("n_experts", 0)
    if E:
        layers["router"] = _normal(gen, device, (L, D, E), D ** -0.5)
        layers["w_gate"] = _packed(gen, device, (L, E), D, F)
        layers["w_up"] = _packed(gen, device, (L, E), D, F)
        layers["w_down"] = _packed(gen, device, (L, E), F, D)
    else:
        layers["gate"] = _packed(gen, device, (L,), D, F)
        layers["up"] = _packed(gen, device, (L,), D, F)
        layers["down"] = _packed(gen, device, (L,), F, D)
    return {
        "embedding": _normal(gen, device, (V, D), D ** -0.5),
        "lm_head": _normal(gen, device, (V, D), V ** -0.5),
        "final_norm": _normal(gen, device, (D,), 0.1),
        "layers": layers,
    }


def unpack(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [..., R/2, C] -> float32 [..., R, C] code values in -8..7."""
    hi = (codes >> 4).to(torch.int16) - 8
    lo = (codes & 15).to(torch.int16) - 8
    out = torch.stack([hi, lo], dim=-2)
    return out.reshape(*codes.shape[:-2], 2 * codes.shape[-2],
                       codes.shape[-1]).float()


def dequant(w: Packed) -> torch.Tensor:
    """code x scale, float32 [..., R, C]."""
    return unpack(w.codes) * w.scale[..., None, :]


def nbytes(tree) -> int:
    """Bytes of every tensor in a weight tree."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, Packed):
        return nbytes(tree.codes) + nbytes(tree.scale)
    return tree.numel() * tree.element_size()
