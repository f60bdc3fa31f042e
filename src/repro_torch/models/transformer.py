"""Decoder stack (port of the dense and ssm branches of
`repro.models.transformer`): pre-norm attention + MLP blocks, or RWKV6
time-mix + channel-mix blocks (`models/rwkv6.py`).

Layers are stacked (leading layer axis on every per-layer leaf, as in the
reference) and run by a Python loop in place of `lax.scan`.  A
sliding-window arch (gemma3's 5:1 local:global mix) attends over
`cfg.window` tokens on its local layers and over the whole context on
its global ones: the loop passes the window per layer where the
reference scans a traced `is_global` flag.  The hybrid, MoE, VLM and
encoder-decoder families are not ported yet (ROADMAP A15) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6
from repro_torch.models.layers import (ParamInit, embed_lookup,
                                       init_embedding, init_mlp, layer_slice,
                                       mlp, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    activ_dtype: Any = torch.float32
    attn_impl: str = "auto"          # flash attention dispatch


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations this slice of the port leaves out."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP A15, other families)")


def layer_window(cfg: ModelConfig, layer: int):
    """The attention window of `layer`: cfg.window on a local layer, None
    (the whole context) on a global one."""
    return None if cfg.is_global_layer(layer) else cfg.window


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict[str, Any]:
    """Fresh float32 parameters with the reference's tree, shapes and
    scales."""
    check_supported(cfg)
    b = ParamInit(generator, device)
    init_embedding(b, cfg.padded_vocab, cfg.d_model)
    lb = ParamInit(generator, device, stack=cfg.n_layers)
    lb.param("ln1", (cfg.d_model,), init="zeros")
    if cfg.family == "ssm":
        rwkv6.init_rwkv_timemix(lb.scope("tmix"), cfg)
        lb.param("ln2", (cfg.d_model,), init="zeros")
        rwkv6.init_rwkv_channelmix(lb.scope("cmix"), cfg)
    else:
        attn_mod.init_attention(lb.scope("attn"), cfg)
        lb.param("ln2", (cfg.d_model,), init="zeros")
        init_mlp(lb.scope("mlp"), cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    b.params["layers"] = lb.params
    b.param("final_norm", (cfg.d_model,), init="zeros")
    if not cfg.tie_embeddings:
        b.param("lm_head", (cfg.padded_vocab, cfg.d_model))
    return b.params


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input activations [B, S, D] + positions [B, S] (dense: tokens
    only — patch and meta-token prefixes belong to unported families)."""
    tok = batch["tokens"]
    x = embed_lookup(params["embedding"], tok, rt.activ_dtype)
    B, S = tok.shape
    positions = torch.arange(S, device=tok.device)[None].expand(B, S)
    return x, positions


def lm_head_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embedding"])
    return torch.matmul(x, table.to(x.dtype).t())


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rt: Runtime) -> torch.Tensor:
    """Plain full forward -> logits [B, S, V].

    Kernel-free on every device (flash attention, the wkv recurrence and
    quantized weights take their plain versions, impl="ref", whatever
    `rt.attn_impl` says): the reference the engine and the served tokens
    are held against, never the serving path."""
    check_supported(cfg)
    x, positions = embed_inputs(params, cfg, batch, rt)
    B = x.shape[0]
    for i in range(cfg.n_layers):
        pl_ = layer_slice(params["layers"], i)
        if cfg.family == "ssm":
            # every layer's recurrence starts from zero state and shifts
            state0 = torch.zeros(rwkv6.rwkv_state_shape(cfg, B),
                                 dtype=torch.float32, device=x.device)
            shift0 = torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                 device=x.device)
            x = rwkv6.rwkv_block(pl_, cfg, x, state0, shift0, shift0,
                                 impl="ref")[0]
        else:
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            x = x + attn_mod.attention_train(pl_["attn"], cfg, h, impl="ref",
                                             window=layer_window(cfg, i),
                                             positions=positions)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp, impl="ref")
    return lm_head_logits(params, cfg, x)
