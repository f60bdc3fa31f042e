"""Model stack (port of `repro.models.transformer`, every family):
pre-norm attention + MLP (or MoE) blocks, RWKV6
time-mix + channel-mix blocks (`models/rwkv6.py`), or hymba's hybrid
blocks, where a selective-SSM mixer (`models/ssm.py`) runs beside
attention on the same normed input and the two outputs are averaged.

Layers are stacked (leading layer axis on every per-layer leaf, as in the
reference) and run by a Python loop in place of `lax.scan`.  A
sliding-window arch (gemma3's 5:1 local:global mix, hymba's sparse
global layers) attends over `cfg.window` tokens on its local layers and
over the whole context on its global ones: the loop passes the window
per layer where the reference scans a traced `is_global` flag.  A
meta-token arch (hymba) prepends its learned prefix to every sequence
and strips it again before the LM head.  An MoE arch (mixtral, dbrx,
kimi-k2) runs `layers.moe` in place of the MLP, with the capacity factor
`Runtime.moe_capacity`.  A VLM arch (pixtral) prepends
`batch["patches"]`, precomputed patch embeddings, when they are given
(after any meta tokens, before the tokens) and strips them again before
the LM head.  An encoder-decoder arch (whisper) runs a bidirectional
encoder over `batch["frames"]` (`encoder_layers` dense blocks with
n_kv_heads = n_heads, non-causal attention with RoPE over the frame
positions, then `encoder_norm`), and every decoder block adds
cross-attention over the encoder's output after its self-attention
(`ln_cross`, `cross`: q from the decoder, k/v from the encoder, no RoPE,
non-causal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6, ssm
from repro_torch.models.layers import (ParamInit, embed_lookup,
                                       init_embedding, init_mlp, init_moe,
                                       layer_slice, mlp, moe, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    activ_dtype: Any = torch.float32
    attn_impl: str = "auto"          # flash attention dispatch
    moe_capacity: float = 1.25


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder block runs under: dense, no cross-attention,
    one kv head a query head (the reference's `cfg_blk` / `cfg_enc`)."""
    return dataclasses.replace(cfg, family="dense", is_encoder_decoder=False,
                               n_kv_heads=cfg.n_heads)


def layer_window(cfg: ModelConfig, layer: int):
    """The attention window of `layer`: cfg.window on a local layer, None
    (the whole context) on a global one."""
    return None if cfg.is_global_layer(layer) else cfg.window


def _init_stacked_layers(cfg: ModelConfig, n_layers: int,
                         generator: torch.Generator, device):
    """`n_layers` blocks with a leading layer axis on every leaf (the
    reference's `_init_block` under `_init_stacked_layers`)."""
    lb = ParamInit(generator, device, stack=n_layers)
    lb.param("ln1", (cfg.d_model,), init="zeros")
    if cfg.family == "ssm":
        rwkv6.init_rwkv_timemix(lb.scope("tmix"), cfg)
        lb.param("ln2", (cfg.d_model,), init="zeros")
        rwkv6.init_rwkv_channelmix(lb.scope("cmix"), cfg)
        return lb.params
    attn_mod.init_attention(lb.scope("attn"), cfg)
    if cfg.family == "hybrid":
        ssm.init_ssm(lb.scope("ssm"), cfg)
    if cfg.is_encoder_decoder:
        lb.param("ln_cross", (cfg.d_model,), init="zeros")
        attn_mod.init_attention(lb.scope("cross"), cfg, cross=True)
    lb.param("ln2", (cfg.d_model,), init="zeros")
    if cfg.is_moe:
        init_moe(lb.scope("moe"), cfg.d_model, cfg.d_ff, cfg.n_experts)
    else:
        init_mlp(lb.scope("mlp"), cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    return lb.params


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict[str, Any]:
    """Fresh float32 parameters with the reference's tree, shapes and
    scales."""
    b = ParamInit(generator, device)
    init_embedding(b, cfg.padded_vocab, cfg.d_model)
    b.params["layers"] = _init_stacked_layers(cfg, cfg.n_layers, generator,
                                              device)
    b.param("final_norm", (cfg.d_model,), init="zeros")
    if not cfg.tie_embeddings:
        b.param("lm_head", (cfg.padded_vocab, cfg.d_model))
    if cfg.is_encoder_decoder:
        b.params["encoder"] = _init_stacked_layers(
            encoder_config(cfg), cfg.encoder_layers, generator, device)
        b.param("encoder_norm", (cfg.d_model,), init="zeros")
    if cfg.n_meta_tokens:
        b.param("meta_tokens", (cfg.n_meta_tokens, cfg.d_model), scale=0.02)
    return b.params


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input activations [B, S, D] + positions [B, S]: the broadcast meta
    tokens of a meta-token arch, then a VLM's `batch["patches"]` [B, P, D]
    when given, then the token embeddings (S counts all three; positions
    run over all of them).  An encoder-decoder arch's frames are not part
    of it (`run_encoder`)."""
    tok = batch["tokens"]
    parts = [embed_lookup(params["embedding"], tok, rt.activ_dtype)]
    if cfg.family == "vlm" and "patches" in batch:
        parts.insert(0, batch["patches"].to(rt.activ_dtype))
    if cfg.n_meta_tokens:
        B = tok.shape[0]
        parts.insert(0, params["meta_tokens"].to(rt.activ_dtype)[None]
                     .expand(B, cfg.n_meta_tokens, cfg.d_model))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=tok.device)[None].expand(B, S)
    return x, positions


def hybrid_mix(aout: torch.Tensor, sout: torch.Tensor) -> torch.Tensor:
    """A hybrid block's attention and SSM outputs, averaged."""
    return (aout + sout) * 0.5


def ffn(pl_, cfg: ModelConfig, h: torch.Tensor, rt: Runtime, *,
        impl: str = "auto") -> torch.Tensor:
    """A block's feed-forward on its normed input h [B, S, D]: the MoE of
    an MoE arch, called on h's own [B, S] (its capacity depends on S),
    else the MLP (impl as `layers.dense` takes it)."""
    if cfg.is_moe:
        return moe(pl_["moe"], h, top_k=cfg.top_k,
                   capacity_factor=rt.moe_capacity)
    return mlp(pl_["mlp"], h, cfg.gated_mlp, impl=impl)


def run_encoder(params, cfg: ModelConfig, frames: torch.Tensor, rt: Runtime,
                *, impl: str = "auto") -> torch.Tensor:
    """The bidirectional encoder over frames [B, Senc, D] -> enc_out
    [B, Senc, D], `encoder_norm` applied (the reference's `run_layers(...,
    stack="encoder")` and the norm after it).  Each block: non-causal
    self-attention with RoPE over the frame positions (kernel B4 on a
    card unless impl="ref"), then the MLP."""
    enc_cfg = encoder_config(cfg)
    x = frames.to(rt.activ_dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.encoder_layers):
        pl_ = layer_slice(params["encoder"], i)
        h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
        x = x + attn_mod.attention_train(pl_["attn"], enc_cfg, h,
                                         causal=False, impl=impl,
                                         positions=positions)
        h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
        x = x + mlp(pl_["mlp"], h, cfg.gated_mlp, impl=impl)
    return rms_norm(x, params["encoder_norm"], cfg.norm_eps)


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
    x, positions = embed_inputs(params, cfg, batch, rt)
    enc_out = (run_encoder(params, cfg, batch["frames"], rt, impl="ref")
               if cfg.is_encoder_decoder else None)
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
            aout = attn_mod.attention_train(pl_["attn"], cfg, h, impl="ref",
                                            window=layer_window(cfg, i),
                                            positions=positions)
            if cfg.family == "hybrid":
                # every layer's SSM starts from zero state and tail
                state0 = torch.zeros(ssm.ssm_state_shape(cfg, B),
                                     dtype=torch.float32, device=x.device)
                tail0 = torch.zeros((B, ssm.CONV_K - 1, cfg.d_model),
                                    dtype=x.dtype, device=x.device)
                sout = ssm.ssm_mixer(pl_["ssm"], cfg, h, state0, tail0,
                                     impl="ref")[0]
                aout = hybrid_mix(aout, sout)
            x = x + aout
            if enc_out is not None:
                h = rms_norm(x, pl_["ln_cross"], cfg.norm_eps)
                x = x + attn_mod.attention_train(pl_["cross"], cfg, h,
                                                 kv_x=enc_out, impl="ref")
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + ffn(pl_, cfg, h, rt, impl="ref")
    # strip the meta-token and patch prefix before the LM head
    x = x[:, x.shape[1] - batch["tokens"].shape[1]:]
    return lm_head_logits(params, cfg, x)
