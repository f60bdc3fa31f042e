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

Two full-sequence forwards share the blocks (`run_layers`): `forward`,
kernel-free on every device, the reference the engine and the tests are
held against; and the training forward (`forward_train`, `loss_fn`),
which attends through `Runtime.attn_impl` (kernel B4 under autograd on a
card, `kernels/flash_attention/autograd.py`), can rematerialize each
layer (`remat`), adds an MoE arch's load-balancing loss, and can run the
LM head and cross entropy one sequence chunk at a time
(`Runtime.loss_chunk`).  RWKV6 trains on the CPU only: on a card its
wkv would launch B5 under grad, which has no backward yet (ROADMAP
A18b), and raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6, ssm
from repro_torch.models.layers import (ParamInit, cross_entropy_loss,
                                       embed_lookup, init_embedding,
                                       init_mlp, init_moe, layer_slice, mlp,
                                       moe, moe_aux_loss, nll_sum,
                                       rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    activ_dtype: Any = torch.float32
    attn_impl: str = "auto"          # flash attention dispatch
    moe_capacity: float = 1.25
    vlm_patches: int = 256           # patch-prefix length of a VLM cell
    enc_frames_ratio: int = 4        # encoder-decoder: frames = S // ratio
    loss_chunk: int = 0              # >0: sequence-chunked CE (one chunk
    #                                  of logits live at a time)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder block runs under: dense, no cross-attention,
    one kv head a query head (the reference's `cfg_blk` / `cfg_enc`)."""
    return dataclasses.replace(cfg, family="dense", is_encoder_decoder=False,
                               n_kv_heads=cfg.n_heads)


def layer_window(cfg: ModelConfig, layer: int):
    """The attention window of `layer`: cfg.window on a local layer, None
    (the whole context) on a global one."""
    return None if cfg.is_global_layer(layer) else cfg.window


def _init_stacked_layers(b: ParamInit, cfg: ModelConfig, n_layers: int,
                         name: str):
    """`n_layers` blocks with a leading layer axis on every leaf (the
    reference's `_init_block` under `_init_stacked_layers`), as b[name]."""
    lb = ParamInit(b.generator, b.device, stack=n_layers, dtype=b.dtype)
    lb.param("ln1", (cfg.d_model,), ("norm",), init="zeros")
    if cfg.family == "ssm":
        rwkv6.init_rwkv_timemix(lb.scope("tmix"), cfg)
        lb.param("ln2", (cfg.d_model,), ("norm",), init="zeros")
        rwkv6.init_rwkv_channelmix(lb.scope("cmix"), cfg)
    else:
        attn_mod.init_attention(lb.scope("attn"), cfg)
        if cfg.family == "hybrid":
            ssm.init_ssm(lb.scope("ssm"), cfg)
        if cfg.is_encoder_decoder:
            lb.param("ln_cross", (cfg.d_model,), ("norm",), init="zeros")
            attn_mod.init_attention(lb.scope("cross"), cfg, cross=True)
        lb.param("ln2", (cfg.d_model,), ("norm",), init="zeros")
        if cfg.is_moe:
            init_moe(lb.scope("moe"), cfg.d_model, cfg.d_ff, cfg.n_experts)
        else:
            init_mlp(lb.scope("mlp"), cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    b.params[name], b.specs[name] = lb.params, lb.specs


def init_model_with_specs(cfg: ModelConfig,
                          generator: Optional[torch.Generator], device,
                          dtype: torch.dtype = torch.float32):
    """(params, specs): the reference's `init_model`, a parameter tree
    and its logical-axis tree of one structure."""
    b = ParamInit(generator, device, dtype=dtype)
    init_embedding(b, cfg.padded_vocab, cfg.d_model)
    _init_stacked_layers(b, cfg, cfg.n_layers, "layers")
    b.param("final_norm", (cfg.d_model,), ("norm",), init="zeros")
    if not cfg.tie_embeddings:
        b.param("lm_head", (cfg.padded_vocab, cfg.d_model),
                ("vocab", "embed"))
    if cfg.is_encoder_decoder:
        _init_stacked_layers(b, encoder_config(cfg), cfg.encoder_layers,
                             "encoder")
        b.param("encoder_norm", (cfg.d_model,), ("norm",), init="zeros")
    if cfg.n_meta_tokens:
        b.param("meta_tokens", (cfg.n_meta_tokens, cfg.d_model),
                (None, "embed"), scale=0.02)
    return b.params, b.specs


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict[str, Any]:
    """Fresh float32 parameters with the reference's tree, shapes and
    scales."""
    return init_model_with_specs(cfg, generator, device)[0]


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32):
    """(params, specs) with every leaf a meta tensor of the reference's
    shape in `dtype`: nothing drawn, nothing allocated (the dry-run's
    stand-in for the reference's `jax.eval_shape` of `init_model`)."""
    return init_model_with_specs(cfg, None, "meta", dtype)


def param_specs(cfg: ModelConfig):
    """The logical-axis tree the reference's `init_model` returns beside
    its params."""
    return abstract_params(cfg)[1]


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


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def encoder_block(pl_, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, impl: str):
    """One encoder block: non-causal self-attention with RoPE over the
    frame positions, then the MLP -> (x, aux = 0)."""
    h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention_train(pl_["attn"], encoder_config(cfg), h,
                                     causal=False, impl=impl,
                                     positions=positions)
    h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
    return x + mlp(pl_["mlp"], h, cfg.gated_mlp, impl=impl), _zero(x)


def decoder_block(pl_, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
                  positions: torch.Tensor, window, enc_out, impl: str):
    """One decoder block over a full sequence x [B, S, D] -> (x, aux).
    The recurrent state of an RWKV6 or hybrid block starts from zero;
    `window` is the layer's (None on a global layer); `enc_out` the
    encoder's output of an encoder-decoder arch; aux the MoE's
    load-balancing loss (0 for other archs)."""
    B = x.shape[0]
    if cfg.family == "ssm":
        state0 = torch.zeros(rwkv6.rwkv_state_shape(cfg, B),
                             dtype=torch.float32, device=x.device)
        shift0 = torch.zeros((B, cfg.d_model), dtype=x.dtype,
                             device=x.device)
        return rwkv6.rwkv_block(pl_, cfg, x, state0, shift0, shift0,
                                impl=impl)[0], _zero(x)
    h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
    aout = attn_mod.attention_train(pl_["attn"], cfg, h, impl=impl,
                                    window=window, positions=positions)
    if cfg.family == "hybrid":
        state0 = torch.zeros(ssm.ssm_state_shape(cfg, B),
                             dtype=torch.float32, device=x.device)
        tail0 = torch.zeros((B, ssm.CONV_K - 1, cfg.d_model),
                            dtype=x.dtype, device=x.device)
        sout = ssm.ssm_mixer(pl_["ssm"], cfg, h, state0, tail0,
                             impl=impl)[0]
        aout = hybrid_mix(aout, sout)
    x = x + aout
    if enc_out is not None:
        h = rms_norm(x, pl_["ln_cross"], cfg.norm_eps)
        x = x + attn_mod.attention_train(pl_["cross"], cfg, h, kv_x=enc_out,
                                         impl=impl)
    h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
    aux = (moe_aux_loss(pl_["moe"], h, cfg.top_k) if cfg.is_moe
           else _zero(x))
    return x + ffn(pl_, cfg, h, rt, impl=impl), aux


def _saves_weight_product(ctx, op, *args, **kwargs):
    """remat="block"'s policy, the counterpart of the reference's
    `dots_with_no_batch_dims_saveable`: keep the output of every matrix
    product without batch dims (`aten.mm` / `aten.addmm`, and `aten.bmm`
    over a batch of one, which is how `einsum` lowers the head-group
    projections), recompute everything else (norms, activations, the
    attention and wkv / scan products, which have batch dims)."""
    aten = torch.ops.aten
    if (op in (aten.mm.default, aten.addmm.default)
            or (op == aten.bmm.default and args[0].shape[0] == 1)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """fn under the layer's rematerialization: "none" keeps every
    activation for the backward; "full" keeps only the layer's inputs
    and reruns the layer in the backward; "block" reruns it too but
    keeps the products with the weights (`_saves_weight_product`)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "block":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _saves_weight_product))
    raise ValueError(f"unknown remat {remat!r} (none, block, full)")


def run_layers(params, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
               positions: torch.Tensor, enc_out=None, remat: str = "none",
               stack: str = "layers", impl: Optional[str] = None):
    """The stacked layers of `stack` ("layers", or "encoder" for an
    encoder-decoder arch's encoder blocks) over x, one Python iteration
    a layer in place of the reference's `lax.scan`, each under `remat`
    -> (x, the layers' aux loss summed).  `impl` picks the attention
    path (default `rt.attn_impl`)."""
    impl = rt.attn_impl if impl is None else impl
    aux = _zero(x)
    if stack == "encoder":
        body = _remat(functools.partial(encoder_block, cfg=cfg,
                                        positions=positions, impl=impl),
                      remat)
        for i in range(cfg.encoder_layers):
            x, _ = body(layer_slice(params["encoder"], i), x=x)
        return x, aux
    for i in range(cfg.n_layers):
        body = _remat(functools.partial(
            decoder_block, cfg=cfg, rt=rt, positions=positions,
            window=layer_window(cfg, i), enc_out=enc_out, impl=impl), remat)
        x, a = body(layer_slice(params["layers"], i), x=x)
        aux = aux + a
    return x, aux


def run_encoder(params, cfg: ModelConfig, frames: torch.Tensor, rt: Runtime,
                *, impl: str = "auto", remat: str = "none") -> torch.Tensor:
    """The bidirectional encoder over frames [B, Senc, D] -> enc_out
    [B, Senc, D], `encoder_norm` applied (the reference's `run_layers(...,
    stack="encoder")` and the norm after it).  Each block: non-causal
    self-attention with RoPE over the frame positions (kernel B4 on a
    card unless impl="ref"), then the MLP."""
    x = frames.to(rt.activ_dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, _ = run_layers(params, cfg, x, rt, positions, remat=remat,
                      stack="encoder", impl=impl)
    return rms_norm(x, params["encoder_norm"], cfg.norm_eps)


def lm_head_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embedding"])
    return torch.matmul(x, table.to(x.dtype).t())


def _token_states(params, cfg: ModelConfig, batch, rt: Runtime, remat: str,
                  impl: str):
    """The last layer's activations over the token positions (the meta
    and patch prefix stripped) and the aux loss."""
    x, positions = embed_inputs(params, cfg, batch, rt)
    enc_out = (run_encoder(params, cfg, batch["frames"], rt, impl=impl,
                           remat=remat)
               if cfg.is_encoder_decoder else None)
    x, aux = run_layers(params, cfg, x, rt, positions, enc_out, remat=remat,
                        impl=impl)
    return x[:, x.shape[1] - batch["tokens"].shape[1]:], aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rt: Runtime) -> torch.Tensor:
    """Plain full forward -> logits [B, S, V].

    Kernel-free on every device (flash attention, the wkv recurrence and
    quantized weights take their plain versions, impl="ref", whatever
    `rt.attn_impl` says): the reference the engine and the served tokens
    are held against, never the serving path."""
    x, _ = _token_states(params, cfg, batch, rt, "none", "ref")
    return lm_head_logits(params, cfg, x)


def forward_train(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  rt: Runtime, remat: str = "none"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward -> (logits over the token positions, aux
    loss), attention through `rt.attn_impl` (B4 on a card)."""
    x, aux = _token_states(params, cfg, batch, rt, remat, rt.attn_impl)
    return lm_head_logits(params, cfg, x), aux


def chunked_ce(params, cfg: ModelConfig, x: torch.Tensor,
               labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Sequence-chunked cross entropy: the LM head and the softmax run one
    [B, chunk, V] block at a time under checkpoint, so one chunk of
    logits is live at a time (the full [B, S, V] logits are the largest
    temporary of a train step at 150K-260K vocabs)."""
    B, S, D = x.shape
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def one(xch, lch):
        return nll_sum(lm_head_logits(params, cfg, xch), lch, cfg.vocab_size)

    nll = cnt = _zero(x)
    for c0 in range(0, x.shape[1], chunk):
        n, c = checkpoint(one, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                          use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, rt: Runtime,
            remat: str = "none") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """batch: tokens [B, S] (inputs) and labels [B, S] (pre-shifted; -1
    masks a position) -> (ce + 0.01 · aux, {"ce", "aux"})."""
    if rt.loss_chunk:
        x, aux = _token_states(params, cfg, batch, rt, remat, rt.attn_impl)
        ce = chunked_ce(params, cfg, x, batch["labels"], rt.loss_chunk)
    else:
        logits, aux = forward_train(params, cfg, batch, rt, remat=remat)
        ce = cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
