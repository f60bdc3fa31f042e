"""KVNAND engine: one-shot and chunked prefill + decode over the paged
KV pool (port of `repro.core.engine`, single device, compact variant).

`decode_step` runs one token per slot through every layer: QKV
projection, an in-place append of the new K/V into the slot's page,
decode attention over the slot's pages (a CUDA kernel on the card),
output projection and MLP.  `prefill_chunk` runs one page-aligned chunk
of one slot's prompt: a causal in-chunk partial over the chunk's own K/V
and a past-page partial over the slot's already-written pages, merged by
log-sum-exp, then the chunk's K/V are filled into the slot's pages.
`prefill` runs whole prompts of every row of a fresh cache at once:
causal flash attention over the prompt (kernel B4 on the card), then
each layer's K/V filled into the pools (`paged_kv.fill_layer`); the
splice scheduler copies such a one-row cache into a batch slot.

Two pool layouts (`core/paged_kv.py`): the per-slot stripe, and the
shared pool (`EngineConfig.shared_pool`), where every slot walks its
LOGICAL pages through its row of `page_table_g` — appends, fills and
attention all go through the table, and logical page j's base is j·T.

The layer loop is a Python loop (the reference's `lax.scan`), and the
pools are mutated in place through `core/paged_kv.py`.  The private
helpers carry names of their own (the reference's are cited in their
docstrings): the repo's static analyzer resolves `self.<method>` calls
by class and method name, and a shared name would let this eager code
feed its call graph of the jitted reference engine.

An RWKV6 (`ssm`) model has no pool: each slot carries its per-layer
recurrent state and token shifts (`core/paged_kv.py`).  Its decode step
runs the token-by-token recurrence with inactive rows frozen; its prompt
is prefilled whole, as one exact-length chunk (`prefill_chunk`, from the
slot's state, or zero state when `first`) or one-shot (`prefill`, exact
length only), through the chunked wkv (kernel B5 on the card).

kv8/kv4 pools (`EngineConfig.kv_quant`) carry per-page scales beside the
codes: appends requantize the touched page, fills quantize whole pages,
and the decode kernels and the chunk's past partial dequantize as they
read.  Quantized weights need no engine setting: the format travels with
the params (`core.quant.quantize_params`), and `layers.dense` sends each
2-D quantized weight through kernel B3; `EngineConfig.quant` is not read,
as in the reference.  Not ported yet, and refused here: the
discrete/head-group-pipelined variant, the tiered pool, window rings,
the hybrid, MoE, VLM and encoder-decoder families, speculative verify
and a device mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import paged_kv, seqpar
from repro_torch.core.paged_kv import DecodeCache
from repro_torch.kernels.paged_attention import (paged_attention_partial,
                                                 paged_chunk_attention)
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6
from repro_torch.models.layers import embed_lookup, layer_slice, mlp, rms_norm
from repro_torch.models.transformer import (Runtime, check_supported,
                                            embed_inputs, lm_head_logits)


class KVNANDEngine:
    def __init__(self, cfg: ModelConfig, eng: Optional[EngineConfig] = None,
                 rt: Optional[Runtime] = None, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP A17, multiple "
                "GPUs)")
        self.cfg = cfg
        self.eng = eng or EngineConfig()
        self.rt = rt or Runtime()
        self.device = torch.device(device)
        check_supported(cfg)
        paged_kv.check_supported(self.eng)
        if self.eng.variant != "compact" or self.eng.hg_pipeline:
            raise NotImplementedError(
                "the discrete head-group-pipelined variant is not ported "
                "yet (ROADMAP A15)")

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_context: int) -> DecodeCache:
        return paged_kv.init_cache(self.cfg, self.eng, batch, max_context,
                                   dtype=getattr(torch, self.eng.kv_dtype),
                                   device=self.device)

    def _page_bases(self, table: torch.Tensor) -> torch.Tensor:
        """Page base positions [B, NP] (the reference's `_global_bases`).
        A shared pool walks LOGICAL pages through the table, so logical
        page j's base is j·T and entries past `lengths` are masked by the
        length alone; the stripe table permutes pages within the stripe,
        so it is inverted here into physical-page-indexed bases."""
        B, NP = table.shape
        T = self.eng.page_tokens
        vals = (torch.arange(NP, dtype=torch.int32, device=table.device)
                * T)[None].expand(B, NP)
        if self.eng.shared_pool:
            return vals.contiguous()
        return torch.zeros((B, NP), dtype=torch.int32,
                           device=table.device).scatter_(1, table.long(), vals)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _attend_heads(self, q, kp, vp, base, lengths, table=None, ks=None,
                      vs=None):
        """All heads at once (KVNAND-C, the reference's `_attend_compact`):
        q [B, 1, H, dh] against the layer's already-appended pool slices
        kp/vp (a shared pool's through `table`; ks/vs their kv8/kv4
        scales)."""
        o, _, _ = paged_attention_partial(
            q[:, 0], kp, vp, base, lengths + 1,
            kv_quant=self.eng.kv_quant if ks is not None else "none",
            k_scale=ks, v_scale=vs, page_table=table,
            partitions=self.eng.attn_partitions)
        return o

    def _decode_attention(self, pl_, x, cache: DecodeCache, layer: int,
                           lengths, base, active, rows):
        """One layer's decode attention (the reference's
        `_decode_attn_layer`): append the token's K/V, attend, project
        out.  Float stripe pools mask inactive rows with `active`; a shared
        pool and the requantizing kv8/kv4 appends write only the active
        `rows` (see `core/paged_kv.py`)."""
        cfg = self.cfg
        h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
        # one projection serves the append (k, v) and the attention (q);
        # the reference projects twice with identical results
        q, k_new, v_new = attn_mod.project_qkv(pl_["attn"], cfg, h,
                                               lengths[:, None])
        T = self.eng.page_tokens
        NP = cache.page_table_g.shape[1]
        logical = (lengths // T).long().clamp(max=NP - 1)
        phys = torch.gather(cache.page_table_g, 1, logical[:, None])[:, 0]
        slot = lengths % T
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        for pool, scale, new in ((cache.k_pages_g, cache.k_scale_g, k_new),
                                 (cache.v_pages_g, cache.v_scale_g, v_new)):
            if fmt != "none":
                append = (paged_kv.append_token_quant_shared if shared
                          else paged_kv.append_token_quant)
                append(pool, scale, layer, phys, slot, new[:, 0], fmt, rows)
            elif shared:
                paged_kv.append_global_shared(pool, layer, phys, slot,
                                              new[:, 0], rows)
            else:
                paged_kv.append_token_inplace(pool, layer, phys, slot,
                                              new[:, 0], active)
        table = cache.page_table_g if shared else None
        ks = vs = None
        if fmt != "none":
            ks, vs = cache.k_scale_g[layer], cache.v_scale_g[layer]
        o = self._attend_heads(q, cache.k_pages_g[layer],
                               cache.v_pages_g[layer], base, lengths, table,
                               ks, vs)
        return attn_mod.project_out(pl_["attn"], cfg, o[:, None])

    def decode_step(self, params, cache: DecodeCache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """tokens: [B, 1] -> (logits [B, V], cache updated in place).

        active: optional [B] bool mask — inactive slots (empty, or mid
        chunked prefill) get no KV append and no length advance; their
        logits are computed and ignored by the caller."""
        cfg = self.cfg
        if active is not None and self.eng.uniform_lengths:
            raise ValueError("active-mask decode requires the ragged "
                             "(uniform_lengths=False) append path")
        x = embed_lookup(params["embedding"], tokens, self.rt.activ_dtype)
        if cfg.family == "ssm":
            x = self._recurrent_layers(params, x, cache, slice(None),
                                       fresh=False, active=active,
                                       chunked=False)
        else:
            x = self._attention_decode_layers(params, x, cache, active)
        cache.lengths += (1 if active is None
                          else active.to(cache.lengths.dtype))
        return lm_head_logits(params, cfg, x)[:, 0], cache

    def _attention_decode_layers(self, params, x, cache: DecodeCache,
                                 active):
        """decode_step's layer loop over the paged pool."""
        cfg = self.cfg
        lengths = cache.lengths
        base = self._page_bases(cache.page_table_g)
        # the writing rows of a shared pool or a requantizing append, read
        # once per step (on a card this is one device-to-host sync)
        row_writers = self.eng.shared_pool or self.eng.kv_quant != "none"
        rows = (active.nonzero()[:, 0]
                if row_writers and active is not None else None)
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            x = x + self._decode_attention(pl_, x, cache, i, lengths,
                                            base, active, rows)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        return x

    # ------------------------------------------------------------------
    # RWKV6: recurrent state in place of a pool
    # ------------------------------------------------------------------
    def _recurrent_layers(self, params, x, cache: DecodeCache, rows: slice,
                          *, fresh: bool, active=None, chunked: bool = True):
        """Every RWKV6 block over x [n, S, D] (the reference's
        `_rwkv_decode_block` / `_rwkv_chunk_block` /
        `_rwkv_prefill_block`): each layer starts from the state and
        shifts of cache rows `rows` (zero when `fresh`) and stores its new
        ones back there, rows with `active` False frozen.  chunked=True
        runs a multi-token x through `wkv6` (kernel B5 on a card)."""
        cfg = self.cfg
        n = x.shape[0]
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            if fresh:
                st = torch.zeros((n,) + cache.rwkv_state.shape[2:],
                                 dtype=torch.float32, device=x.device)
                sh = sh2 = torch.zeros((n, cfg.d_model), dtype=x.dtype,
                                       device=x.device)
            else:
                st, sh, sh2 = (leaf[i, rows] for leaf in (
                    cache.rwkv_state, cache.rwkv_shift, cache.rwkv_shift2))
            x, st, sh, sh2 = rwkv6.rwkv_block(pl_, cfg, x, st, sh, sh2,
                                              chunked=chunked)
            paged_kv.write_recurrent_state(cache, i, rows, st, sh, sh2,
                                           active)
        return x

    # ------------------------------------------------------------------
    # one-shot prefill
    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_context: int,
                prompt_len: Optional[int] = None):
        """Full-prompt prefill of every row: batch["tokens"] [B, S] ->
        (last-token logits [B, V], a fresh cache of max(max_context,
        S + 1) tokens per row holding the prompts' K/V).

        prompt_len: the count of real tokens (the same for every row)
        when the trailing tokens are bucket padding: `lengths` and the
        logits then come from the true last token, while the padding's
        K/V are written to the pages past it like any other token, as
        in the reference (masked by `lengths`, overwritten by decode
        appends).  An RWKV6 model takes exact-length prompts only (the
        padding would fold into its recurrent state), as in the reference;
        its refusal of a tiered pool is made at construction here."""
        cfg, rt = self.cfg, self.rt
        if prompt_len is not None and cfg.family == "ssm":
            raise ValueError(
                f"{cfg.family}: bucketed prefill would fold padding into "
                "recurrent state; pass exact-length prompts instead")
        x, positions = embed_inputs(params, cfg, batch, rt)
        B, S = x.shape[:2]
        cache = self.init_cache(B, max(max_context, S + 1))
        if cfg.family == "ssm":
            x = self._recurrent_layers(params, x, cache, slice(None),
                                       fresh=True)
            cache.lengths.fill_(S)
            return lm_head_logits(params, cfg, x[:, -1:])[:, 0], cache
        table = cache.page_table_g if self.eng.shared_pool else None
        fmt = self.eng.kv_quant
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.project_qkv(pl_["attn"], cfg, h, positions)
            o = attn_mod.sharded_flash_attention(q, k, v, causal=True,
                                                 impl=rt.attn_impl)
            x = x + attn_mod.project_out(pl_["attn"], cfg, o)
            for pool, sc, kv in ((cache.k_pages_g, cache.k_scale_g, k),
                                 (cache.v_pages_g, cache.v_scale_g, v)):
                paged_kv.fill_layer(pool, kv, i, table=table, scale=sc,
                                    kv_quant=fmt)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        n = S if prompt_len is None else prompt_len
        cache.lengths.fill_(n)
        return lm_head_logits(params, cfg, x[:, n - 1:n])[:, 0], cache

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def prefill_chunk(self, params, cache: DecodeCache, batch, slot: int,
                      start: int, chunk_len: int, *, first: bool = False):
        """One page-aligned chunk of ONE slot's prompt, straight into the
        slot's pages (its stripe, or the shared-pool pages its table row
        names: the scheduler has allocated them before the call).

        batch["tokens"]: [1, C] (C = the scheduler's chunk bucket, the
        tail is padding); start: absolute position of the chunk's first
        token (a multiple of page_tokens); chunk_len: valid tokens.
        first=True skips the past-page partial.  Returns (logits [1, V]
        at the chunk's last valid token, cache updated in place).

        An RWKV6 model carries the slot's recurrent state instead (zero
        state when `first`): the scheduler sends its whole prompt as one
        exact-length chunk."""
        cfg = self.cfg
        if first:
            x, _ = embed_inputs(params, cfg, batch, self.rt)
        else:
            x = embed_lookup(params["embedding"], batch["tokens"],
                             self.rt.activ_dtype)
        if cfg.family == "ssm":
            x = self._recurrent_layers(params, x, cache,
                                       slice(slot, slot + 1), fresh=first)
        else:
            x = self._attention_chunk_layers(params, x, cache, slot, start,
                                             chunk_len, first)
        cache.lengths[slot] = start + chunk_len
        x_last = x[:, chunk_len - 1:chunk_len]
        return lm_head_logits(params, cfg, x_last)[:, 0], cache

    def _attention_chunk_layers(self, params, x, cache: DecodeCache,
                                slot: int, start: int, chunk_len: int,
                                first: bool):
        """prefill_chunk's layer loop over the paged pool."""
        cfg = self.cfg
        S = x.shape[1]
        q_pos = start + torch.arange(S, device=x.device)
        positions = q_pos[None]
        page0 = start // self.eng.page_tokens
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        trow = cache.page_table_g[slot]     # the slot's row (shared pool)
        base = self._page_bases(cache.page_table_g[slot:slot + 1])
        scale = cfg.d_head ** -0.5
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.project_qkv(pl_["attn"], cfg, h, positions)
            # in-chunk causal partial over the chunk's own full-precision K/V
            o, m, l = seqpar._attn_block_partial(
                q, k, v, q_pos, start, causal=True, window=None, scale=scale)
            if not first:
                # past-context partial from the slot's already-written pages
                kp, vp, ks, vs = (
                    None if a is None else a[i] if shared
                    else a[i, slot:slot + 1]
                    for a in (cache.k_pages_g, cache.v_pages_g,
                              cache.k_scale_g, cache.v_scale_g))
                o2, m2, l2 = paged_chunk_attention(
                    q, kp, vp, base, start, q_pos, kv_quant=fmt, k_scale=ks,
                    v_scale=vs,
                    page_table=trow[None] if shared else None,
                    partitions=self.eng.attn_partitions)
                o, m, l = seqpar.merge_two(o, m, l, o2, m2, l2)
            x = x + attn_mod.project_out(pl_["attn"], cfg, o.to(h.dtype))
            for pool, sc, kv in ((cache.k_pages_g, cache.k_scale_g, k),
                                 (cache.v_pages_g, cache.v_scale_g, v)):
                if shared:
                    paged_kv.fill_chunk_global_at_shared(
                        pool, kv, i, trow, page0, chunk_len, scale=sc,
                        kv_quant=fmt)
                else:
                    paged_kv.fill_chunk_global_at(
                        pool, kv, i, slot, page0, chunk_len, scale=sc,
                        kv_quant=fmt)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        return x
