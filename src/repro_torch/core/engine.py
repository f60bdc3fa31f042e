"""KVNAND engine: one-shot and chunked prefill, decode and speculative
verify over the paged KV pool (port of `repro.core.engine`, single
device).

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

A sliding-window arch (gemma3) keeps its local layers in window rings
beside the global pool (`paged_kv.layer_pools` maps a layer to its pool
and its index there, the reference's `_g_off` / `_w_off`): a local
layer's token lands in ring slot (t // T) % NPw, its attention reads the
ring with `page_pos_w` as the page bases and the arch's window, and a
fresh ring page's base is recorded before the layers run
(`paged_kv.advance_ring_bases`), as the reference's decode step does.
Prefills fill the ring's newest real pages and then set the slot's
bases; a chunk's past partial reads the ring as it stood before the
chunk, in each layer before that layer's fill overwrites the oldest
slots the chunk's first queries still see.

Two decode variants, as in the reference: compact (KVNAND-C) attends
every head in one launch; discrete (KVNAND-D, `variant="discrete"` or
`hg_pipeline`) walks the layer's kv heads one group at a time, issuing
the q projection of group i + 1 before group i's attention on the one
stream (the reference's issue order), each group's attention one launch
over its heads of the pool, read in place.

`verify_step` scores a drafted span of S tokens a slot in one forward
pass (speculative draft-and-verify): an in-span causal partial over the
span's own K/V and a past partial over the slot's pages, merged by
log-sum-exp; the caller's `accept` callback says how many drafts each
slot keeps, and only the kept positions' K/V are appended (the rollback
is "never written").

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
as in the reference.  Not ported yet, and refused here: the tiered
pool, the hybrid, MoE, VLM and encoder-decoder families and a device
mesh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import paged_kv, seqpar
from repro_torch.core.paged_kv import DecodeCache
from repro_torch.kernels.paged_attention import (paged_attention_partial,
                                                 paged_chunk_attention,
                                                 paged_chunk_attention_ref)
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
        # the reference's selection (`_decode_attn_layer`)
        self._discrete = (self.eng.variant == "discrete"
                          or self.eng.hg_pipeline)
        # per layer: (in a window ring?, index in its pool)
        self._pool_of = paged_kv.layer_pools(cfg)
        parts = self.eng.attn_partitions
        if (cfg.window is not None and cfg.family != "ssm" and parts
                and paged_kv.ring_pages(cfg, self.eng.page_tokens) % parts):
            # the reference raises at its first decode step instead
            raise NotImplementedError(
                f"{cfg.name}: attn_partitions={parts} does not divide the "
                f"window ring's "
                f"{paged_kv.ring_pages(cfg, self.eng.page_tokens)} pages "
                "(ROADMAP A24, split-page partitions over window rings)")

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

    def _layer_pool(self, cache: DecodeCache, layer: int):
        """(ring, j, k, v, k_scale, v_scale): layer's pool group (the
        window rings or the global pool), its index j there, and the
        group's stacked leaves (scales None unless kv8/kv4)."""
        ring, j = self._pool_of[layer]
        sfx = "w" if ring else "g"
        return (ring, j) + tuple(getattr(cache, f"{n}_{sfx}") for n in (
            "k_pages", "v_pages", "k_scale", "v_scale"))

    def _page_of(self, cache: DecodeCache, ring: bool,
                 pos: torch.Tensor) -> torch.Tensor:
        """Physical page of token positions pos [..., B] (int64): the
        global pool's logical page through `page_table_g`, or the ring
        slot (t // T) % NPw — on a shared pool through `page_table_w`."""
        T = self.eng.page_tokens
        pos = pos.long()
        if ring:
            slot = paged_kv.ring_slot(pos, T, cache.page_pos_w.shape[1])
            if not self.eng.shared_pool:
                return slot
            table = cache.page_table_w
        else:
            table = cache.page_table_g
            slot = (pos // T).clamp(max=table.shape[1] - 1)
        flat = slot.reshape(-1, table.shape[0])
        return torch.gather(table.long().t(), 0, flat).reshape(slot.shape)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _attend_heads(self, q, kp, vp, base, lengths, window=None,
                      table=None, ks=None, vs=None):
        """All heads at once (KVNAND-C, the reference's `_attend_compact`):
        q [B, 1, H, dh] against the layer's already-appended pool slices
        kp/vp (a shared pool's through `table`; ks/vs their kv8/kv4
        scales), over the last `window` tokens on a local layer."""
        o, _, _ = paged_attention_partial(
            q[:, 0], kp, vp, base, lengths + 1, window=window,
            kv_quant=self.eng.kv_quant if ks is not None else "none",
            k_scale=ks, v_scale=vs, page_table=table,
            partitions=self.eng.attn_partitions)
        return o

    def _attend_groups(self, pl_, h, kp, vp, base, lengths, window=None,
                       table=None, ks=None, vs=None):
        """Head-group pipelined attention (KVNAND-D, the reference's
        `_attend_discrete`): group i's q projection and its attention over
        kv head i of the already-appended layer pool, in the reference's
        issue order (group i + 1's q projection before group i's
        attention; nothing between them depends on the other).  Returns
        o [B, H, dh]."""
        cfg = self.cfg
        K = cfg.n_kv_heads
        x_tok = h[:, 0]
        fmt = self.eng.kv_quant if ks is not None else "none"
        length = lengths + 1
        q_cur = attn_mod.project_q_group(pl_["attn"], cfg, x_tok, 0, lengths)
        outs = []
        for i in range(K):
            q_next = (attn_mod.project_q_group(pl_["attn"], cfg, x_tok,
                                               i + 1, lengths)
                      if i + 1 < K else None)
            o, _, _ = paged_attention_partial(
                q_cur, kp, vp, base, length, window=window, kv_quant=fmt,
                k_scale=ks, v_scale=vs, page_table=table,
                partitions=self.eng.attn_partitions, kv_heads=(i, 1))
            outs.append(o)
            q_cur = q_next
        return torch.cat(outs, dim=1)

    def _decode_attention(self, pl_, x, cache: DecodeCache, layer: int,
                           lengths, base_g, active, rows):
        """One layer's decode attention (the reference's
        `_decode_attn_layer`): append the token's K/V into the layer's
        pool (a local layer's ring slot, the global pool's page), attend,
        project out.  Float stripe pools mask inactive rows with
        `active`; a shared pool and the requantizing kv8/kv4 appends write
        only the active `rows` (see `core/paged_kv.py`)."""
        cfg = self.cfg
        h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
        # one projection serves the append (k, v) and the attention (q);
        # the reference projects twice with identical results.  The
        # discrete variant projects q a head group at a time instead
        if self._discrete:
            q = None
            k_new, v_new = attn_mod.project_kv(pl_["attn"], cfg, h,
                                               lengths[:, None])
        else:
            q, k_new, v_new = attn_mod.project_qkv(pl_["attn"], cfg, h,
                                                   lengths[:, None])
        ring, j, kpool, vpool, kscale, vscale = self._layer_pool(cache,
                                                                 layer)
        T = self.eng.page_tokens
        phys = self._page_of(cache, ring, lengths)
        slot = lengths % T
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        for pool, scale, new in ((kpool, kscale, k_new),
                                 (vpool, vscale, v_new)):
            if fmt != "none":
                append = (paged_kv.append_token_quant_shared if shared
                          else paged_kv.append_token_quant)
                append(pool, scale, j, phys, slot, new[:, 0], fmt, rows)
            elif shared:
                paged_kv.append_global_shared(pool, j, phys, slot,
                                              new[:, 0], rows)
            else:
                paged_kv.append_token_inplace(pool, j, phys, slot,
                                              new[:, 0], active)
        if ring:
            base, window = cache.page_pos_w, cfg.window
            table = cache.page_table_w if shared else None
        else:
            base, window = base_g, None
            table = cache.page_table_g if shared else None
        ks = vs = None
        if fmt != "none":
            ks, vs = kscale[j], vscale[j]
        kp, vp = kpool[j], vpool[j]
        if self._discrete:
            o = self._attend_groups(pl_, h, kp, vp, base, lengths, window,
                                    table, ks, vs)
        else:
            o = self._attend_heads(q, kp, vp, base, lengths, window, table,
                                   ks, vs)
        return attn_mod.project_out(pl_["attn"], cfg, o[:, None])

    def decode_step(self, params, cache: DecodeCache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """tokens: [B, 1] -> (logits [B, V], cache updated in place).

        active: optional [B] bool mask — inactive slots (empty, or mid
        chunked prefill) get no KV append, no ring-base refresh and no
        length advance; their logits are computed and ignored by the
        caller."""
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
        """decode_step's layer loop over the paged pool and rings."""
        cfg = self.cfg
        lengths = cache.lengths
        base_g = (self._page_bases(cache.page_table_g)
                  if cache.page_table_g is not None else None)
        if cache.page_pos_w is not None:
            # a token that opens a ring page gives that slot its new base
            # before any local layer attends (the reference's
            # `_page_pos_w_new`)
            paged_kv.advance_ring_bases(cache.page_pos_w, lengths,
                                        self.eng.page_tokens, active)
        # the writing rows of a shared pool or a requantizing append, read
        # once per step (on a card this is one device-to-host sync)
        row_writers = self.eng.shared_pool or self.eng.kv_quant != "none"
        rows = (active.nonzero()[:, 0]
                if row_writers and active is not None else None)
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            x = x + self._decode_attention(pl_, x, cache, i, lengths,
                                            base_g, active, rows)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        return x

    # ------------------------------------------------------------------
    # speculative decode: draft-and-verify over an S-token span
    # ------------------------------------------------------------------
    def verify_step(self, params, cache: DecodeCache, tokens: torch.Tensor,
                    *, accept, active: Optional[torch.Tensor] = None):
        """Score a drafted span in one forward pass and append only the
        kept prefix (the reference's `verify_step`).

        tokens: [B, S] — per slot, the last emitted token, then S - 1
        drafts; logits at span position j are the target distribution of
        the token after tokens[:, j].  The span attends through the
        two-partial merge of chunked prefill: a causal in-span partial
        over the span's own K/V in relative coordinates (one call serves
        every slot whatever its length), and a past partial over the
        slot's pages (`paged_chunk_attention`, per-row start and query
        positions; plain torch on every device, as in the reference),
        merged by log-sum-exp.  A float pool's span K/V (and q) are
        rounded through the pool dtype first, since sequential decode
        would read them back from the pool.  Over a kv8/kv4 pool the span
        reads its pages as the requantizing appends would leave them
        after each position (`_span_quant_attention`), where the
        reference reads the span's K/V in full precision: the verify
        forward then sees sequential decode's values in every format.

        accept: ``logits [B, S, V] -> (n_acc [B], aux)``, the scheduler's
        sampler (`speculative_accept`).  Then ``n_acc + 1`` span tokens of
        each active slot (the last emitted token's K/V and the accepted
        drafts) are appended through the span writers, and `lengths`
        advance by that count; rejected positions are never written.
        Inactive slots append nothing and keep their length.  Returns
        (aux, cache updated in place)."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"{cfg.family}: speculative verification cannot roll back "
                "carried recurrent state; decode sequentially")
        if self.eng.uniform_lengths:
            raise ValueError("verify_step requires the ragged "
                             "(uniform_lengths=False) append path: slots "
                             "accept different span lengths")
        B, S = tokens.shape
        dev = tokens.device
        lengths = cache.lengths
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        scale = cfg.d_head ** -0.5
        base_g = (self._page_bases(cache.page_table_g)
                  if cache.page_table_g is not None else None)
        rel = torch.arange(S, device=dev)
        positions = lengths[:, None] + rel[None].to(lengths.dtype)
        x = embed_lookup(params["embedding"], tokens, self.rt.activ_dtype)
        span_k, span_v = [], []
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.project_qkv(pl_["attn"], cfg, h, positions)
            ring, j, *pool = self._layer_pool(cache, i)
            kp, vp, ks, vs = (None if a is None else a[j] for a in pool)
            # a local layer sees the last `window` tokens, in the span
            # (relative positions) and in its ring, whose bases are the
            # ones before this step
            window = cfg.window if ring else None
            base = cache.page_pos_w if ring else base_g
            table = cache.page_table_w if ring else cache.page_table_g
            if fmt == "none":
                kv_dt = getattr(torch, self.eng.kv_dtype)
                o, m, l = seqpar._attn_block_partial(
                    (q.float() * scale).to(kv_dt), k.to(kv_dt), v.to(kv_dt),
                    rel, 0, causal=True, window=window, scale=1.0)
                o2, m2, l2 = paged_chunk_attention(
                    q, kp, vp, base, lengths, positions, window=window,
                    kv_quant=fmt, page_table=table if shared else None,
                    partitions=self.eng.attn_partitions)
                o, m, l = seqpar.merge_two(o, m, l, o2, m2, l2)
            else:
                o, m, l = self._span_quant_attention(
                    cache, ring, q, k, v, kp, vp, ks, vs, base,
                    table if shared else None, lengths, positions, window)
            x = x + attn_mod.project_out(pl_["attn"], cfg, o.to(h.dtype))
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
            span_k.append(k)
            span_v.append(v)
        logits = lm_head_logits(params, cfg, x)                 # [B, S, V]

        n_acc, aux = accept(logits)
        n_write = (torch.as_tensor(n_acc, device=dev).to(lengths.dtype)
                   + 1).clamp(0, S)
        if active is not None:
            n_write = torch.where(active, n_write, torch.zeros_like(n_write))
        self._append_kept_span(cache, span_k, span_v, n_write)
        if cache.page_pos_w is not None:
            # ring bases advance only for pages a KEPT token opened,
            # position by position as sequential decode would
            for s_ in range(S):
                paged_kv.advance_ring_bases(cache.page_pos_w, lengths + s_,
                                            self.eng.page_tokens,
                                            n_write > s_)
        cache.lengths += n_write
        return aux, cache

    def _span_quant_attention(self, cache: DecodeCache, ring: bool, q, k, v,
                              kp, vp, ks, vs, base, table, lengths,
                              positions, window):
        """The span's attention over a kv8/kv4 pool with the values
        sequential decode would read: keys before the page holding each
        row's first span position come from the pool (the past partial,
        start = that page's base), and the span's pages from the
        requantizing appends' chain after each position
        (`paged_kv.span_page_chain`), one query position at a time, merged
        by log-sum-exp.  (The reference attends the span's own K/V in full
        precision here, which can differ from sequential decode by the
        format's quantization noise and so flip a near-tie; this keeps
        speculative tokens equal to sequential ones.)  On a ring the page
        holding the first position may be a recycled one: a chain that
        starts at its token 0 zeroes the previous occupant, as the
        append does."""
        T = self.eng.page_tokens
        fmt = self.eng.kv_quant
        B, S = q.shape[:2]
        slot0 = lengths % T
        first = lengths - slot0
        past = paged_chunk_attention(
            q, kp, vp, base, first, positions, window=window, kv_quant=fmt,
            k_scale=ks, v_scale=vs, page_table=table,
            partitions=self.eng.attn_partitions)
        phys0 = self._page_of(cache, ring, lengths)
        if self.eng.shared_pool:
            k0, v0 = kp[:, phys0].transpose(0, 1), vp[:, phys0].transpose(0, 1)
            ks0, vs0 = ks[:, phys0].t(), vs[:, phys0].t()
        else:
            rows = torch.arange(B, device=q.device)
            k0, v0 = kp[rows, :, phys0], vp[rows, :, phys0]
            ks0, vs0 = ks[rows, :, phys0], vs[rows, :, phys0]
        kc, ksc = paged_kv.span_page_chain(k0, ks0, slot0, k, fmt, T)
        vc, vsc = paged_kv.span_page_chain(v0, vs0, slot0, v, fmt, T)
        n = kc.shape[3]
        page_base = (first[:, None] + torch.arange(
            n, device=q.device, dtype=first.dtype)[None] * T).to(torch.int32)
        parts = [paged_chunk_attention_ref(
            q[:, j:j + 1], kc[j], vc[j], page_base, lengths + j + 1,
            positions[:, j:j + 1], window=window, kv_quant=fmt,
            k_scale=ksc[j], v_scale=vsc[j]) for j in range(S)]
        span = [torch.cat(x, dim=1) for x in zip(*parts)]
        return seqpar.merge_two(*past, *span)

    def _append_kept_span(self, cache: DecodeCache, span_k, span_v,
                          n_write: torch.Tensor):
        """Append span positions s < n_write[b] of each row b, every
        layer (the reference's gated `append_body`), into the global
        pool's pages or a local layer's ring slots.  The kept rows of
        each position are read to the host once (one device-to-host sync
        a verify step) and every writer takes them as its row subset."""
        T = self.eng.page_tokens
        S = span_k[0].shape[1]
        dev = n_write.device
        keep = n_write.cpu().numpy()
        rows = [torch.as_tensor(np.flatnonzero(keep > s), device=dev)
                for s in range(int(keep.max(initial=0)))]
        if not rows:
            return
        pos = (cache.lengths[None, :].long()
               + torch.arange(S, device=dev)[:, None])         # [S, B]
        phys = {ring: self._page_of(cache, ring, pos)
                for ring in {r for r, _ in self._pool_of}}
        slot = pos % T
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        for i, (k, v) in enumerate(zip(span_k, span_v)):
            ring, j, kpool, vpool, kscale, vscale = self._layer_pool(cache, i)
            for pool, sc, val in ((kpool, kscale, k), (vpool, vscale, v)):
                if fmt != "none":
                    append = (paged_kv.append_span_quant_shared if shared
                              else paged_kv.append_span_quant)
                    append(pool, sc, j, phys[ring], slot, val, fmt, rows)
                elif shared:
                    paged_kv.append_span_shared(pool, j, phys[ring], slot,
                                                val, rows)
                else:
                    paged_kv.append_span(pool, j, phys[ring], slot, val,
                                         rows)

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
        when the trailing tokens are bucket padding: `lengths`, the ring
        bases and the logits then come from the true last token; the
        padding's K/V are written to the global pool's pages past it like
        any other token, as in the reference (masked by `lengths`,
        overwritten by decode appends), and never to a ring.  An RWKV6 model takes exact-length prompts only (the
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
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        n = S if prompt_len is None else prompt_len
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.project_qkv(pl_["attn"], cfg, h, positions)
            ring, j, kpool, vpool, kscale, vscale = self._layer_pool(cache, i)
            o = attn_mod.sharded_flash_attention(
                q, k, v, causal=True, window=cfg.window if ring else None,
                impl=rt.attn_impl)
            x = x + attn_mod.project_out(pl_["attn"], cfg, o)
            table = None
            if shared:
                table = cache.page_table_w if ring else cache.page_table_g
            # a ring keeps the newest pages of the n real tokens, so
            # bucket padding never evicts a live page
            for pool, sc, kv in ((kpool, kscale, k), (vpool, vscale, v)):
                paged_kv.fill_layer(pool, kv, j, ring=ring,
                                    true_len=n if ring else None,
                                    table=table, scale=sc, kv_quant=fmt)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        cache.lengths.fill_(n)
        if cache.page_pos_w is not None:
            paged_kv.write_ring_bases(cache.page_pos_w, slice(None), n,
                                      self.eng.page_tokens)
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
        """prefill_chunk's layer loop over the paged pool and rings."""
        cfg = self.cfg
        S = x.shape[1]
        q_pos = start + torch.arange(S, device=x.device)
        positions = q_pos[None]
        page0 = start // self.eng.page_tokens
        shared = self.eng.shared_pool
        fmt = self.eng.kv_quant
        scale = cfg.d_head ** -0.5
        # the slot's table rows (shared pool) and page bases; a ring's
        # bases are read as they stood before this chunk (they are
        # rewritten after the layers), and chunk 0 reads none
        trow = {False: None, True: None}
        base = {False: None, True: None}
        if cache.page_table_g is not None:
            trow[False] = cache.page_table_g[slot]
            base[False] = self._page_bases(cache.page_table_g[slot:slot + 1])
        if cache.page_pos_w is not None:
            base[True] = cache.page_pos_w[slot:slot + 1]
            if shared:
                trow[True] = cache.page_table_w[slot]
        for i in range(cfg.n_layers):
            pl_ = layer_slice(params["layers"], i)
            h = rms_norm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.project_qkv(pl_["attn"], cfg, h, positions)
            ring, j, *pool = self._layer_pool(cache, i)
            window = cfg.window if ring else None
            # in-chunk causal partial over the chunk's own full-precision K/V
            o, m, l = seqpar._attn_block_partial(
                q, k, v, q_pos, start, causal=True, window=window,
                scale=scale)
            if not first:
                # past-context partial from the slot's already-written
                # pages, read before this layer's fill below overwrites a
                # ring's oldest slots
                kp, vp, ks, vs = (
                    None if a is None else a[j] if shared
                    else a[j, slot:slot + 1] for a in pool)
                o2, m2, l2 = paged_chunk_attention(
                    q, kp, vp, base[ring], start, q_pos, window=window,
                    kv_quant=fmt, k_scale=ks, v_scale=vs,
                    page_table=trow[ring][None] if shared else None,
                    partitions=self.eng.attn_partitions)
                o, m, l = seqpar.merge_two(o, m, l, o2, m2, l2)
            x = x + attn_mod.project_out(pl_["attn"], cfg, o.to(h.dtype))
            kpool, vpool, kscale, vscale = pool
            for pl, sc, kv in ((kpool, kscale, k), (vpool, vscale, v)):
                if shared:
                    fill = (paged_kv.fill_chunk_window_at_shared if ring
                            else paged_kv.fill_chunk_global_at_shared)
                    fill(pl, kv, j, trow[ring], page0, chunk_len, scale=sc,
                         kv_quant=fmt)
                else:
                    fill = (paged_kv.fill_chunk_window_at if ring
                            else paged_kv.fill_chunk_global_at)
                    fill(pl, kv, j, slot, page0, chunk_len, scale=sc,
                         kv_quant=fmt)
            h = rms_norm(x, pl_["ln2"], cfg.norm_eps)
            x = x + mlp(pl_["mlp"], h, cfg.gated_mlp)
        if cache.page_pos_w is not None:
            paged_kv.write_ring_bases(cache.page_pos_w, slot,
                                      start + chunk_len,
                                      self.eng.page_tokens)
        return x
