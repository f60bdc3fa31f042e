"""Per-cell step builders (port of `repro.launch.steps`): (arch × shape ×
mesh) → a step callable, its arguments as meta tensors, and their
sharding trees.  Used by the dry-run (`launch/dryrun.py`) and by
`chip_smoke.py`'s F1, which runs the same cell on the card.

A cell's `jitted` is a plain callable over its arguments (the reference
jits it with shardings and donation); `args_on(device, generator)`
builds those arguments with the constructors the meta ones came from,
on any device, so a card run of the cell holds the same leaves.

The reference lowers its dry-run through its plain path and accounts for
its kernels with the fusible hints; so does the port: `runtime_for`
keeps attn_impl="ref", and on meta tensors every kernel wrapper takes
its plain version and builds nothing.  On a mesh larger than one device
the step runs the single-device program (the port has no SPMD
partitioner; `launch/dryrun.py` splits its count evenly), while the
arguments and their shardings follow the mesh: the pools' page counts
are rounded to the page shards, and per-device argument bytes are exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import (SHAPES, EngineConfig, ModelConfig,
                                      ShapeConfig, get_config,
                                      shape_applicable)
from repro_torch.core import paged_kv
from repro_torch.core.engine import KVNANDEngine, ShardPlan, plan_sharding
from repro_torch.core.quant import quantize_params_and_specs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh, NamedSharding, P
from repro_torch.models import transformer
from repro_torch.models.registry import (batch_sharding_axes, input_specs,
                                         make_concrete_batch)
from repro_torch.models.transformer import Runtime
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import TrainState, make_train_step

FSDP_THRESHOLD = 8e9          # params above this shard over `data` too
BF16_MOMENTS_THRESHOLD = 3e11  # kimi-scale: bf16 AdamW moments

META = torch.device("meta")


def runtime_for(cfg: ModelConfig, kind: str = "serve") -> Runtime:
    # train: sequence-chunked CE — full [B, S, V] logits are the dominant
    # temp allocation at 150K–260K vocabs
    return Runtime(activ_dtype=torch.bfloat16, attn_impl="ref",
                   loss_chunk=1024 if kind == "train" else 0)


def engine_config_for(cfg: ModelConfig, shape: ShapeConfig,
                      overrides: Optional[Dict[str, Any]] = None
                      ) -> EngineConfig:
    kw: Dict[str, Any] = dict(remat="block")
    if shape.kind == "decode":
        # the reference's pick for its dry-run (the compact plan; the
        # paper's discrete plan stays selectable with --variant discrete)
        kw.update(variant="compact")
    if overrides:
        kw.update(overrides)
    return EngineConfig(**kw)


def _axes_or_none(axes: Tuple[str, ...]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _sh(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def batch_shardings(cfg, shape, mesh, rules):
    specs = input_specs(cfg, shape, runtime_for(cfg))
    axes = batch_sharding_axes(cfg, shape)
    return {name: NamedSharding(mesh, shd.spec_for_shape(
        t.shape, axes[name], rules, mesh)) for name, t in specs.items()}


def cache_shardings(cache, mesh: Mesh, plan: ShardPlan):
    b = _axes_or_none(plan.batch_axes)
    pg = _axes_or_none(plan.page_axes_g)
    pw = _axes_or_none(plan.page_axes_w)
    field_specs = {
        "k_pages_g": P(None, b, None, pg, None, None),
        "v_pages_g": P(None, b, None, pg, None, None),
        "page_table_g": P(b, None),
        "k_pages_w": P(None, b, None, pw, None, None),
        "v_pages_w": P(None, b, None, pw, None, None),
        "page_table_w": P(b, None),
        "page_pos_w": P(b, None),
        "k_scale_g": P(None, b, None, pg),
        "v_scale_g": P(None, b, None, pg),
        "k_scale_w": P(None, b, None, pw),
        "v_scale_w": P(None, b, None, pw),
        "rwkv_state": P(None, b, None, None, None),
        "rwkv_shift": P(None, b, None),
        "rwkv_shift2": P(None, b, None),
        "ssm_state": P(None, b, None, None),
        "conv_tail": P(None, b, None, None),
        "cross_k": P(None, b, "model", None, None),
        "cross_v": P(None, b, "model", None, None),
        "lengths": P(b),
    }
    # shared-pool leaves drop the batch dim (EngineConfig.shared_pool):
    # the physical page axis carries the page sharding instead
    shared_specs = {
        "k_pages_g": P(None, None, pg, None, None),
        "v_pages_g": P(None, None, pg, None, None),
        "k_pages_w": P(None, None, pw, None, None),
        "v_pages_w": P(None, None, pw, None, None),
        "k_scale_g": P(None, None, pg),
        "v_scale_g": P(None, None, pg),
        "k_scale_w": P(None, None, pw),
        "v_scale_w": P(None, None, pw),
    }
    kw = {}
    for f in dataclasses.fields(cache):
        leaf = getattr(cache, f.name)
        if leaf is None:
            kw[f.name] = None
            continue
        spec = field_specs[f.name]
        if len(spec) != leaf.ndim:
            spec = shared_specs[f.name]
        kw[f.name] = NamedSharding(mesh, spec)
    return type(cache)(**kw)


def shard_bytes(leaf: torch.Tensor, sharding: NamedSharding) -> float:
    """Bytes of one device's shard of `leaf` (XLA's shard shape: each
    dimension divided by the mesh axes its spec entry names)."""
    mesh = sharding.mesh
    n = leaf.numel()
    for dim, entry in zip(leaf.shape, sharding.spec):
        k = math.prod(mesh.shape[a] for a in shd.entry_axes(entry))
        n = n // dim * (-(-dim // k)) if dim else 0
    return float(n * leaf.element_size())


def argument_bytes(args, shardings) -> float:
    """Per-device bytes of a step's arguments (XLA's
    `argument_size_in_bytes`): trees of one structure, a leaf's bytes
    divided by its sharding's mesh axes."""
    from repro_torch.core.quant import QuantizedWeight
    if args is None:
        return 0.0
    if isinstance(args, torch.Tensor):
        return shard_bytes(args, shardings)
    if isinstance(args, QuantizedWeight):
        return (argument_bytes(args.q, shardings.q)
                + argument_bytes(args.scale, shardings.scale))
    if isinstance(args, dict):
        return sum(argument_bytes(v, shardings[k]) for k, v in args.items())
    if isinstance(args, (list, tuple)):
        return sum(argument_bytes(a, s) for a, s in zip(args, shardings))
    if dataclasses.is_dataclass(args):
        return sum(argument_bytes(getattr(args, f.name),
                                  getattr(shardings, f.name))
                   for f in dataclasses.fields(args))
    raise TypeError(f"argument_bytes: {type(args).__name__}")


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    kind: str
    jitted: Callable            # the step: a plain callable over the args
    abstract_args: Tuple        # meta tensors to run it on
    chips: int
    note: str = ""
    fusible_last2: frozenset = frozenset()   # attention-intermediate dims
    in_shardings: Tuple = ()    # a sharding tree per argument
    dp_shards: int = 1          # data-parallel shards of the batch
    args_on: Optional[Callable] = None       # (device, generator) -> args
    saved_bytes: float = 0.0    # train: what the backward must keep

    @property
    def argument_bytes(self) -> float:
        """Exact per-device argument bytes on the cell's mesh."""
        return argument_bytes(self.abstract_args, self.in_shardings)


def _train_fusible_hints(cfg: ModelConfig, total_seq: int,
                         mesh: Mesh) -> frozenset:
    """Score/probability block dims for ring attention + dense paths."""
    m = mesh.shape["model"]
    hints = set()
    for s in {total_seq, total_seq // m}:
        for s2 in {total_seq, total_seq // m}:
            hints.add((s, s2))
    if cfg.is_encoder_decoder:
        enc = total_seq // 4
        for a in {enc, enc // m, total_seq, total_seq // m}:
            for b in {enc, enc // m, total_seq, total_seq // m}:
                hints.add((a, b))
    return frozenset(hints)


def _decode_fusible_hints(cfg: ModelConfig, acache, eng: EngineConfig,
                          mesh: Mesh, plan) -> frozenset:
    hints = set()
    T = eng.page_tokens
    dh, G = cfg.d_head, cfg.group_size
    pools = (("k_pages_g", plan.page_axes_g), ("k_pages_w",
                                               plan.page_axes_w))
    for name, axes in pools:
        pool = getattr(acache, name, None)
        if pool is None:
            continue
        shards = 1
        for a in axes:
            shards *= mesh.shape.get(a, 1)
        npl = pool.shape[3] // max(shards, 1)
        for np_ in {npl, pool.shape[3]}:
            hints |= {(np_, T), (np_ * T, dh), (dh, np_ * T),
                      (G, np_ * T), (np_ * T, G), (np_ * T, T)}
    if getattr(acache, "cross_k", None) is not None:
        senc = acache.cross_k.shape[2]
        npc = senc // T
        hints |= {(npc, T), (npc * T, dh), (dh, npc * T)}
    return frozenset(hints)


def _shape_of(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _dp_shards(mesh: Mesh, sharding: NamedSharding) -> int:
    """The shards of a batch input's leading (batch) dimension."""
    return math.prod(mesh.shape[a]
                     for a in shd.entry_axes(sharding.spec[0]))


def _params_and_specs(cfg: ModelConfig, quant: str, device, generator):
    """(params, specs) in bf16, quantized when `quant` is set."""
    params, specs = transformer.init_model_with_specs(
        cfg, generator, device, torch.bfloat16)
    return quantize_params_and_specs(params, specs, quant)


def _params_on(cfg: ModelConfig, quant: str, device, generator):
    return _params_and_specs(cfg, quant, device, generator)[0]


def _param_specs(cfg: ModelConfig, quant: str):
    """The logical-axis tree of `_params_on`'s parameters."""
    return _params_and_specs(cfg, quant, META, None)[1]


def _batch_on(cfg, shape, rt, device, generator):
    """The input batch: meta specs, or random inputs on `device`."""
    abatch = input_specs(cfg, shape, rt)
    if torch.device(device).type == "meta":
        return abatch
    return make_concrete_batch(cfg, abatch, generator, rt, device=device)


def build_train_cell(arch: str, mesh: Mesh, *, multi_pod: bool,
                     eng_overrides=None, shape="train_4k",
                     rt: Optional[Runtime] = None) -> Cell:
    cfg = get_config(arch)
    shape = _shape_of(shape)
    rt = rt or runtime_for(cfg, kind="train")
    fsdp = cfg.param_count() * 2 > FSDP_THRESHOLD * 2  # bf16 bytes
    overrides = None
    if fsdp and cfg.is_moe:
        # for MoE, ZeRO-shard the per-expert FFN dim over `data` instead
        # of d_model (the reference's choice)
        overrides = {"embed": None, "moe_mlp": "data"}
    rules = shd.make_rules(fsdp=fsdp, multi_pod=multi_pod,
                           overrides=overrides)
    eng = engine_config_for(cfg, shape, eng_overrides)
    mdt = (torch.bfloat16 if cfg.param_count() > BF16_MOMENTS_THRESHOLD
           else torch.float32)
    acfg = opt_mod.AdamWConfig(moment_dtype=mdt)

    def args_on(device, generator=None):
        params = _params_on(cfg, "none", device, generator)
        state = TrainState(params=params,
                           opt=opt_mod.init_adamw(params, acfg), ef=None)
        return state, _batch_on(cfg, shape, rt, device, generator)

    astate, abatch = args_on(META)
    params_sh = shd.tree_shardings(astate.params, _param_specs(cfg, "none"),
                                   rules, mesh)
    state_sh = TrainState(
        params=params_sh,
        opt=opt_mod.AdamWState(step=_sh(mesh), m=params_sh, v=params_sh),
        ef=None)
    batch_sh = batch_shardings(cfg, shape, mesh, rules)
    step_fn = make_train_step(cfg, rt, acfg, eng)
    return Cell(arch, shape, "train", step_fn, (astate, abatch), mesh.size,
                note=f"fsdp={fsdp} moments={str(mdt)[6:]} "
                     f"remat={eng.remat}",
                fusible_last2=_train_fusible_hints(cfg, shape.seq_len, mesh),
                in_shardings=(state_sh, batch_sh),
                dp_shards=_dp_shards(mesh, batch_sh["tokens"]),
                args_on=args_on,
                # each layer's input: the least any remat keeps
                saved_bytes=float(cfg.n_layers * shape.global_batch
                                  * shape.seq_len * cfg.d_model
                                  * rt.activ_dtype.itemsize))


def build_prefill_cell(arch: str, mesh: Mesh, *, multi_pod: bool,
                       eng_overrides=None, shape="prefill_32k",
                       rt: Optional[Runtime] = None) -> Cell:
    cfg = get_config(arch)
    shape = _shape_of(shape)
    rt = rt or runtime_for(cfg)
    rules = shd.make_rules(fsdp=False, multi_pod=multi_pod)
    eng = engine_config_for(cfg, shape, eng_overrides)
    max_ctx = shape.seq_len + 1

    def args_on(device, generator=None):
        return (_params_on(cfg, eng.quant, device, generator),
                _batch_on(cfg, shape, rt, device, generator))

    aparams, abatch = args_on(META)
    params_sh = shd.tree_shardings(aparams, _param_specs(cfg, eng.quant),
                                   rules, mesh)
    batch_sh = batch_shardings(cfg, shape, mesh, rules)

    def prefill_step(params, batch):
        engine = KVNANDEngine(cfg, eng, rt, device=batch["tokens"].device)
        return engine.prefill(params, batch, max_ctx)

    return Cell(arch, shape, "prefill", prefill_step, (aparams, abatch),
                mesh.size, note=f"variant={eng.variant}",
                fusible_last2=_train_fusible_hints(cfg, shape.seq_len, mesh),
                in_shardings=(params_sh, batch_sh),
                dp_shards=_dp_shards(mesh, batch_sh["tokens"]),
                args_on=args_on)


def build_decode_cell(arch: str, shape_name, mesh: Mesh, *,
                      multi_pod: bool, eng_overrides=None,
                      rt: Optional[Runtime] = None) -> Cell:
    cfg = get_config(arch)
    shape = _shape_of(shape_name)
    rt = rt or runtime_for(cfg)
    rules = shd.make_rules(fsdp=False, multi_pod=multi_pod)
    eng = engine_config_for(cfg, shape, eng_overrides)
    engine = KVNANDEngine(cfg, eng, rt, mesh)
    B, S_ctx = shape.global_batch, shape.seq_len
    enc_len = (S_ctx // rt.enc_frames_ratio if cfg.is_encoder_decoder
               else 0)

    def args_on(device, generator=None):
        device = torch.device(device)
        params = _params_on(cfg, eng.quant, device, generator)
        cache = paged_kv.init_cache(
            cfg, eng, B, S_ctx + 8, device=device,
            **engine._cache_kw(B, S_ctx + 8, enc_len))
        if device.type == "meta":
            toks = torch.empty((B, 1), dtype=torch.int32, device=device)
        else:
            toks = torch.randint(0, cfg.vocab_size, (B, 1),
                                 generator=generator,
                                 device=generator.device).to(
                device=device, dtype=torch.int32)
        return params, cache, toks

    aparams, acache, atoks = args_on(META)
    NPg = (acache.k_pages_g.shape[3] if acache.k_pages_g is not None
           else 1)
    plan = plan_sharding(mesh, B, NPg)
    params_sh = shd.tree_shardings(aparams, _param_specs(cfg, eng.quant),
                                   rules, mesh)
    cache_sh = cache_shardings(acache, mesh, plan)
    tok_sh = NamedSharding(mesh, P(_axes_or_none(plan.batch_axes), None))

    def serve_step(params, cache, tokens):
        # the single-device program over the mesh's shapes
        runner = KVNANDEngine(cfg, eng, rt, device=tokens.device)
        return runner.decode_step(params, cache, tokens)

    return Cell(arch, shape, "decode", serve_step, (aparams, acache, atoks),
                mesh.size,
                note=f"variant={eng.variant} quant={eng.quant} "
                     f"pages={plan.page_axes_g}",
                fusible_last2=_decode_fusible_hints(cfg, acache, eng, mesh,
                                                    plan),
                in_shardings=(params_sh, cache_sh, tok_sh),
                dp_shards=_dp_shards(mesh, tok_sh),
                args_on=args_on)


def build_cell(arch: str, shape_name, mesh: Mesh, *, multi_pod: bool,
               eng_overrides=None, rt: Optional[Runtime] = None
               ) -> Optional[Cell]:
    """The cell of (arch, shape) on `mesh`, None where the shape does not
    apply to the arch.  `shape_name` may be a `ShapeConfig` of its own (a
    serving or training shape outside SHAPES); `rt` replaces the
    dry-run's runtime (`runtime_for`)."""
    cfg = get_config(arch)
    shape = _shape_of(shape_name)
    ok, _why = shape_applicable(cfg, shape)
    if not ok:
        return None
    kw = dict(multi_pod=multi_pod, eng_overrides=eng_overrides, rt=rt)
    if shape.kind == "train":
        return build_train_cell(arch, mesh, shape=shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(arch, mesh, shape=shape, **kw)
    return build_decode_cell(arch, shape, mesh, **kw)


# ---------------------------------------------------------------------------
# the step's function: what it needs, not what the eager program moves
# ---------------------------------------------------------------------------

_STATE = ("rwkv_state", "rwkv_shift", "rwkv_shift2", "ssm_state",
          "conv_tail")


def _nbytes(tree) -> float:
    from repro_torch.launch.op_cost import tensor_leaves
    return float(sum(t.numel() * t.element_size()
                     for t in tensor_leaves(tree)))


def _pool_shares(cache, suffix: str, ctx: int) -> Tuple[float, float]:
    """(the share of a pool's pages that hold a slot's `ctx` tokens and
    the one it appends, the share one new token a slot writes)."""
    pool = getattr(cache, "k_pages" + suffix)
    T = pool.shape[-2]
    need = -(-(ctx + 1) // T)
    if pool.ndim == 6:             # stripe [L, B, K, NP, T, dh]
        NP = pool.shape[3]
        return min(need, NP) / NP, 1.0 / (NP * T)
    B, NP = getattr(cache, "page_table" + suffix).shape
    P = pool.shape[2]              # shared [L, K, P, T, dh]
    return min(B * min(need, NP), P) / P, B / (P * T)


def _decode_cache_bytes(cache, ctx: int) -> float:
    """Bytes a decode step must move in its cache at `ctx` tokens a slot:
    the live pages (and their scales) read, one token's K/V a slot and
    layer written, the recurrent state read and written, the cross K/V,
    tables and lengths read (and the lengths written)."""
    total = 0.0
    for f in dataclasses.fields(cache):
        leaf = getattr(cache, f.name)
        if leaf is None:
            continue
        nb = _nbytes(leaf)
        if f.name in _STATE:
            total += 2 * nb
        elif "_pages_" in f.name or "_scale_" in f.name:
            live, write = _pool_shares(cache, f.name[-2:], ctx)
            total += nb * (live + (write if "_pages_" in f.name else 0.0))
        else:
            total += nb * (2 if f.name == "lengths" else 1)
    return total


def _causal_pairs(S: int, window: Optional[int]) -> float:
    """(query, key) pairs of causal attention over S positions, each
    query seeing at most `window` keys (itself included)."""
    w = min(window or S, S)
    return w * (w + 1) / 2 + (S - w) * w


def _leaves(tree, specs, path=()):
    """(path, leaf, spec) of a parameter tree and its spec tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], path + (k,))
        else:
            yield path + (k,), v, specs[k]


def _layer_weights(cfg: ModelConfig) -> float:
    """Weights each token multiplies in the decoder's layer stack: every
    leaf of `layers` with a model-width axis (norms, mixing vectors and
    decay constants have none), an MoE expert's at top_k of n_experts;
    the cross-attention, which works on the encoder's output, is left
    out."""
    params, specs = transformer.abstract_params(cfg)
    n = 0.0
    for path, leaf, spec in _leaves(params["layers"], specs["layers"]):
        if "embed" in spec and "cross" not in path:
            n += leaf.numel() * (cfg.top_k / cfg.n_experts
                                 if "expert" in spec else 1)
    return n


def function_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The products the step's function needs, a lower bound: 2 a layer
    weight (`_layer_weights`) a token, 2·V·d a row of logits (every
    position in training, the last one a sequence in prefill, one a slot
    in decode; the input embedding is a lookup), and 4·H·dh a (query,
    key) pair that an attention layer scores within its window; 3x for
    train (the backward's two products for each).  The reference's
    `model_flops_estimate` is the same sum from `active_param_count`,
    with the embedding counted as a product and every layer's attention
    over the whole context."""
    d, V = cfg.d_model, cfg.padded_vocab
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    rows = B * S if shape.kind == "train" else B
    f = (2.0 * _layer_weights(cfg) * (B if decode else B * S)
         + 2.0 * V * d * rows)
    if cfg.n_heads and cfg.family != "ssm":
        for i in range(cfg.n_layers):
            w = transformer.layer_window(cfg, i)
            pairs = (min(S + 1, w or S + 1) if decode
                     else _causal_pairs(S, w))
            f += 4.0 * cfg.n_heads * cfg.d_head * B * pairs
    return 3.0 * f if shape.kind == "train" else f


def _weights_read(params, cfg: ModelConfig, tokens: int) -> float:
    """Bytes of the weights a forward over `tokens` tokens must read:
    all of them, but of an untied input embedding only the rows it looks
    up, and of an MoE's experts only those its tokens can be routed to
    (tokens x top_k at most)."""
    total = _nbytes(params)
    if not cfg.tie_embeddings:
        V = cfg.padded_vocab
        total -= _nbytes(params["embedding"]) * (1 - min(tokens, V) / V)
    moe = params["layers"].get("moe")
    if moe:
        E = cfg.n_experts
        experts = _nbytes([v for k, v in moe.items() if k != "router_w"])
        total -= experts * (1 - min(tokens * cfg.top_k, E) / E)
    return total


def function_cost(cell: Cell, cost) -> Tuple[float, float]:
    """(FLOPs, bytes) that the cell's step function needs on one device,
    from its config, inputs and outputs rather than from the eager
    program that computes it (`cost`, `op_cost`'s count of that
    program, gives the outputs' size only):

    - FLOPs: `function_flops`;
    - train bytes: the arguments read once (the optimizer reads every
      weight and moment), the new state and metrics written once, and
      `saved_bytes`, each layer's input, written once for the backward;
    - prefill bytes: `_weights_read` and the batch read once, the logits
      and the new cache written once;
    - decode bytes: `_weights_read` and the tokens read once, the cache
      as `_decode_cache_bytes` at the cell's context (`shape.seq_len`
      tokens a slot), the logits written once.
    """
    cfg = get_config(cell.arch)
    flops = function_flops(cfg, cell.shape)
    B, S = cell.shape.global_batch, cell.shape.seq_len
    if cell.kind == "train":
        return flops, (_nbytes(cell.abstract_args) + cost.output_bytes
                       + cost.alias_bytes + cell.saved_bytes)
    if cell.kind == "prefill":
        params, batch = cell.abstract_args
        return flops, (_weights_read(params, cfg, B * S) + _nbytes(batch)
                       + cost.output_bytes + cost.alias_bytes)
    params, cache, tokens = cell.abstract_args
    return flops, (_weights_read(params, cfg, B) + _nbytes(tokens)
                   + _decode_cache_bytes(cache, S) + cost.output_bytes)
