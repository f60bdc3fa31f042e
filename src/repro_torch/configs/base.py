"""Model / shape / engine configuration system.

Every assigned architecture is a :class:`ModelConfig` (exact public-literature
hyperparameters) registered under its ``--arch`` id.  Shapes are the four
assignment-wide :class:`ShapeConfig` cells.  ``reduced()`` derives the smoke-test
config of the same family (small widths / few experts / tiny vocab).

This is the PyTorch port's own copy of `repro.configs.base`: the port
imports nothing from the JAX package, so the dataclasses and the arch
registry are duplicated verbatim and must stay field-for-field equal.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int                  # KV heads (GQA); == n_heads for MHA
    d_ff: int                        # FFN hidden (per-expert for MoE)
    vocab_size: int                  # true vocab (padded internally)

    # Derived / optional
    d_head: int = 0                  # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention flavour
    attn_bias: bool = False          # Qwen-style QKV bias
    window: Optional[int] = None     # sliding-window size (local attention)
    global_every: int = 0            # gemma3: every Nth layer is global
    rope_theta: float = 10_000.0
    # ssm / hybrid
    ssm_state: int = 0
    n_meta_tokens: int = 0           # hymba learnable meta tokens
    # encoder-decoder
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # frontend stubs (vlm/audio): inputs are precomputed embeddings
    frontend_stub: bool = False
    # misc
    gated_mlp: bool = True           # SwiGLU-style (False: 2-matrix GELU MLP)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                 # provenance note

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (sharding + MXU alignment)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def group_size(self) -> int:
        """Q heads per KV head (the paper's head-group width)."""
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling: SSM / hybrid / local-global."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None  # local(:global) attention

    @property
    def has_decode(self) -> bool:
        """All assigned archs autoregress (whisper via its decoder)."""
        return True

    def is_global_layer(self, layer: int) -> bool:
        """gemma3-style local:global pattern; True -> full attention."""
        if self.window is None:
            return True
        if self.global_every <= 0:
            return False
        return (layer + 1) % self.global_every == 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact dense-equivalent parameter count (all experts)."""
        d, dh = self.d_model, self.d_head
        qkv = d * (self.q_dim + 2 * self.kv_dim)
        if self.attn_bias:
            qkv += self.q_dim + 2 * self.kv_dim
        o = self.q_dim * d
        attn = qkv + o
        ffn_one = (3 if self.gated_mlp else 2) * d * self.d_ff
        if self.is_moe:
            ffn = self.n_experts * ffn_one + d * self.n_experts  # + router
        else:
            ffn = ffn_one
        norms = 2 * d
        per_layer = attn + ffn + norms

        if self.family == "ssm":  # rwkv6: replace attn with time-mix
            # r,k,v,g,o projections + decay/bonus params (approx faithful)
            per_layer = 5 * d * d + 2 * d + ffn_one + norms
        if self.family == "hybrid":  # parallel attn + mamba heads share width
            ssm = 2 * d * d + d * (2 * self.ssm_state) + d  # in/out, B/C, dt
            per_layer = attn + ssm + ffn_one + norms

        total = self.n_layers * per_layer
        total += self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * d  # lm head
        total += d  # final norm
        if self.is_encoder_decoder:
            enc_layer = attn + ffn_one + norms
            total += self.encoder_layers * enc_layer
            total += self.n_layers * (qkv + o + d)  # cross-attention + norm
        if self.n_meta_tokens:
            total += self.n_meta_tokens * d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        ffn_all = self.n_experts * 3 * d * self.d_ff
        ffn_act = self.top_k * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * (ffn_all - ffn_act)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        if self.is_attention_free:
            return 0
        return 2 * self.n_layers * self.kv_dim * dtype_bytes

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        if self.family == "ssm":
            # wkv heads must tile d_model exactly (d=128, dh=32 -> 4 heads)
            n_heads = n_kv = 4
        elif self.n_kv_heads:
            n_kv = min(self.n_kv_heads, 2)
            n_heads = n_kv * min(self.group_size, 2)
        else:
            n_kv = n_heads = 0
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=32 if self.n_heads else 0,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 64) if self.window else None,
            global_every=min(self.global_every, 2) if self.global_every else 0,
            ssm_state=min(self.ssm_state, 8),
            n_meta_tokens=min(self.n_meta_tokens, 8),
            encoder_layers=min(self.encoder_layers, 2),
        )


# ---------------------------------------------------------------------------
# Shape configuration (the 4 assignment-wide input-shape cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""


# ---------------------------------------------------------------------------
# Engine (KVNAND) configuration — Track B runtime knobs, DSE-selectable
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineConfig:
    variant: str = "compact"        # "compact" (KVNAND-C) | "discrete" (KVNAND-D)
    hg_pipeline: bool = False       # head-group pipelining (KVNAND-D dataflow)
    page_tokens: int = 64           # tokens per KV page (flash-page analogue)
    quant: str = "none"             # "none" | "w8a8" | "w4a16"
    kv_quant: str = "none"          # "none" | "kv8" | "kv4" paged-KV format
    max_pages_per_seq: int = 0      # 0 -> derived from context length
    kv_dtype: str = "bfloat16"      # KV cache storage dtype (kv_quant=none)
    # shared-pool paged KV (§IV-D FTL mapping): one physical page pool per
    # layer-group, addressed through per-slot page tables, instead of a
    # private per-slot stripe of ceil(max_context / page_tokens) pages
    shared_pool: bool = False
    total_pages: int = 0            # global-pool physical pages (0 -> B·NPg)
    total_pages_w: int = 0          # window-pool physical pages (0 -> B·NPw)
    # tiered flash KV hierarchy (DESIGN.md §13): keep only `hot_pages`
    # of the shared global pool device-resident (the HOT tier); the
    # remaining `total_pages - hot_pages` flash pages form the CAPACITY
    # tier, staged in/out by the scheduler's promote/demote machinery.
    # 0 = single tier (the whole pool is hot).  DSE-selectable via
    # `core.dse.recommend_hot_pages`.
    hot_pages: int = 0
    uniform_lengths: bool = True    # static batching: lockstep appends
    # draft-and-verify speculative decoding: tokens drafted per decode
    # step (prompt lookup) and verified in one pass; 0 = sequential.
    # DSE-selectable (`recommend_engine_config`) like the other knobs;
    # `ServerConfig.speculation_k` overrides per server.
    speculation_k: int = 0
    attn_impl: str = "auto"         # "auto" | "pallas" | "ref" | "interpret"
    # split-page attention: contiguous page-walk partitions merged via
    # the LSE merge core (0 = auto from the page count; must divide the
    # per-device page count when set).  DSE-searchable like kv_quant.
    attn_partitions: int = 0
    gemv_impl: str = "auto"
    # training-side knobs
    remat: str = "block"            # "none" | "block" | "full"
    microbatches: int = 1
    grad_compress: bool = False     # int8 cross-pod gradient compression
    optimizer_dtype: str = "float32"  # "float32" | "bfloat16" moments
    fsdp: bool = False              # shard params over data axis too

    def __post_init__(self):
        if self.kv_quant not in ("none", "kv8", "kv4"):
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}")
        if self.kv_quant == "kv4" and self.page_tokens % 2:
            raise ValueError("kv4 packs token pairs: page_tokens must be "
                             f"even, got {self.page_tokens}")
        if self.speculation_k < 0:
            raise ValueError(f"speculation_k must be >= 0, "
                             f"got {self.speculation_k}")
        if self.attn_partitions < 0:
            raise ValueError(f"attn_partitions must be >= 0 (0 = auto), "
                             f"got {self.attn_partitions}")
        if self.hot_pages < 0:
            raise ValueError(f"hot_pages must be >= 0 (0 = single tier), "
                             f"got {self.hot_pages}")
        if self.hot_pages and not self.shared_pool:
            raise ValueError("hot_pages tiers the SHARED page pool: set "
                             "shared_pool=True (DESIGN.md §13)")
        if self.hot_pages and self.total_pages \
                and self.hot_pages > self.total_pages:
            raise ValueError(f"hot_pages ({self.hot_pages}) cannot exceed "
                             f"total_pages ({self.total_pages})")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


def list_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


ASSIGNED_ARCHS = (
    "dbrx-132b", "kimi-k2-1t-a32b", "pixtral-12b", "qwen1.5-4b",
    "qwen2.5-32b", "gemma3-12b", "qwen1.5-0.5b", "whisper-base",
    "rwkv6-3b", "hymba-1.5b",
)

PAPER_ARCHS = (
    "opt-30b", "llama2-7b", "llama3.1-8b", "llama3.1-70b", "mixtral-8x7b",
)

_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    _loaded = True
    from repro_torch.configs import archs  # noqa: F401  (registers everything)
