"""Model facade (port of `repro.models.registry`): `Model`, and
`input_specs()` — meta-tensor stand-ins for every input of every (arch ×
shape) cell (the dry-run contract; nothing is allocated)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.models import transformer
from repro_torch.models.transformer import Runtime


class Model:
    """Thin, stateless facade over the functional model stack."""

    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None):
        self.cfg = cfg
        self.rt = rt or Runtime()

    def init(self, generator: torch.Generator):
        """Fresh float32 parameters drawn from `generator`, on its
        device."""
        return transformer.init_model(self.cfg, generator, generator.device)

    def init_with_specs(self, generator: torch.Generator,
                        dtype: torch.dtype = torch.float32):
        """(params, logical-axis specs), the params drawn from
        `generator` on its device and cast to `dtype`."""
        return transformer.init_model_with_specs(
            self.cfg, generator, generator.device, dtype)

    def abstract_params(self, dtype: torch.dtype = torch.float32):
        """(meta params, specs): shapes and dtypes only."""
        return transformer.abstract_params(self.cfg, dtype)

    def forward(self, params, batch):
        """The plain, kernel-free forward -> logits."""
        return transformer.forward(params, self.cfg, batch, self.rt)

    def loss(self, params, batch, remat: str = "none"):
        """The training loss (kernels under autograd on a card) -> (loss,
        {"ce", "aux"})."""
        return transformer.loss_fn(params, self.cfg, batch, self.rt,
                                   remat=remat)


def build_model(arch: str, rt: Optional[Runtime] = None) -> Model:
    return Model(get_config(arch), rt)


# ---------------------------------------------------------------------------
# input_specs — dry-run stand-ins (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rt: Optional[Runtime] = None,
                activ_dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for one (arch × shape) cell.

    train:   {tokens, labels}        [B, S] int32 (+ modality stubs)
    prefill: {tokens}                [B, S] int32 (+ modality stubs)
    decode:  {tokens, positions}     [B, 1], [B] int32 (the cache is
                                     built separately)
    """
    rt = rt or Runtime()
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        s_tok = S
        if cfg.family == "vlm":
            s_tok = S - rt.vlm_patches
            specs["patches"] = _meta((B, rt.vlm_patches, cfg.d_model),
                                     activ_dtype)
        if cfg.n_meta_tokens:
            s_tok = S - cfg.n_meta_tokens
        if cfg.is_encoder_decoder:
            specs["frames"] = _meta((B, S // rt.enc_frames_ratio,
                                     cfg.d_model), activ_dtype)
        specs["tokens"] = _meta((B, s_tok), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, s_tok), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = _meta((B, 1), torch.int32)
        specs["positions"] = _meta((B,), torch.int32)
    return specs


def batch_sharding_axes(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, Tuple]:
    """Logical axes for each input (mapped to the mesh by sharding
    rules)."""
    axes: Dict[str, Tuple] = {}
    if shape.kind in ("train", "prefill"):
        axes["tokens"] = ("batch", None)
        if shape.kind == "train":
            axes["labels"] = ("batch", None)
        if cfg.family == "vlm":
            axes["patches"] = ("batch", None, None)
        if cfg.is_encoder_decoder:
            axes["frames"] = ("batch", None, None)
    else:
        axes["tokens"] = ("batch", None)
        axes["positions"] = ("batch",)
    return axes


def make_concrete_batch(cfg: ModelConfig, shape_or_specs,
                        generator: Optional[torch.Generator] = None,
                        rt: Optional[Runtime] = None,
                        device=None) -> Dict[str, torch.Tensor]:
    """Materialize a random batch matching `input_specs` (tests,
    examples, the card's run of a dry-run cell): integer leaves uniform
    in [0, vocab_size), float leaves standard normal, each drawn in turn
    from `generator` (seed 0 on the CPU by default) on `device` (default
    the generator's)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = generator.device if device is None else torch.device(device)
    specs = (shape_or_specs if isinstance(shape_or_specs, dict)
             else input_specs(cfg, shape_or_specs, rt))
    out = {}
    for name, spec in specs.items():
        if spec.dtype.is_floating_point:
            x = torch.randn(spec.shape, generator=generator,
                            device=generator.device)
        else:
            x = torch.randint(0, cfg.vocab_size, spec.shape,
                              generator=generator, device=generator.device)
        out[name] = x.to(device=device, dtype=spec.dtype)
    return out
