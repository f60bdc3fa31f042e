"""Model facade (port of `repro.models.registry.Model`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import Runtime


class Model:
    """Thin, stateless facade over the functional dense decoder."""

    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.rt = rt or Runtime()

    def init(self, generator: torch.Generator):
        """Fresh float32 parameters drawn from `generator`, on its
        device."""
        return transformer.init_model(self.cfg, generator, generator.device)

    def forward(self, params, batch):
        return transformer.forward(params, self.cfg, batch, self.rt)
