"""Family -> implementation registry + uniform model facade
(``repro.models.registry``).  Only the ``mlp`` family is ported."""
from __future__ import annotations

from typing import Dict

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mlp
from repro_torch.models import param as P

_FAMILIES = {"mlp": mlp}


class Model:
    """Thin facade: specs/init/forward over a flat ``{path: tensor}`` dict
    and a batch dict (``{"features"}`` for the mlp family).  ``net`` is the
    family's ``nn.Module``, built on the meta device (its structure and
    parameter names only); :meth:`forward` runs it over the given dict."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.mod = _FAMILIES[cfg.family]
        self.specs = self.mod.specs(cfg)
        self.net = self.mod.MLP(cfg, device="meta")

    def init(self, seed: int, device="cuda") -> Dict[str, torch.Tensor]:
        return P.init_params(self.specs, seed, device)

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        return functional_call(self.net, params, (batch["features"],),
                               tie_weights=False)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
