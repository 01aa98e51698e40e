"""Small feature-vector classifier (``repro.models.mlp``) — the family
MCAL's live labeling campaigns train.

Parameters keep the JAX names and layouts: ``w_in`` (in, d), ``b_in`` (d,),
``blocks.w`` (L, d, d), ``blocks.b`` (L, d), ``final_norm.scale`` (d,),
``cls_head`` (d, C).  The model is the ``nn.Module`` :class:`MLP`,
registered under those names; the train and scoring engines keep the
parameters as a flat ``{path: tensor}`` dict and run the module over it
(``registry.Model.forward``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, init_params


def specs(cfg: ModelConfig) -> Dict:
    assert cfg.input_dim > 0 and cfg.num_classes > 0
    return {
        "w_in": ParamSpec((cfg.input_dim, cfg.d_model),
                          logical=("embed", "mlp")),
        "b_in": ParamSpec((cfg.d_model,), init="zeros", logical=("mlp",)),
        "blocks": {
            "w": ParamSpec((cfg.num_layers, cfg.d_model, cfg.d_model),
                           logical=("layers", "embed", "mlp")),
            "b": ParamSpec((cfg.num_layers, cfg.d_model), init="zeros",
                           logical=("layers", "mlp")),
        },
        "final_norm": L.norm_specs(cfg),
        "cls_head": ParamSpec((cfg.d_model, cfg.num_classes),
                              logical=("embed", None)),
    }


class MLP(nn.Module):
    """The classifier: ``named_parameters()`` yields the JAX paths
    (``w_in``, ``blocks.w``, ``final_norm.scale``, ...).  ``forward`` maps
    features (B, input_dim) to hidden (B, 1, d_model); ``cls_head`` is
    applied by the loss and the scoring head."""

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(specs(cfg), seed, device)
        for path, value in params.items():
            owner = self
            *parents, name = path.split(".")
            for p in parents:
                if not hasattr(owner, p):
                    owner.add_module(p, nn.Module())
                owner = getattr(owner, p)
            owner.register_parameter(name, nn.Parameter(value))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = torch.relu(features.float() @ self.w_in + self.b_in)
        w, b = self.blocks.w, self.blocks.b
        for i in range(w.shape[0]):
            x = torch.relu(x @ w[i] + b[i]) + x
        norm = {k: getattr(self.final_norm, k)
                for k in L.norm_specs(self.cfg)}
        return L.apply_norm(self.cfg, norm, x[:, None, :])
