"""Family -> implementation registry + uniform model facade
(``repro.models.registry``).  The ``mlp``, ``hybrid`` and ``dense``
families are ported; ``moe``, ``vlm``, ``ssm`` and ``audio`` are
refused."""
from __future__ import annotations

import threading
import time
from typing import Dict

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, mlp
from repro_torch.models import param as P
from repro_torch.models import transformer as tf

_FAMILIES = {"mlp": mlp, "hybrid": hybrid, "dense": tf}


class Model:
    """Thin facade over a flat ``{path: tensor}`` params dict.

    ``mlp``: the family is the ``nn.Module`` ``MLP``, built here on the meta
    device (structure and parameter names only) as ``net`` and run over the
    given dict by :meth:`forward`; the batch is ``{"features"}``.
    ``hybrid`` and ``dense``: plain functions over the dict
    (``models.hybrid``, ``models.transformer``); the batch is
    ``{"tokens"}``, and :meth:`prefill`, :meth:`decode_step`,
    :meth:`init_cache` and :meth:`logits` serve ``serving.engine``."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.mod = _FAMILIES[cfg.family]
        self.specs = self.mod.specs(cfg)
        self.net = mlp.MLP(cfg, device="meta") if cfg.family == "mlp" \
            else None
        # functional_call swaps the module's parameters for the call's:
        # one call at a time (the fit and sweep workers share the model)
        self._net_lock = threading.Lock()
        self.init_seconds = None

    def init(self, seed: int, device="cuda") -> Dict[str, torch.Tensor]:
        """Per-path CPU generators (``param.init_params``), then ``device``;
        the wall time is kept in ``init_seconds``."""
        t0 = time.perf_counter()
        params = P.init_params(self.specs, seed, device)
        self.init_seconds = time.perf_counter() - t0
        return params

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        if self.cfg.family == "mlp":
            with self._net_lock:
                return functional_call(self.net, params,
                                       (batch["features"],),
                                       tie_weights=False)
        return self.mod.forward(self.cfg, params, batch["tokens"])

    def prefill(self, params: Dict, batch: Dict):
        return self.mod.prefill(self.cfg, params, batch["tokens"])

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    cache_len: int):
        return self.mod.decode_step(self.cfg, params, cache, tokens,
                                    cache_len)

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> Dict:
        return self.mod.init_cache(self.cfg, batch, seq_len, device)

    def logits(self, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return tf.logits_fn(self.cfg, params, hidden)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
