"""Family -> implementation registry + uniform model facade
(``repro.models.registry``).  Every family of the reference is ported:
``mlp``, ``hybrid``, ``dense``, ``ssm``, ``moe``, ``vlm`` and ``audio``.

``forward``, ``prefill`` and ``decode_step`` take the reference's
``mesh=``: a ``distributed.sharding.MeshView`` (a bare ``DeviceMesh`` is
viewed with the batch whole on every rank).  Over a mesh, params may be
stored sharded (``DTensor`` leaves: a layer computes on the blocks of its
tensor-parallel dims and gathers the rest at their use) and the batch is
this rank's rows of the view's split; a mesh of one rank computes what no
mesh does."""
from __future__ import annotations

import math
import threading
import time
from typing import Dict

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshView, whole_tree
from repro_torch.models import encdec, hybrid, mamba2, mlp
from repro_torch.models import param as P
from repro_torch.models import transformer as tf

_FAMILIES = {"mlp": mlp, "hybrid": hybrid, "dense": tf, "ssm": mamba2,
             "moe": tf, "vlm": tf, "audio": encdec}


class Model:
    """Thin facade over a flat ``{path: tensor}`` params dict.

    ``mlp``: the family is the ``nn.Module`` ``MLP``, built here on the meta
    device (structure and parameter names only) as ``net`` and run over the
    given dict by :meth:`forward`; the batch is ``{"features"}``.
    The token families: plain functions over the dict (``hybrid``:
    ``models.hybrid``; ``ssm``: ``models.mamba2``; ``dense``, ``moe`` and
    ``vlm``: ``models.transformer``; ``audio``: ``models.encdec``); the
    batch is ``{"tokens"}``, with ``"patch_embeds"`` (B, P, D) for a VLM
    and ``"audio_frames"`` (B, encoder_tokens, D) for audio, and
    :meth:`prefill`, :meth:`decode_step`, :meth:`init_cache` and
    :meth:`logits` serve ``serving.engine``."""

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

    def param_count(self) -> int:
        return sum(math.prod(spec.shape)
                   for _, spec in P.iter_specs(self.specs))

    def _frontend(self, batch: Dict):
        """The batch's frontend input (a VLM's ``patch_embeds``, the audio
        family's ``audio_frames``) or None."""
        return batch.get("patch_embeds", batch.get("audio_frames"))

    def forward(self, params: Dict, batch: Dict, mesh=None,
                whole: bool = True) -> torch.Tensor:
        """The final hidden states; ``whole=False`` leaves them as this
        rank's positions where the mesh splits the sequence
        (``transformer.seq_split``: every token family, an audio model's
        decoder positions)."""
        mesh = _view(mesh)
        kw = {} if whole else {"whole": False}
        if self.cfg.family == "mlp":
            if mesh is not None:
                params = whole_tree(params, mesh)
            with self._net_lock:
                return functional_call(self.net, params,
                                       (batch["features"],),
                                       tie_weights=False)
        fe = self._frontend(batch)
        if fe is None:
            return self.mod.forward(self.cfg, params, batch["tokens"],
                                    mesh=mesh, **kw)
        return self.mod.forward(self.cfg, params, batch["tokens"], fe,
                                mesh=mesh, **kw)

    def prefill(self, params: Dict, batch: Dict, mesh=None,
                max_seq=None):
        """The forward and its caches; ``max_seq``: the length of the
        cache they fill, whose positions a mesh may split
        (``transformer.cache_split``; the attention caches of every family
        that has them)."""
        mesh = _view(mesh)
        fe = self._frontend(batch)
        if fe is None:
            return self.mod.prefill(self.cfg, params, batch["tokens"],
                                    mesh=mesh, max_seq=max_seq)
        return self.mod.prefill(self.cfg, params, batch["tokens"], fe,
                                mesh=mesh, max_seq=max_seq)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    cache_len: int, mesh=None, max_seq=None):
        """One decode step; ``max_seq``: the length of the cache, whose
        block a mesh may hold (read from the block where not given)."""
        return self.mod.decode_step(self.cfg, params, cache, tokens,
                                    cache_len, mesh=_view(mesh),
                                    max_seq=max_seq)

    def init_cache(self, batch: int, seq_len: int, device="cuda",
                   mesh=None) -> Dict:
        """A zero cache for ``batch`` rows of ``seq_len`` positions; over
        a ``mesh`` this rank's block of the positions where it splits
        them."""
        return self.mod.init_cache(self.cfg, batch, seq_len, device,
                                   mesh=_view(mesh))

    def logits(self, params: Dict, hidden: torch.Tensor,
               mesh=None) -> torch.Tensor:
        return tf.logits_fn(self.cfg, params, hidden, _view(mesh))


def _view(mesh):
    """None, or ``mesh`` as a :class:`MeshView` (the batch whole on every
    rank where a bare ``DeviceMesh`` is given)."""
    if mesh is None or isinstance(mesh, MeshView):
        return mesh
    return MeshView(mesh)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
