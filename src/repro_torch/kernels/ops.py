"""Public kernel entry points, dispatched by the tensor's device
(``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel or raises.  There is no switch and no fallback: this
is the port's counterpart of ``use_pallas()`` "auto" on a TPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import margin_head as _mh
from repro_torch.kernels import pairwise_dist as _pd
from repro_torch.kernels import ref as _ref
from repro_torch.models.layers import ScoreStats


def score_head(hidden: torch.Tensor, w_vocab: torch.Tensor) -> ScoreStats:
    """Pool-scoring statistics for MCAL's M(.)/L(.).  hidden: (..., D)."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.device.type == "cpu":
        outs = _ref.margin_head_ref(h2, w_vocab)
    else:
        outs = _mh.margin_head(h2.contiguous(), w_vocab.contiguous())
    return ScoreStats(*(o.reshape(lead) for o in outs))


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared distances for k-center M(.)."""
    if x.device.type == "cpu":
        return _ref.pairwise_sqdist_ref(x, c)
    return _pd.pairwise_sqdist(x.contiguous(), c.contiguous())
