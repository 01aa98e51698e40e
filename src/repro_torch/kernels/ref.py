"""Plain PyTorch versions of the hand-written kernels (``repro.kernels.ref``).

Each is the kernel's function written with ordinary tensor ops: the CPU
path of its wrapper, and what ``chip_smoke.py`` holds the kernel against
on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import score_stats_from_logits


def margin_head_ref(hidden: torch.Tensor, w_vocab: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(T, D) x (D, V) -> (margin, entropy, max_logprob, top1)."""
    stats = score_stats_from_logits(hidden.float() @ w_vocab.float())
    return (stats.margin, stats.entropy, stats.max_logprob, stats.top1)


def pairwise_sqdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared euclidean distances, fp32.

    The kernel's expansion (||x||^2 - 2 x.c + ||c||^2, clamped at 0), so
    both round alike and agree exactly on integer-valued inputs."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1)
    c2 = torch.sum(c * c, dim=-1)
    g = x @ c.T
    return torch.clamp(x2[:, None] - 2.0 * g + c2[None, :], min=0.0)
