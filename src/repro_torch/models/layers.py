"""Shared layers (``repro.models.layers``): norms, the scoring statistics
behind MCAL's M(.)/L(.), and the classification loss.

Tie rule: ``top1`` is ``torch.argmax``, which returns the first maximal
index — the rule ``lax.top_k`` follows.  ``torch.topk`` promises no order
among ties, so it is used for the top-2 VALUES only.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def apply_norm(cfg: ModelConfig, params: Dict, x: torch.Tensor
               ) -> torch.Tensor:
    """``params`` holds the norm's own leaves: ``scale`` (and ``bias``)."""
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def norm_specs(cfg: ModelConfig) -> Dict:
    # rmsnorm multiplies by (1 + scale), so its scale starts at zero
    spec = {"scale": ParamSpec((cfg.d_model,),
                               init="zeros" if cfg.norm == "rmsnorm"
                               else "ones")}
    if cfg.norm == "layernorm":
        spec["bias"] = ParamSpec((cfg.d_model,), init="zeros")
    return spec


# ---------------------------------------------------------------------------
# vocab head: loss + MCAL scoring statistics
# ---------------------------------------------------------------------------


class ScoreStats(NamedTuple):
    """Per-row uncertainty statistics used by MCAL's M(.) / L(.)."""

    margin: torch.Tensor       # top1 - top2 logit gap
    entropy: torch.Tensor      # predictive entropy (nats)
    max_logprob: torch.Tensor  # log p(top1)  (least-confidence = 1 - exp(.))
    top1: torch.Tensor         # argmax index, int32


def map_stats(fn, stats: ScoreStats) -> ScoreStats:
    return ScoreStats(*(fn(a) for a in stats))


def score_stats_from_logits(logits: torch.Tensor) -> ScoreStats:
    """Reference implementation over materialized logits."""
    lf = logits.float()
    top2 = torch.topk(lf, 2, dim=-1).values
    lse = torch.logsumexp(lf, dim=-1)
    p = torch.exp(lf - lse[..., None])
    entropy = lse - torch.sum(p * lf, dim=-1)
    return ScoreStats(
        margin=top2[..., 0] - top2[..., 1],
        entropy=entropy,
        max_logprob=top2[..., 0] - lse,
        top1=torch.argmax(lf, dim=-1).to(torch.int32),
    )


def chunked_score_stats(hidden: torch.Tensor, w_vocab: torch.Tensor,
                        chunk: int = 8192) -> ScoreStats:
    """Online top-2/entropy/lse over vocab chunks without materializing
    (T, V) logits.  hidden: (..., D); w_vocab: (D, V)."""
    D, V = w_vocab.shape
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, D)
    T, dev = h2.shape[0], h2.device
    m = torch.full((T,), NEG_INF, device=dev)
    s = torch.zeros((T,), device=dev)
    u = torch.zeros((T,), device=dev)
    v1 = torch.full((T,), NEG_INF, device=dev)
    v2 = torch.full((T,), NEG_INF, device=dev)
    i1 = torch.zeros((T,), dtype=torch.int32, device=dev)
    for lo in range(0, V, chunk):
        wc = w_vocab[:, lo:lo + chunk]
        x = (h2 @ wc).float()
        if x.shape[1] < chunk:   # pad like the reference: NEG_INF columns
            x = torch.cat([x, torch.full((T, chunk - x.shape[1]), NEG_INF,
                                         device=dev)], dim=1)
        valid = torch.arange(lo, lo + chunk, device=dev) < V
        # online logsumexp + sum(x * e^x) for entropy
        m_new = torch.maximum(m, torch.max(x, dim=-1).values)
        corr = torch.exp(m - m_new)
        e = torch.exp(x - m_new[:, None])
        s = s * corr + torch.sum(e, dim=-1)
        u = u * corr + torch.sum(torch.where(valid[None, :], x, 0.0) * e,
                                 dim=-1)
        m = m_new
        # online top-2: new top2 of {v1, v2, c1, c2} given v1>=v2, c1>=c2
        c12 = torch.topk(x, 2, dim=-1).values
        c1, c2 = c12[:, 0], c12[:, 1]
        cidx = torch.argmax(x, dim=-1).to(torch.int32)
        i1 = torch.where(c1 > v1, cidx + lo, i1)
        v2 = torch.maximum(torch.minimum(v1, c1), torch.maximum(v2, c2))
        v1 = torch.maximum(v1, c1)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    entropy = lse - u / torch.clamp(s, min=1e-30)
    stats = ScoreStats(margin=v1 - v2, entropy=entropy, max_logprob=v1 - lse,
                       top1=i1)
    return map_stats(lambda a: a.reshape(lead), stats)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, fp32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
