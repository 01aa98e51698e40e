"""Mamba2 (SSD — state-space duality) blocks and the pure-SSM ``ssm``
family, mamba2-1.3b (``repro.models.mamba2``).

``ssd_chunked`` is the chunked SSD algorithm in plain torch: the oracle of
the ``ssd_scan`` kernel and its CPU path.  The blocks call
``kernels.ops.ssd``, which runs the kernel on a CUDA tensor, so every
``ssm`` forward, prefill and pool pass launches it once a layer.  As in the
reference, the short causal conv is applied to the x stream only and
n_groups == 1.  The stacked layers run as a Python loop, each recomputed in
the backward under ``cfg.remat``.  ``forward`` is differentiable: on the
CPU through the plain scan, on a CUDA device through the ``ssd_scan_bwd``
kernel (``ops.ssd``'s autograd function).  ``decode_step`` writes the new
states into the cache it is given, in place, and returns it (the
reference's engine donates the cache to the step).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.param import ParamSpec


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, T, H, hd)   inputs per head
    dt: (B, T, H)       positive step sizes
    A:  (H,)            positive decay rates (a_t = exp(-dt * A))
    Bm: (B, T, N)       input projections (shared across heads)
    Cm: (B, T, N)       output projections
    h0: (B, H, hd, N)   optional initial state
    Returns (y (B, T, H, hd) in xh's dtype, h_final (B, H, hd, N) fp32).
    """
    Bsz, T, H, hd = xh.shape
    N = Bm.shape[-1]
    chunk = min(chunk, T)
    T0 = T
    pad = (-T) % chunk
    if pad:  # exact: dt = 0 padding gives unit decay and no state update
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        T = T + pad
    nc = T // chunk

    la = (-(dt * A)).reshape(Bsz, nc, chunk, H)              # log a_t
    cum = torch.cumsum(la, dim=2)                            # l_t (inclusive)
    xd = (xh * dt[..., None]).reshape(Bsz, nc, chunk, H, hd)
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    # intra-chunk: Y[t] = sum_{s<=t} (C_t.B_s) exp(l_t - l_s) x_s, the
    # upper triangle masked before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,t,s,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    Lmat = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                 -torch.inf))
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    W = scores[..., None] * Lmat                             # (B,nc,t,s,H)
    y_intra = torch.einsum("bctsh,bcshd->bcthd", W.to(xd.dtype).float(),
                           xd.float())

    # chunk summaries: S_c = sum_s exp(l_last - l_s) x_s (x) B_s
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B,nc,chunk,H)
    S = torch.einsum("bcsh,bcshd,bcsn->bchdn",
                     decay_end.to(xd.dtype).float(), xd.float(),
                     Bc.to(xd.dtype).float())
    gamma = torch.exp(cum[:, :, -1, :])                      # (B,nc,H)

    # inter-chunk recurrence over the nc chunks; h_prev[c] = H_{c-1}
    h = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = gamma[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,H,hd,N)

    y_inter = torch.einsum("bctn,bchdn->bcthd", Cc, h_prev)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, hd)
    if pad:
        y = y[:, :T0]
    return y.to(xh.dtype), h


def ssd_decode(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update.  xh: (B, H, hd); dt: (B, H); Bm/Cm: (B, N);
    h: (B, H, hd, N)."""
    a = torch.exp(-(dt * A)).float()                         # (B, H)
    upd = torch.einsum("bhd,bn->bhdn", (xh * dt[..., None]).float(),
                       Bm.float())
    h_new = a[..., None, None] * h.float() + upd
    y = torch.einsum("bhdn,bn->bhd", h_new, Cm.float())
    return y.to(xh.dtype), h_new


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, nl: int) -> Dict:
    D, di = cfg.d_model, cfg.ssm_d_inner
    H, N, K = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_conv_kernel
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        "norm": L.norm_specs(cfg, stacked=nl),
        "w_z": ParamSpec((nl, D, di), dtype=bf16,
                         logical=("layers", "embed", "mlp")),
        "w_x": ParamSpec((nl, D, di), dtype=bf16,
                         logical=("layers", "embed", "mlp")),
        "w_B": ParamSpec((nl, D, N), dtype=bf16,
                         logical=("layers", "embed", "state")),
        "w_C": ParamSpec((nl, D, N), dtype=bf16,
                         logical=("layers", "embed", "state")),
        "w_dt": ParamSpec((nl, D, H), dtype=bf16,
                          logical=("layers", "embed", "ssm_heads")),
        "conv_w": ParamSpec((nl, K, di), dtype=bf16, scale=0.5,
                            logical=("layers", "conv", "mlp")),
        "A_log": ParamSpec((nl, H), init="zeros", dtype=f32,
                           logical=("layers", "ssm_heads")),
        "dt_bias": ParamSpec((nl, H), init="zeros", dtype=f32,
                             logical=("layers", "ssm_heads")),
        "D_skip": ParamSpec((nl, H), init="ones", dtype=f32,
                            logical=("layers", "ssm_heads")),
        "gate_norm": ParamSpec((nl, di), init="zeros", dtype=f32,
                               logical=("layers", "mlp")),
        "w_out": ParamSpec((nl, di, D), dtype=bf16,
                           logical=("layers", "mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, C); w: (K, C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return out.to(x.dtype)


def _split_heads(cfg: ModelConfig, xc: torch.Tensor) -> torch.Tensor:
    B, T, _ = xc.shape
    return xc.reshape(B, T, cfg.ssm_num_heads, cfg.ssm_head_dim)


def _in_proj(p: Dict, xn: torch.Tensor):
    """z, x, B, C (fp32) and dt (fp32, softplus) from the normed input."""
    Bm = (xn @ p["w_B"]).float()
    Cm = (xn @ p["w_C"]).float()
    dt = F.softplus((xn @ p["w_dt"]).float() + p["dt_bias"])
    return xn @ p["w_z"], xn @ p["w_x"], Bm, Cm, dt


def mamba_block_with_state(cfg: ModelConfig, p: Dict, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence mamba2 block: x (B, T, D) -> (out (B, T, D),
    {"ssm": final state (B, H, hd, N) fp32, "conv": last K-1 inputs})."""
    xn = L.apply_norm(cfg, p["norm"], x)
    z, xs, Bm, Cm, dt = _in_proj(p, xn)
    xc = F.silu(_causal_conv(xs, p["conv_w"]).float()).to(x.dtype)
    xh = _split_heads(cfg, xc)
    A = torch.exp(p["A_log"])
    y, h_fin = ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + xh * p["D_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(x.shape[0], x.shape[1], cfg.ssm_d_inner)
    y = L.rmsnorm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"])
    out = x + y @ p["w_out"]
    K = cfg.ssm_conv_kernel
    return out, {"ssm": h_fin.float(), "conv": xs[:, -(K - 1):, :]}


def mamba_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block: x (B, T, D) -> (B, T, D)."""
    return mamba_block_with_state(cfg, p, x)[0]


def mamba_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token mamba2 block.  x: (B, 1, D);
    state = {"ssm": (B, H, hd, N), "conv": (B, K-1, di)}."""
    xn = L.apply_norm(cfg, p["norm"], x)[:, 0]               # (B, D)
    z, xs, Bm, Cm, dt = _in_proj(p, xn)
    # conv over the K-1 cached inputs + the new one
    hist = torch.cat([state["conv"], xs[:, None, :]], dim=1)  # (B, K, di)
    xc = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
    xc = F.silu(xc).to(x.dtype)
    xh = xc.reshape(-1, cfg.ssm_num_heads, cfg.ssm_head_dim)
    A = torch.exp(p["A_log"])
    y, h_new = ssd_decode(xh, dt, A, Bm, Cm, state["ssm"])
    y = y + xh * p["D_skip"][None, :, None].to(x.dtype)
    y = y.reshape(x.shape[0], cfg.ssm_d_inner)
    y = L.rmsnorm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"])
    out = x + (y @ p["w_out"])[:, None, :]
    return out, {"ssm": h_new, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# full model (pure SSM: mamba2-1.3b)
# ---------------------------------------------------------------------------


def specs(cfg: ModelConfig) -> Dict:
    """The ``ssm`` family's parameter specs: the Mamba2 blocks stacked on a
    leading ``num_layers`` axis, an untied ``lm_head`` unless the embedding
    is tied."""
    bf16 = torch.bfloat16
    sp = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), scale=1.0,
                           dtype=bf16, logical=("vocab", "embed")),
        "blocks": block_specs(cfg, cfg.num_layers),
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=bf16,
                                  logical=("embed", "vocab"))
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=bf16, logical=("embed", None))
    return sp


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor], with_state: bool):
    from repro_torch.models import transformer as tf
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens, patch_embeds)
    if not with_state:
        for i in range(cfg.num_layers):
            x = L.remat(cfg, lambda h, p=tf._layer(tree["blocks"], i):
                        mamba_block(cfg, p, h), x)
        return L.apply_norm(cfg, tree["final_norm"], x), None
    states = []
    for i in range(cfg.num_layers):
        x, st = mamba_block_with_state(cfg, tf._layer(tree["blocks"], i), x)
        states.append(st)
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return hidden, {k: torch.stack([st[k] for st in states])
                    for k in ("ssm", "conv")}


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) -> final hidden states (B, T, D); differentiable
    (on a CUDA device through the ``ssd_scan_bwd`` kernel)."""
    return _forward_impl(cfg, params, tokens, patch_embeds, False)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None):
    """Forward that also returns each layer's final states, the reference's
    prefill arithmetic: {"ssm" (L, B, H, hd, N) fp32, "conv" (L, B, K-1,
    d_inner), the last K-1 inputs of the conv}."""
    return _forward_impl(cfg, params, tokens, patch_embeds, True)


def cache_specs(cfg: ModelConfig, batch: int,
                seq_len: int) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)} of the state cache (its size does not depend
    on ``seq_len``)."""
    H, hd, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    K, di, nl = cfg.ssm_conv_kernel, cfg.ssm_d_inner, cfg.num_layers
    return {"ssm": ((nl, batch, H, hd, N), torch.float32),
            "conv": ((nl, batch, K - 1, di), cfg.torch_dtype)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> Dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in cache_specs(cfg, batch, seq_len).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V), the state cache advanced by this
    token, in place).  ``cache_len`` is not read: the states carry the
    position."""
    from repro_torch.models import transformer as tf
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens)
    for i in range(cfg.num_layers):
        state = {k: cache[k][i] for k in ("ssm", "conv")}
        x, new = mamba_block_decode(cfg, tf._layer(tree["blocks"], i), x,
                                    state)
        for k in ("ssm", "conv"):
            cache[k][i] = new[k]
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :]), cache
