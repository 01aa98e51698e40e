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

Over a mesh (a ``sharding.MeshView`` with a policy) the mixer computes
where GSPMD places the reference's: under ``tp`` / ``fsdp_tp`` its inner
width (``mlp``) and heads (``ssm_heads``) are split over "model", so each
rank computes z, x, dt and the conv for its heads' columns, runs the
scan on its head block (B and C, over the unsplit ``state``, whole on
every rank), the gate norm with its sum of squares summed over "model",
and sums the product with ``w_out`` over the axis.  The state cache is
split as the reference's rule splits its logical axes: ``ssm`` over its
heads, ``conv`` over d_inner.

Under ``fsdp_tp_seq`` and ``seq_serve`` the sequence is split over "model"
(``transformer.seq_split``): each rank computes its block of positions
with the mixer whole.  The causal conv takes the ``K - 1`` inputs before
the block from the previous rank (:func:`_halo`, one small all-gather;
rank 0 takes zeros, as the conv's own padding gives them), and the scan
starts from the state the blocks before it leave (:func:`_split_ssd`):
each rank scans its block from zero, one all-gather exchanges every
rank's final state and total log decay, each rank sums the states before
it, decayed, into its incoming state, and ranks past the first scan again
from it (``ops.ssd(h0=)``: the ``ssd_scan`` kernel pair on a card).  No
rank waits for another's scan.  A prefill's states are the last rank's,
handed to every rank as the cache splits them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models import transformer as tf
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


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, C); w: (K, C); ``halo``: the K-1
    inputs before x (B, K-1, C), zeros where None."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0)) if halo is None \
        else torch.cat([halo.to(x.dtype), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return out.to(x.dtype)


def _in_proj(p: Dict, xn: torch.Tensor):
    """z, x, B, C (fp32) and dt (fp32, softplus) from the normed input;
    z, x and dt this rank's columns and heads where the mixer is split."""
    w = {k: shd.local(v) for k, v in p.items() if k != "norm"}
    Bm = (xn @ w["w_B"]).float()
    Cm = (xn @ w["w_C"]).float()
    dt = F.softplus((xn @ w["w_dt"]).float() + w["dt_bias"])
    return xn @ w["w_z"], xn @ w["w_x"], Bm, Cm, dt


def mixer_params(p: Dict, mesh) -> Dict:
    """A layer's mixer params as it computes on them: the mixer is
    tensor-parallel where the policy splits its heads (``w_dt``'s
    ``ssm_heads``) and its inner width (``w_x``'s ``mlp``) over the same
    axes, each rank then holding whole heads; otherwise every block is
    gathered whole."""
    heads, cols = p["w_dt"], p["w_x"]
    if isinstance(heads, shd.Local) and isinstance(cols, shd.Local) \
            and shd._axes(heads.spec[1]) == shd._axes(cols.spec[1]):
        return p
    return shd.whole_tree(p, mesh)


def _gate(p: Dict, y: torch.Tensor, z: torch.Tensor, mesh) -> torch.Tensor:
    """The gated RMS norm over d_inner, ``rmsnorm(y * silu(z))``: over
    this rank's columns where ``gate_norm`` is split, the sum of squares
    summed over its axes."""
    w = p["gate_norm"]
    g = y * F.silu(z.float()).to(y.dtype)
    if not isinstance(w, shd.Local):
        return L.rmsnorm(g, w)
    axes = shd._axes(w.spec[0])
    return L.rmsnorm(g, w.t, reduce=lambda s: tf._tp_sum(s, w, 0, mesh),
                     parts=math.prod(mesh.sizes()[a] for a in axes))


def _out(p: Dict, x: torch.Tensor, y: torch.Tensor, mesh) -> torch.Tensor:
    """x + y @ w_out, summed over w_out's split rows."""
    return x + tf._tp_sum(y @ shd.local(p["w_out"]), p["w_out"], 0, mesh)


def _halo(xs: torch.Tensor, K: int, seq: "tf.SeqSplit") -> torch.Tensor:
    """The K-1 conv inputs before this rank's block of positions (B, K-1,
    C): each rank's last min(K-1, T_loc) inputs gathered along the split's
    axis (its backward reduce-scatters them back), the ranks' before this
    one taken, zeros before the sequence's start."""
    n = min(K - 1, xs.shape[1])
    tails = C.all_gather(xs[:, xs.shape[1] - n:], 1, seq.axis)
    prev = tails[:, :seq.axis.rank * n]
    if prev.shape[1] < K - 1:
        prev = F.pad(prev, (0, 0, K - 1 - prev.shape[1], 0))
    return prev[:, prev.shape[1] - (K - 1):]


class _Tie(torch.autograd.Function):
    """``x`` as it is, with ``others`` in its graph: their gradients are
    zeros, which reach the collectives behind them, so that every rank of
    an axis runs those collectives' backwards, the ranks that read nothing
    from them too."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.like = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.like))


def _split_ssd(xh, dt, A, Bm, Cm, chunk: int, seq: "tf.SeqSplit"):
    """The scan of this rank's block of a sequence split over ``seq.axis``
    -> (y, the final state), as the whole sequence's scan gives them at
    these positions.  Each rank scans its block from zero, which gives its
    final state h_r and (from dt and A) its total log decay g_r; one
    all-gather of both, packed; the incoming state h_in = sum_{j<r}
    exp(sum_{j<k<r} g_k) h_j summed in fp32 under autograd; ranks past the
    first scan their block again from it (``ops.ssd(h0=)``, whose backward
    gives the state's gradient, reduce-scattered back to the ranks that
    made it).  Rank 0's first scan is its result, and over an axis of one
    rank (a forced one: one block at offset 0) the only scan, without an
    exchange."""
    y, h = ops.ssd(xh, dt, A, Bm, Cm, chunk=chunk)
    if seq.axis.size == 1:    # one block: its incoming state is zeros
        return y, h
    decay = -(dt.float() * A.float()).sum(1)                 # (B, H)
    # one collective, which every rank's backward reaches in the same
    # order: (M, B, H, hd N + 1)
    packs = C.all_gather(torch.cat([h.flatten(2), decay[..., None]],
                                   -1)[None], 0, seq.axis)
    r = seq.axis.rank
    if r == 0:
        if torch.is_grad_enabled():
            y = _Tie.apply(y, packs)
        return y, h
    hs = packs[..., :-1].unflatten(-1, h.shape[2:])
    gs = packs[..., -1]
    h_in = hs[0]
    for j in range(1, r):
        h_in = torch.exp(gs[j])[..., None, None] * h_in + hs[j]
    return ops.ssd(xh, dt, A, Bm, Cm, chunk=chunk, h0=h_in)


def mamba_block_with_state(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                           mesh=None, seq: Optional["tf.SeqSplit"] = None
                           ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence mamba2 block: x (B, T, D) -> (out (B, T, D),
    {"ssm": final state (B, H, hd, N) fp32, "conv": last K-1 inputs}).
    Over a ``mesh`` ``p`` is the layer as ``mixer_params`` gives it: on a
    split mixer this rank's heads (``ops.ssd`` on their block, B and C
    whole) and their d_inner columns, the states its heads', the output
    summed over the heads' axes.  Over a sequence split ``seq`` x is this
    rank's block of positions: the conv takes its halo (:func:`_halo`) and
    the scan its incoming state (:func:`_split_ssd`); the states are those
    at the block's end."""
    xn = L.apply_norm(cfg, p["norm"], x)
    z, xs, Bm, Cm, dt = _in_proj(p, xn)
    K = cfg.ssm_conv_kernel
    halo = None if seq is None else _halo(xs, K, seq)
    xc = F.silu(_causal_conv(xs, shd.local(p["conv_w"]), halo).float()).to(
        x.dtype)
    xh = xc.reshape(x.shape[0], x.shape[1], -1, cfg.ssm_head_dim)
    A = torch.exp(shd.local(p["A_log"]))
    if seq is None:
        y, h_fin = ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, h_fin = _split_ssd(xh, dt, A, Bm, Cm, cfg.ssm_chunk, seq)
    y = y + xh * shd.local(p["D_skip"])[None, None, :, None].to(x.dtype)
    y = _gate(p, y.reshape(xc.shape), z, mesh)
    out = _out(p, x, y, mesh)
    # the conv's last K-1 inputs: a block shorter than K-1 takes the rest
    # from its halo
    tail = xs if halo is None else torch.cat(
        [halo.to(xs.dtype), xs[:, -(K - 1):]], 1)
    return out, {"ssm": h_fin.float(), "conv": tail[:, -(K - 1):, :]}


def mamba_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                mesh=None, seq: Optional["tf.SeqSplit"] = None
                ) -> torch.Tensor:
    """Full-sequence mamba2 block: x (B, T, D) -> (B, T, D); over a
    sequence split, this rank's block of positions."""
    return mamba_block_with_state(cfg, p, x, mesh, seq)[0]


def last_states(st: Dict, seq: Optional["tf.SeqSplit"]) -> Dict:
    """A split prefill's states (no grad): the sequence's, which its last
    rank computed, on every rank of the split's axis."""
    if seq is None:
        return st
    return {k: C.broadcast(v, seq.axis, seq.axis.size - 1)
            for k, v in st.items()}


def mamba_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       state: Dict, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token mamba2 block.  x: (B, 1, D);
    state = {"ssm": (B, H, hd, N), "conv": (B, K-1, di)}, this rank's
    heads and columns of them on a split mixer (``mixer_params``)."""
    xn = L.apply_norm(cfg, p["norm"], x)[:, 0]               # (B, D)
    z, xs, Bm, Cm, dt = _in_proj(p, xn)
    # conv over the K-1 cached inputs + the new one
    hist = torch.cat([state["conv"], xs[:, None, :]], dim=1)  # (B, K, di)
    xc = torch.einsum("bkc,kc->bc", hist.float(),
                      shd.local(p["conv_w"]).float())
    xc = F.silu(xc).to(x.dtype)
    xh = xc.reshape(xc.shape[0], -1, cfg.ssm_head_dim)
    A = torch.exp(shd.local(p["A_log"]))
    y, h_new = ssd_decode(xh, dt, A, Bm, Cm, state["ssm"])
    y = y + xh * shd.local(p["D_skip"])[None, :, None].to(x.dtype)
    y = _gate(p, y.reshape(xc.shape), z, mesh)
    out = _out(p, x, y[:, None, :], mesh)
    return out, {"ssm": h_new, "conv": hist[:, 1:, :]}


# the reference's logical axes of the state cache's leaves, a layer's
# (its ``cache_specs`` behind the stacked dims)
STATE_LOGICAL = {"ssm": ("cache_batch", "ssm_heads", None, "state"),
                 "conv": ("cache_batch", "conv", "mlp")}


def state_layouts(cfg: ModelConfig, p: Dict, batch: int, mesh):
    """(computed, cached): the specs of a layer's states (``ssm`` (B, H,
    hd, N), ``conv`` (B, K-1, di)) as the mixer ``p`` computes them (over
    its heads' axes, ``mixer_params``) and as the cache stores them (the
    reference's rule, ``sharding.cache_pspec``), the rows' dim left out
    (each rank's rows either way); None without a mesh.  Every layer has
    the same: a caller takes them once, from its first layer."""
    if mesh is None:
        return None
    w = p["w_dt"]
    a = shd._axes(w.spec[1]) or None if isinstance(w, shd.Local) else None
    have = {"ssm": (None, a, None, None), "conv": (None, None, a)}
    shapes = state_shapes(cfg, batch)
    want = {k: (None,) + tuple(shd.cache_pspec(mesh, shapes[k],
                                               STATE_LOGICAL[k]))[1:]
            for k in shapes}
    return have, want


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """A layer's whole state shapes for ``batch`` rows."""
    return {"ssm": (batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                    cfg.ssm_state),
            "conv": (batch, cfg.ssm_conv_kernel - 1, cfg.ssm_d_inner)}


def to_cache(st: Dict, layouts, mesh) -> Dict:
    """A layer's states as computed, laid out as the cache holds them
    (``layouts``: :func:`state_layouts`; no collective where the two
    splits agree)."""
    if layouts is None:
        return st
    have, want = layouts
    return {k: shd.relayout(st[k], have[k], want[k], mesh) for k in st}


def from_cache(st: Dict, layouts, mesh) -> Dict:
    """A layer's cached states laid out as its mixer computes on them."""
    if layouts is None:
        return st
    have, want = layouts
    return {k: shd.relayout(st[k], want[k], have[k], mesh) for k in st}


# the mixer's leaves take the rule (``shd.layer``'s ``keep``)
_MIXER_KEEP = {k: () for k in ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_w",
                               "A_log", "dt_bias", "D_skip", "gate_norm",
                               "w_out")}


def mamba_layer(tree: Dict, i: int, mesh) -> Dict:
    """Layer ``i`` of stacked mixer params as it computes on them: over a
    mesh its tensor-parallel blocks kept (``shd.layer``'s rule), then
    ``mixer_params``."""
    if mesh is None:
        return tf._layer(tree, i)
    return mixer_params(tf._layer(tree, i, mesh, _MIXER_KEEP), mesh)



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
                  patch_embeds: Optional[torch.Tensor], with_state: bool,
                  mesh=None, whole: bool = True):
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens, patch_embeds, mesh)
    seq = tf.seq_split(cfg, mesh, x.shape[1])
    x = tf.seq_block(x, seq)
    if not with_state:
        for i in range(cfg.num_layers):
            # the layer's weights gathered inside the recomputed body
            x = L.remat(cfg, lambda h, i=i: mamba_block(
                cfg, mamba_layer(tree["blocks"], i, mesh), h, mesh, seq), x)
        hidden = L.apply_norm(cfg, shd.whole_tree(tree["final_norm"], mesh),
                              x)
        return tf.seq_whole(hidden, seq, whole), None
    states, lay = [], None
    for i in range(cfg.num_layers):
        p = mamba_layer(tree["blocks"], i, mesh)
        lay = lay or state_layouts(cfg, p, x.shape[0], mesh)
        x, st = mamba_block_with_state(cfg, p, x, mesh, seq)
        states.append(to_cache(last_states(st, seq), lay, mesh))
    hidden = L.apply_norm(cfg, shd.whole_tree(tree["final_norm"], mesh), x)
    return tf.seq_whole(hidden, seq, whole), {
        k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None,
            mesh=None, whole: bool = True) -> torch.Tensor:
    """tokens (B, T) -> final hidden states (B, T, D); differentiable
    (on a CUDA device through the ``ssd_scan_bwd`` kernel).  With a
    ``mesh`` the batch is this rank's rows, each mixer computes on the
    rank's heads where the policy splits them (``mixer_params``) and
    storage dims are gathered at their use; under ``fsdp_tp_seq`` or
    ``seq_serve`` each rank computes its block of positions
    (``transformer.seq_split``), the hidden states gathered after the
    final norm, or left as this rank's with ``whole=False`` (the loss's)."""
    return _forward_impl(cfg, params, tokens, patch_embeds, False, mesh,
                         whole)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None, mesh=None,
            max_seq: Optional[int] = None):
    """Forward that also returns each layer's final states, the reference's
    prefill arithmetic: {"ssm" (L, B, H, hd, N) fp32, "conv" (L, B, K-1,
    d_inner), the last K-1 inputs of the conv}; over a ``mesh`` this
    rank's block of them (:func:`cache_specs`).  ``max_seq`` is not read:
    the states' size does not depend on it."""
    return _forward_impl(cfg, params, tokens, patch_embeds, True, mesh)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                mesh=None) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)} of the state cache (its size does not depend
    on ``seq_len``); over a ``mesh`` this rank's block, as the reference's
    rule splits ``("layers", "cache_batch", "ssm_heads", None, "state")``
    and ``("layers", "cache_batch", "conv", "mlp")``: the heads and the
    conv's d_inner over "model" where they divide it (``batch``: the
    rank's rows)."""
    dtypes = {"ssm": torch.float32, "conv": cfg.torch_dtype}
    out = {}
    for k, shape in state_shapes(cfg, batch).items():
        if isinstance(mesh, shd.MeshView):
            spec = shd.cache_pspec(mesh, shape, STATE_LOGICAL[k])
            shape = tuple(s.stop - s.start for s in shd.slices(
                shape, (None,) + tuple(spec)[1:], mesh))
        out[k] = ((cfg.num_layers,) + tuple(shape), dtypes[k])
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda", mesh=None) -> Dict:
    """A zero cache; over a ``mesh`` this rank's block of it
    (:func:`cache_specs`)."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype)
            in cache_specs(cfg, batch, seq_len, mesh).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int, mesh=None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V), the state cache advanced by this
    token, in place).  ``cache_len`` and ``max_seq`` are not read: the
    states carry the position.  With a ``mesh`` the tokens and the states are this rank's
    rows, and the states its block (:func:`cache_specs`)."""
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens, mesh=mesh)
    lay = None
    for i in range(cfg.num_layers):
        p = mamba_layer(tree["blocks"], i, mesh)
        lay = lay or state_layouts(cfg, p, x.shape[0], mesh)
        state = from_cache({k: cache[k][i] for k in ("ssm", "conv")}, lay,
                           mesh)
        x, new = mamba_block_decode(cfg, p, x, state, mesh)
        new = to_cache(new, lay, mesh)
        for k in ("ssm", "conv"):
            cache[k][i] = new[k]
    hidden = L.apply_norm(cfg, shd.whole_tree(tree["final_norm"], mesh), x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :], mesh), cache
