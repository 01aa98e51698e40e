"""Whisper-style encoder-decoder, the ``audio`` family
(``repro.models.encdec``): whisper-tiny.  The conv frontend is a stub: the
batch carries precomputed frame embeddings ``audio_frames`` (B,
encoder_tokens, D).

LayerNorm + GELU + learned positions, as the Whisper architecture.  The
encoder runs non-causal self-attention over the frames; each decoder layer
runs causal self-attention, cross-attention to the encoder output, and the
MLP.  Plain functions over the port's flat ``{path: tensor}`` params
(nested on entry, as the reference indexes them), the stacked layers as a
Python loop.  The encoder's self-attention, the decoder's and the
cross-attention (Tq the prompt, Tk the frames) go through
``kernels.ops.attention``, so on a CUDA device each is one
``flash_attention`` launch a layer (at whisper-tiny's hd 64; with grad the
backward kernel once each too); the decode step's attention over the caches
stays on ``layers.decode_attention``, as in the reference.

``forward`` is differentiable; under ``cfg.remat`` each decoder layer is
recomputed in the backward, as the reference checkpoints its decoder scan
body (its encoder scan is not checkpointed).  ``prefill`` returns the
self-attention cache ``k``/``v`` and the cross-attention cache ``xk``/``xv``
(each layer's projections of the encoder output); ``decode_step`` writes
the new token's keys and values into the cache it is given, in place, and
returns it (the reference's engine donates the cache to the step).

Over a mesh (a ``sharding.MeshView`` with a policy) every layer takes the
dense blocks' rule: the self- and cross-attention on this rank's heads
(the kv heads its query heads read where kv stays whole), the MLP on its
columns, the products after ``wo`` and ``w_down`` summed over "model";
the embedding and the head are vocabulary-parallel; ``enc_pos`` and
``dec_pos`` are gathered.  The cache follows the reference's logical
axes: ``k`` / ``v`` along the sequence (flash-decode), or over the kv
heads where it does not divide; ``xk`` / ``xv`` over the kv heads.

Under ``fsdp_tp_seq`` and ``seq_serve`` the sequences are split over
"model" (``transformer.seq_split``): the encoder's frames where "model"
divides them (each rank its block and its rows of the gathered
``enc_pos``, self-attention over the keys and values gathered along the
axis, the output gathered whole after
``enc_final_norm`` for the cross-attention and its cache), and the
decoder's tokens (``dec_pos`` offset to the rank's positions, causal
self-attention at ``q_offset`` over the gathered keys and values, the
cross-attention from the rank's queries over the whole encoder output).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import whole, whole_tree
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models import transformer as tf
from repro_torch.models.param import ParamSpec

FAMILIES = ("audio",)


def _xattn_specs(cfg: ModelConfig, nl: int) -> Dict:
    hd = cfg.resolved_head_dim
    bf16 = torch.bfloat16
    return {
        "norm": L.norm_specs(cfg, stacked=nl),
        "wq": ParamSpec((nl, cfg.d_model, cfg.num_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "heads", None)),
        "wk": ParamSpec((nl, cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "kv", None)),
        "wv": ParamSpec((nl, cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "kv", None)),
        "wo": ParamSpec((nl, cfg.num_heads, hd, cfg.d_model), dtype=bf16,
                        logical=("layers", "heads", None, "embed")),
    }


def specs(cfg: ModelConfig) -> Dict:
    """The encoder's and decoder's layers stacked on leading
    ``encoder_layers`` / ``num_layers`` axes, learned positions for both,
    an untied ``lm_head`` unless the embedding is tied."""
    ne, nd = cfg.encoder_layers, cfg.num_layers
    bf16 = torch.bfloat16
    sp = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), scale=1.0,
                           dtype=bf16, logical=("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.encoder_tokens, cfg.d_model), scale=0.02,
                             dtype=bf16, logical=("seq", "embed")),
        "dec_pos": ParamSpec((cfg.max_seq_len, cfg.d_model), scale=0.02,
                             dtype=bf16, logical=("seq", "embed")),
        "encoder": {
            "attn": tf.attention_specs(cfg, ne),
            "mlp_norm": L.norm_specs(cfg, stacked=ne),
            "mlp": L.mlp_specs(cfg, stacked=ne),
        },
        "decoder": {
            "attn": tf.attention_specs(cfg, nd),
            "xattn": _xattn_specs(cfg, nd),
            "mlp_norm": L.norm_specs(cfg, stacked=nd),
            "mlp": L.mlp_specs(cfg, stacked=nd),
        },
        "enc_final_norm": L.norm_specs(cfg),
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=bf16,
                                  logical=("embed", "vocab"))
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=bf16, logical=("embed", None))
    return sp


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    return torch.einsum("btd,dnh->btnh", x, shd.local(w))


def _out(o: torch.Tensor, w, mesh) -> torch.Tensor:
    """The heads' output projected by ``wo``, summed over its split heads'
    axes."""
    return tf._tp_sum(torch.einsum("btnh,nhd->btd", o, shd.local(w)), w, 0,
                      mesh)


# the layer params that take the rule (``shd.layer``'s ``keep``): heads
# and MLP columns tensor-parallel, as the dense block's (``tf._TP_KEEP``)
_KEEP = {"attn": (), "xattn": (), "mlp": ()}

# the reference's logical axes of the cross-attention cache
XKV_LOGICAL = ("layers", "cache_batch", "seq", "kv", None)


def _cross_split(cfg: ModelConfig, mesh) -> Optional[tf.CacheSplit]:
    """How the cross-attention cache (L, B, encoder_tokens, Hk, hd) splits
    on ``mesh`` (its kv heads over "model" under ``tp`` / ``fsdp_tp``)."""
    return tf.cache_split(mesh, cfg.encoder_tokens, cfg.num_kv_heads,
                          XKV_LOGICAL)


def _cross_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor,
                mesh=None) -> torch.Tensor:
    xn = L.apply_norm(cfg, p["norm"], x)
    ka, va = tf._kv_for_heads(p, enc_k, enc_v, mesh, cfg.num_heads)
    out = ops.attention(_proj(xn, p["wq"]), ka, va, causal=False,
                        kv_chunk=min(512, enc_k.shape[1]))
    return _out(out, p["wo"], mesh)


def _enc_kv(p: Dict, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def _enc_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
               positions: torch.Tensor, mesh=None,
               seq: Optional[tf.SeqSplit] = None) -> torch.Tensor:
    """An encoder layer over h (B, frames, D); over a sequence split
    ``seq`` h is this rank's block of frames, attending over the keys and
    values gathered along the split's axis."""
    q, kk, vv = tf._qkv(cfg, p["attn"], h, positions)
    kk, vv = tf._kv_for_heads(p["attn"], kk, vv, mesh, cfg.num_heads)
    if seq is not None:
        kk, vv = C.all_gather(kk, 1, seq.axis), C.all_gather(vv, 1, seq.axis)
    out = ops.attention(q, kk, vv, causal=False,
                        kv_chunk=min(512, kk.shape[1]))
    h = h + _out(out, p["attn"]["wo"], mesh)
    return h + tf._mlp(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], h),
                       mesh)


def _layer(tree: Dict, i: int, mesh) -> Dict:
    """Layer ``i`` of stacked encoder or decoder params; over a mesh its
    heads and MLP columns this rank's blocks where the policy splits them
    (``_KEEP``), the storage dims gathered."""
    return tf._layer(tree, i, mesh, _KEEP)


def _pos_rows(pos, seq: Optional[tf.SeqSplit], n: int, mesh):
    """Rows [start, start + n) of a learned position table (S, D), start
    this rank's first position over a sequence split ``seq`` (0 without
    one), from the table gathered whole (whose backward sums the ranks'
    rows)."""
    start = 0 if seq is None else seq.start
    return whole(pos, mesh)[start:start + n]


def encode(cfg: ModelConfig, params: Dict, audio_frames: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """audio_frames (B, encoder_tokens, D) stub frame embeddings -> the
    encoder output (B, encoder_tokens, D) in the config's dtype.
    ``params`` is the nested tree; over a ``mesh`` each layer computes on
    its tensor-parallel blocks and the storage dims (and ``enc_pos``) are
    gathered at their use.  Where the mesh splits the sequence and "model"
    divides the frames (``transformer.seq_split``), each rank encodes its
    block of them and the output is gathered whole after the final
    norm."""
    dt = cfg.torch_dtype
    seq = tf.seq_split(cfg, mesh, audio_frames.shape[1])
    x = tf.seq_block(audio_frames, seq).to(dt)
    x = x + _pos_rows(params["enc_pos"], seq, x.shape[1], mesh).to(dt)
    positions = (0 if seq is None else seq.start) + torch.arange(
        x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        x = _enc_layer(cfg, _layer(params["encoder"], i, mesh), x,
                       positions, mesh, seq)
    return tf.seq_whole(L.apply_norm(
        cfg, whole_tree(params["enc_final_norm"], mesh), x), seq)


def _dec_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor,
               with_cache: bool = False, mesh=None,
               split: Optional[tf.CacheSplit] = None,
               seq: Optional[tf.SeqSplit] = None):
    """A decoder layer over h (B, T, D); over a sequence split ``seq`` h
    is this rank's block of positions: causal self-attention over the
    keys and values gathered along the split's axis, at its offset."""
    q, kk, vv = tf._qkv(cfg, p["attn"], h, positions)
    T = h.shape[1] if seq is None else seq.total
    ck = min(T, L.pick_kv_chunk(h.shape[0], T, cfg.num_heads))
    ka, va = tf._kv_for_heads(p["attn"], kk, vv, mesh, cfg.num_heads)
    if seq is None:
        out = ops.attention(q, ka, va, causal=True, kv_chunk=ck)
    else:
        out = tf._seq_attention(cfg, q, ka, va, seq, 0, mesh, ck)
    h = h + _out(out, p["attn"]["wo"], mesh)
    ek, ev = _enc_kv(p["xattn"], enc_out)
    h = h + _cross_attn(cfg, p["xattn"], h, ek, ev, mesh)
    h = h + tf._mlp(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], h),
                    mesh)
    if not with_cache:
        return h, None
    dt = cfg.torch_dtype
    cache = tf._cache_of(cfg, p["attn"], kk, vv, mesh, seq, split, T)
    xs = _cross_split(cfg, mesh)
    ek, ev = tf.kv_as_cached(p["xattn"]["wk"], ek, ev, mesh,
                             xs.kv if xs else ())
    return h, {**cache, "xk": tf._own(ek, xs, ek.shape[1]).to(dt),
               "xv": tf._own(ev, xs, ev.shape[1]).to(dt)}


def _decode_blocks(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   enc_out: torch.Tensor, positions: torch.Tensor,
                   with_cache: bool = False, mesh=None,
                   split: Optional[tf.CacheSplit] = None,
                   seq: Optional[tf.SeqSplit] = None):
    """The decoder layers over x (this rank's positions over a sequence
    split ``seq``); with ``with_cache`` also the stacked caches {"k", "v"}
    (L, B, T, Hk, hd) and {"xk", "xv"} (L, B, encoder_tokens, Hk, hd),
    this rank's blocks of them over a ``split`` and the cross-attention's
    (:func:`cache_specs`).  A layer's weights are gathered inside its
    recomputed body."""
    if not with_cache:
        for i in range(cfg.num_layers):
            def body(h, i=i):
                return _dec_layer(cfg, _layer(params["decoder"], i, mesh),
                                  h, enc_out, positions, mesh=mesh,
                                  seq=seq)[0]
            x = L.remat(cfg, body, x)
        return x, None
    caches = []
    for i in range(cfg.num_layers):
        x, c = _dec_layer(cfg, _layer(params["decoder"], i, mesh), x,
                          enc_out, positions, with_cache=True, mesh=mesh,
                          split=split, seq=seq)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches])
               for k in ("k", "v", "xk", "xv")}


def _embed_dec(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
               offset: int, mesh=None) -> torch.Tensor:
    """Token embeddings (vocabulary-parallel over ``mesh``, as
    ``transformer.lookup``) plus the learned positions from ``offset``
    (gathered)."""
    x = tf.lookup(params["embed"], tokens, mesh)
    pos = offset + torch.arange(tokens.shape[1], device=x.device)
    return x + whole(params["dec_pos"], mesh)[pos].to(x.dtype)


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  audio_frames: Optional[torch.Tensor], with_cache: bool,
                  mesh=None, max_seq: Optional[int] = None,
                  whole: bool = True):
    if audio_frames is None:
        raise ValueError("the audio family needs the batch's audio_frames "
                         "(B, encoder_tokens, d_model)")
    tree = P.nest(params)
    enc_out = encode(cfg, tree, audio_frames, mesh)
    T = tokens.shape[1]
    split = tf.cache_split(mesh, max_seq or T, cfg.num_kv_heads) \
        if with_cache else None
    seq = tf.seq_split(cfg, mesh, T)
    start = 0 if seq is None else seq.start
    x = _embed_dec(cfg, tree, tf.seq_block(tokens, seq), start, mesh)
    positions = start + torch.arange(x.shape[1], device=x.device)
    x, caches = _decode_blocks(cfg, tree, x, enc_out, positions, with_cache,
                               mesh, split, seq)
    hidden = L.apply_norm(cfg, whole_tree(tree["final_norm"], mesh), x)
    return tf.seq_whole(hidden, seq, whole), caches


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            audio_frames: Optional[torch.Tensor] = None,
            mesh=None, whole: bool = True) -> torch.Tensor:
    """tokens (B, T) and audio_frames (B, encoder_tokens, D) -> the
    decoder's final hidden states (B, T, D); differentiable.  With a
    ``mesh`` the batch is this rank's rows, each layer computes on the
    rank's heads and MLP columns where the policy splits them, the
    embedding on its vocabulary rows, and storage dims are gathered at
    their use; under ``fsdp_tp_seq`` or ``seq_serve`` each rank computes
    its block of the decoder's positions (and of the frames where "model"
    divides them), the hidden states gathered after the final norm, or
    left as this rank's with ``whole=False`` (the loss's)."""
    return _forward_impl(cfg, params, tokens, audio_frames, False, mesh,
                         whole=whole)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            audio_frames: Optional[torch.Tensor] = None, mesh=None,
            max_seq: Optional[int] = None):
    """Forward that also returns the caches {"k", "v", "xk", "xv"} in the
    config's dtype; over a ``mesh`` this rank's blocks of them, ``k`` /
    ``v`` of a ``max_seq`` cache (:func:`cache_specs`)."""
    return _forward_impl(cfg, params, tokens, audio_frames, True, mesh,
                         max_seq)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                mesh=None) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)}: the ``seq_len`` self-attention cache and the
    cross-attention cache over the encoder's frames.  Over a ``mesh`` this
    rank's blocks, as the reference's rule splits ``("layers",
    "cache_batch", "cache_seq", "kv", None)`` (``k`` / ``v``: the
    sequence, or the kv heads where it leaves "model";
    ``transformer.cache_split``) and ``("layers", "cache_batch", "seq",
    "kv", None)`` (``xk`` / ``xv``: the kv heads over "model" under
    ``tp`` / ``fsdp_tp``); ``batch``: the rank's rows."""
    hd, nl, dt = cfg.resolved_head_dim, cfg.num_layers, cfg.torch_dtype
    S, Hk = tf.cache_block(mesh, seq_len, cfg.num_kv_heads)
    xs = _cross_split(cfg, mesh)
    kv = (nl, batch, S, Hk, hd)
    xkv = (nl, batch, xs.size if xs else cfg.encoder_tokens,
           cfg.num_kv_heads // math.prod(mesh.sizes()[a] for a in xs.kv)
           if xs else cfg.num_kv_heads, hd)
    return {"k": (kv, dt), "v": (kv, dt), "xk": (xkv, dt), "xv": (xkv, dt)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda", mesh=None) -> Dict:
    """A zero cache; over a ``mesh`` this rank's blocks
    (:func:`cache_specs`)."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype)
            in cache_specs(cfg, batch, seq_len, mesh).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int, mesh=None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache with this token's keys and values written in, in place).  With
    a ``mesh`` the tokens and the caches are this rank's rows and blocks:
    the self-attention's as the dense decode takes them
    (``transformer._decode_attention``), the cross-attention's kv heads
    attended by the query heads that read them."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = _embed_dec(cfg, tree, tokens, cache_len, mesh)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    split = tf.cache_split(mesh, max_seq, cfg.num_kv_heads)
    xs = _cross_split(cfg, mesh)
    for i in range(cfg.num_layers):
        p = _layer(tree["decoder"], i, mesh)
        x = x + tf._decode_attention(cfg, p["attn"], x, positions,
                                     cache["k"][i], cache["v"][i], cache_len,
                                     0, mesh, split)
        # cross-attention against the cached encoder projections
        pc = p["xattn"]
        xq = _proj(L.apply_norm(cfg, pc["norm"], x), pc["wq"])
        xk, xv = cache["xk"][i], cache["xv"][i]
        xout = tf.cache_attention(xq, pc["wq"], xk, xv,
                                  cfg.encoder_tokens, 0, mesh, xs,
                                  cfg.num_heads)
        x = x + _out(xout, pc["wo"], mesh)
        x = x + tf._mlp(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x),
                        mesh)
    hidden = L.apply_norm(cfg, whole_tree(tree["final_norm"], mesh), x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :], mesh), cache
