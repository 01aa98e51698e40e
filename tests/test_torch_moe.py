"""The ``moe`` family (dbrx-132b, and kimi-k2-1t-a32b for its shared
expert) through the port against the JAX package, on one device: one
param tree (made with numpy at the reference's shapes and dtypes) given to
both, the port's copy through ``models.convert``, the same numpy inputs.

Held exactly: ``_bucket_by`` (bucket, slot, kept), and the routing of a
layer's tokens (the top-k experts in the reference's order, each copy's
expert, slot and kept mask, the capacity), at the configs' capacity factor
and at 0.5, where copies are dropped; a router tie goes to the lower
expert index.  Held at the tolerances of ``test_torch_dense.py``:
``moe_block`` and ``_moe_local``, ``forward``, ``prefill`` and
``decode_step`` (fp32 1e-4; bf16 atol = rtol = 0.1, the bf16 K/V cache
within one more bf16 step, 2^-7 relative); greedy tokens and ``score``
in fp32 (tokens equal, statistics 1e-4).  A mesh of one device is the
local block, bit for bit; a mesh of more than one device, where the
reference shards the experts, needs ranks (``moe_block`` raises on a mesh
that is only a description; the sharded routes on four ranks are
``test_torch_moe_mesh.py``'s)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as JT
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import param as P
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine
from test_torch_dense import _f32, cast_tree, jax_generate, make_jax_tree

ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")
B, SEQ, GEN = 2, 40, 5
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _tokens(vocab, seed=2, n=B, t=SEQ):
    return np.random.default_rng(seed).integers(0, vocab, (n, t))


def _layer0(tree):
    """Layer 0's MoE params, numpy."""
    return {k: v[0] for k, v in tree["blocks"]["mlp"].items()
            if k != "shared"} | (
        {"shared": {k: v[0] for k, v in
                    tree["blocks"]["mlp"]["shared"].items()}}
        if "shared" in tree["blocks"]["mlp"] else {})


def _to_torch(p):
    return {k: _to_torch(v) if isinstance(v, dict)
            else params_from_jax({"x": v}, device="cpu")["x"]
            for k, v in p.items()}


def _jax_routing(jcfg, jp, x):
    """The reference's ``_moe_local`` up to its dispatch: top-k over the
    fp32 router's softmax, the capacity and ``_bucket_by`` over the
    token-major copies."""
    n = x.shape[0]
    E = jcfg.num_experts
    k = min(jcfg.experts_per_token, E)
    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", x.astype(jnp.float32),
                                      jp["router"]), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    cap = int(np.ceil(n * k / E * jcfg.moe_capacity_factor))
    cap = max(min(cap, n * k), min(n * k, 16))
    e, c, keep = JT._bucket_by(top_e.reshape(-1), E, cap)
    return (np.asarray(top_p), np.asarray(top_e), np.asarray(e).reshape(n, k),
            np.asarray(c).reshape(n, k), np.asarray(keep).reshape(n, k), cap)


@pytest.mark.parametrize("n_buckets, cap", [(4, 3), (8, 16), (3, 1)])
def test_bucket_by_matches_jax_exactly(n_buckets, cap):
    ids = np.random.default_rng(n_buckets).integers(0, n_buckets + 1, 200)
    want = JT._bucket_by(jnp.asarray(ids, jnp.int32), n_buckets, cap)
    got = T._bucket_by(torch.as_tensor(ids), n_buckets, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # invalid ids (== n_buckets) and overflow copies are dropped
    assert not got[2][torch.as_tensor(ids == n_buckets)].any()
    assert int(got[2].sum()) <= n_buckets * cap


@pytest.fixture(scope="module", params=[(a, cf) for a in ARCHS
                                        for cf in (None, 0.5)],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def layer(request):
    """One layer's MoE params as the JAX package holds them (fp32 router,
    bf16 experts) and 80 token rows, at the config's capacity factor or at
    0.5 (copies dropped)."""
    arch, cf = request.param
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    p = _layer0(make_jax_tree(arch))
    x = np.random.default_rng(7).normal(size=(B * SEQ, cfg.d_model)) \
        .astype(np.float32)
    return cfg, jcfg, p, x


def test_routing_slots_and_drops_match_jax_exactly(layer):
    cfg, jcfg, p, x = layer
    p = cast_tree(p, "float32")
    top_p, top_e, e, c, keep, cap = _jax_routing(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got_p, got_e = T._route(cfg, _to_torch(p), torch.as_tensor(x))
    np.testing.assert_array_equal(got_e.numpy(), top_e)
    np.testing.assert_allclose(got_p.numpy(), top_p, atol=1e-6, rtol=1e-6)
    ge, gc, gkeep, gcap = T._slots(cfg, got_e)
    assert gcap == cap == T.capacity(cfg, x.shape[0])
    np.testing.assert_array_equal(ge.numpy(), e)
    np.testing.assert_array_equal(gc.numpy(), c)
    np.testing.assert_array_equal(gkeep.numpy(), keep)
    assert keep.all() != (cfg.moe_capacity_factor == 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(layer, dtype):
    """The block (with Kimi's shared expert) and ``_moe_local`` on the
    same params and tokens: fp32 experts, or the bf16 ones with bf16
    tokens (the router fp32 either way)."""
    cfg, jcfg, p, x = layer
    tol = TOL[dtype]
    p = cast_tree(p, dtype)
    jp = jax.tree.map(jnp.asarray, p)
    xd = jnp.asarray(x, getattr(jnp, dtype)).reshape(B, SEQ, -1)
    tp = _to_torch(p)
    xt = torch.as_tensor(x).to(getattr(torch, dtype)).reshape(B, SEQ, -1)
    got = T.moe_block(cfg, tp, xt)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_allclose(_f32(got), _f32(JT.moe_block(jcfg, jp, xd)),
                               atol=tol, rtol=tol)
    local = T._moe_local(cfg, tp, xt.reshape(B * SEQ, -1))
    want = JT._moe_local(jcfg, jp, xd.reshape(B * SEQ, -1), 0,
                         jcfg.num_experts, None)
    np.testing.assert_allclose(_f32(local), _f32(want), atol=tol, rtol=tol)


def test_router_tie_goes_to_the_lower_expert():
    """Integer-valued tokens and router, experts 1 and 3 with equal
    columns larger than the rest: their logits are exactly equal and the
    largest, and both packages pick 1 before 3; an all-zero token ties
    every expert and picks 0 and 1."""
    cfg = get_smoke("dbrx-132b")
    rng = np.random.default_rng(3)
    router = rng.integers(-1, 2, (cfg.d_model, cfg.num_experts)) \
        .astype(np.float32)
    router[:, 1] = router[:, 3] = 2.0
    x = rng.integers(0, 3, (16, cfg.d_model)).astype(np.float32)
    x[0] = 0.0
    _, want = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(router), axis=-1),
        cfg.experts_per_token)
    _, got = T._route(cfg, {"router": torch.as_tensor(router)},
                      torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[0, 1]] + [[1, 3]] * 15


def test_moe_block_raises_where_the_reference_shards():
    """Bit-equal on a one-device mesh; on a larger mesh given only as a
    description (no ranks to shard over) it raises."""
    cfg = get_smoke("dbrx-132b")
    p = _to_torch(_layer0(cast_tree(make_jax_tree("dbrx-132b"), "float32")))
    x = torch.randn(1, 4, cfg.d_model)
    one = types.SimpleNamespace(axis_names=("data", "model"),
                                devices=np.empty((1, 1), object))
    torch.testing.assert_close(T.moe_block(cfg, p, x, mesh=one),
                               T.moe_block(cfg, p, x), atol=0, rtol=0)
    for shape in ((1, 2), (2, 1), (2, 2)):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty(shape, object))
        with pytest.raises(ValueError, match="sharded MoE routes"):
            T.moe_block(cfg, p, x, mesh=mesh)


class Jitted:
    def __init__(self, jm):
        self.prefill = jax.jit(jm.prefill)
        self.decode_step = jax.jit(jm.decode_step)
        self.logits = jax.jit(jm.logits)
        self.init_cache = jm.init_cache


_JITTED = {}


def jitted(arch: str) -> Jitted:
    if arch not in _JITTED:
        _JITTED[arch] = Jitted(jget_model(jget_smoke(arch)))
    return _JITTED[arch]


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    arch, dtype = request.param
    jparams = cast_tree(make_jax_tree(arch), dtype)
    return arch, dtype, jitted(arch), jax.tree.map(jnp.asarray, jparams), \
        get_model(get_smoke(arch)), params_from_jax(jparams, device="cpu")


def test_forward_prefill_and_decode_step_match_jax(both):
    arch, dtype, jm, jp, m, p = both
    cfg = get_smoke(arch)
    tol = TOL[dtype]
    tok = _tokens(cfg.vocab_size, 3)
    jh, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = m.forward(p, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, SEQ, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(jh), atol=tol, rtol=tol)
    h, c = m.prefill(p, {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    for leaf in ("k", "v"):
        assert tuple(c[leaf].shape) == jc[leaf].shape
        np.testing.assert_allclose(_f32(c[leaf]), _f32(jc[leaf]), atol=tol,
                                   rtol=tol + 2 ** -7)
    S = SEQ + 8
    jfull = {k: jnp.zeros(v.shape, v.dtype).at[:, :, :SEQ].set(jc[k])
             for k, v in jm.init_cache(B, S).items()}
    full = m.init_cache(B, S, device="cpu")
    for k in ("k", "v"):
        full[k][:, :, :SEQ] = c[k]
    nxt = _tokens(cfg.vocab_size, 4, t=1)
    jl, jnew = jm.decode_step(jp, jfull, jnp.asarray(nxt, jnp.int32),
                              jnp.int32(SEQ))
    lg, new = m.decode_step(p, full, torch.as_tensor(nxt), SEQ)
    assert lg.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_f32(lg), _f32(jl), atol=tol, rtol=tol)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_f32(new[leaf]), _f32(jnew[leaf]),
                                   atol=tol, rtol=tol + 2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_score_match_jax_in_fp32(arch):
    cfg = get_smoke(arch)
    jparams = cast_tree(make_jax_tree(arch), "float32")
    jp = jax.tree.map(jnp.asarray, jparams)
    e = ServeEngine(get_model(cfg), params_from_jax(jparams, device="cpu"),
                    max_seq=SEQ + 8, batch_size=B, device="cpu")
    tok = _tokens(cfg.vocab_size, 5)
    got = e.generate({"tokens": tok}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_generate(jitted(arch), jp, tok, GEN))
    je = JServeEngine(jget_model(jget_smoke(arch)), jp, max_seq=SEQ + 8,
                      batch_size=B)
    tok = _tokens(cfg.vocab_size, 6)
    # the pool sweep pads its page to 8 rows, and the padding rows' copies
    # take expert slots as well (capacity routing couples the rows of a
    # forward): it is held against the reference's sweep, not its score
    for got, want in ((e.score({"tokens": tok}),
                       je.score({"tokens": jnp.asarray(tok, jnp.int32)})),
                      (e.score_pool({"tokens": tok}),
                       je.score_pool({"tokens": tok.astype(np.int32)}))):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)
        np.testing.assert_array_equal(got.top1.numpy(),
                                      np.asarray(want.top1))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_spec_tree_equals_jax(arch):
    """Every path, shape, dtype, init and scale of the full config (the
    router fp32, the experts bf16), without allocating a parameter."""
    jspecs = jget_model(jget_config(arch)).specs
    jleaves = {jax.tree_util.keystr(path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   jspecs, is_leaf=lambda x: hasattr(x, "logical"))[0]}
    ours = {P._keystr(path): s for path, s in
            P.iter_specs(get_model(get_config(arch)).specs)}
    assert sorted(ours) == sorted(jleaves)
    for k, s in ours.items():
        j = jleaves[k]
        assert (s.shape, s.init, s.scale) == (j.shape, j.init, j.scale), k
        assert str(s.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert sum(int(np.prod(s.shape)) for s in ours.values()) == \
        jget_model(jget_config(arch)).param_count()
    assert ("['blocks']['mlp']['shared']['w_gate']" in ours) == \
        (arch == "kimi-k2-1t-a32b")


def test_launcher_serves_dbrx_smoke_on_cpu(capsys):
    out = launch_serve.main(["--arch", "dbrx-132b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "12",
                             "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    stats = launch_serve.main(["--arch", "kimi-k2-1t-a32b", "--smoke",
                               "--device", "cpu", "--prompt-len", "12",
                               "--score-pool", "8", "--sweep-page", "4"])
    assert tuple(stats.margin.shape) == (8,)
