"""Tensor-parallel compute for the Mamba2 mixer, zamba2's Mamba layers and
whisper's encoder-decoder against the reference's GSPMD runs.

Four gloo ranks on ("data", "model") = (2, 2) and (1, 4), in one spawn,
against the reference on four forced CPU devices, under ``tp`` and
``fsdp_tp``, for fp32 variants of three smoke configs: mamba2's (8 SSM
heads, split over 2 and 4), zamba2's, and whisper's with 4 heads (its 3
do not split):

* the loss and every leaf's gradient (``step.grads`` of
  ``make_sharded_train_step``, gathered whole) meet the reference's
  ``jax.value_and_grad`` of its ``loss_fn`` under the same shardings, the
  prefill's logits and three decode steps' logits (fixed tokens) meet the
  reference's ``ServeEngine(mesh=, policy=)``, all within 1e-4 relative;
* per rank, ``FlopCounterMode``'s count of the loss's forward lies within
  10% of ``dryrun.split_forward_flops`` (the mixer's projections and SSD
  on the rank's heads, B and C whole; whisper's heads, MLP columns and
  vocabulary over "model");
* no all-gather runs over "model" in the loss and its gradients;
* each rank's ``ssm`` / ``conv`` / ``k`` / ``v`` / ``xk`` / ``xv`` cache
  has the reference's split shape (``sharding.cache_pspec`` of its
  logical axes).

The repair: a cache of 22 positions on (1, 4) under ``tp``, whose
sequence does not divide "model", is split over kv heads instead (the
reference's greedy rule); the port's prefill and decode logits meet the
reference's engine at ``max_seq`` 22 for the dense, hybrid and audio
families.  A mamba2 whose 2 SSM heads do not split computes its mixer
whole beside a conv cache split over d_inner.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MODELS = {"mamba2": ("mamba2-1.3b", {}),
          "zamba2": ("zamba2-2.7b", {}),
          "whisper": ("whisper-tiny", dict(num_heads=4, num_kv_heads=4))}
# served on (1, 4) at a cache of ODD positions: the repair's models, each
# with 4 kv heads, which split over "model"; and mamba2 with 2 SSM heads,
# which do not, while its d_inner does (the mixer then computes whole, the
# conv state is cached over d_inner)
REPAIR = {"qwen2": ("qwen2-1.5b", dict(num_heads=4, num_kv_heads=4)),
          "zamba2": MODELS["zamba2"], "whisper": MODELS["whisper"],
          "mamba2_h2": ("mamba2-1.3b", dict(ssm_head_dim=64))}
KV_REPAIR = ("qwen2", "zamba2", "whisper")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
POLICIES = ("tp", "fsdp_tp")
B, T = 8, 16            # the training batch
SB, S, GEN = 4, 24, 3   # serving: rows, cache length, decode steps
ODD = 22                # the repair's cache length: 22 % 4 != 0
RTOL, ATOL = 1e-4, 1e-6
CASES = list(itertools.product(MESHES, POLICIES, MODELS))
IDS = [".".join(c) for c in CASES]

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke, input_pspecs
from repro.configs.base import ShapeConfig, TrainConfig
from repro.distributed import sharding as shd
from repro.models.registry import get_model
from repro.serving.engine import ServeEngine
from repro.training.train_loop import loss_fn, state_pspecs
data = np.load(sys.argv[1])
models, repair, meshes, policies, (B, T, SB, S, GEN, ODD) = %r
out = {}

def flat(tree, prefix=""):
    for k in sorted(tree):
        path = prefix + "." + k if prefix else k
        if isinstance(tree[k], dict):
            yield from flat(tree[k], path)
        else:
            yield path, tree[k]

def inputs(name, train):
    keys = ("tokens", "labels", "audio_frames") if train \
        else ("req", "req_audio_frames")
    got = {k: data[name + "." + k] for k in keys if name + "." + k in data}
    return {k.replace("req_", "").replace("req", "tokens"): jnp.asarray(v)
            for k, v in got.items()}

def serve(tag, name, model, params, mesh, policy, max_seq):
    eng = ServeEngine(model, params, max_seq, SB, mesh=mesh, policy=policy)
    logits, cache, pos = eng.prefill(inputs(name, False))
    out[tag + ".prefill"] = np.asarray(logits)
    gen = jnp.asarray(data[name + ".gen"])
    for i in range(GEN):
        logits, cache = eng._decode(eng.params, cache, gen[:, i:i + 1],
                                    jnp.int32(pos + i))
        out[tag + ".decode%%d" %% i] = np.asarray(logits)

def init(arch, kw, policy="fsdp_tp"):
    cfg = get_smoke(arch).replace(dtype="float32", sharding=policy, **kw)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          get_model(cfg).init(jax.random.key(0)))
    return cfg, params

# this process's share of the cases: its models and repairs
mine, fixes = sys.argv[3].split(","), sys.argv[4].split(",")
for name, (arch, kw) in models.items():
    if name not in mine:
        continue
    _, params = init(arch, kw)
    batch = inputs(name, True)
    for mname, shape in meshes.items():
        mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=True)
        for policy in policies:
            tag = mname + "." + policy + "." + name
            cfg, _ = init(arch, kw, policy)
            model = get_model(cfg)
            _, ps = state_pspecs(model, TrainConfig(), mesh, policy)
            bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh,
                              policy)
            with mesh:
                fn = jax.jit(jax.value_and_grad(
                    lambda p, b: loss_fn(model, p, b, mesh=mesh)),
                    in_shardings=(shd.tree_named(mesh, ps["params"]),
                                  {k: shd.named(mesh, v)
                                   for k, v in bp.items()}))
                loss, grads = fn(params, batch)
                out[tag + ".loss"] = np.asarray(loss)
                for path, g in flat(grads):
                    out[tag + ".grad." + path] = np.asarray(g)
                serve(tag, name, model, params, mesh, policy, S)

mesh = make_mesh((1, 4), ("data", "model"), axis_types=True)
for name, (arch, kw) in repair.items():
    if name not in fixes:
        continue
    cfg, params = init(arch, kw, "tp")
    with mesh:
        serve("repair." + name, name, get_model(cfg), params, mesh, "tp",
              ODD)
np.savez(sys.argv[2], **out)
""" % ((MODELS, REPAIR, {k: list(v) for k, v in MESHES.items()}, POLICIES,
        (B, T, SB, S, GEN, ODD)),)


def _cfg(name, policy, table=MODELS):
    from repro_torch.configs import get_smoke
    arch, kw = table[name]
    return get_smoke(arch).replace(dtype="float32", sharding=policy, **kw)


def _inputs(data, name, train):
    import torch
    keys = ("tokens", "labels", "audio_frames") if train \
        else ("req", "req_audio_frames")
    return {k.replace("req_", "").replace("req", "tokens"):
            torch.as_tensor(data[f"{name}.{k}"])
            for k in keys if f"{name}.{k}" in data}


def _shapes(cache, prefix=""):
    """{leaf path: shape} of a (nested) cache."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _serve(eng, data, name, cache_len=None):
    """The engine's prefill logits, three decode steps' logits and the
    prefill's cache shapes; ``cache_len``: a cache of that many positions
    made by the model's own entry points (the engine rounds its length up
    to the ranks the sequence may split over)."""
    import torch
    from repro_torch.serving import engine as E
    req = _inputs(data, name, False)
    if cache_len is None:
        logits, cache, pos = eng.prefill(req)
    else:
        view = eng._mesh_for(())
        model = eng.model
        hidden, cache = model.prefill(eng.params, req, mesh=view,
                                      max_seq=cache_len)
        logits = model.logits(eng.params, hidden[:, -1:, :], view)
        cache = E._load_cache(model.cfg, model.init_cache(
            SB, cache_len, "cpu", mesh=view), cache)
        pos = hidden.shape[1]
    shapes = _shapes(cache)
    gen = torch.as_tensor(data[name + ".gen"])
    dec = []
    for i in range(GEN):
        if cache_len is None:
            step_logits, cache = eng.decode(cache, gen[:, i:i + 1], pos + i)
        else:
            step_logits, cache = eng.model.decode_step(
                eng.params, cache, gen[:, i:i + 1], pos + i, mesh=view,
                max_seq=cache_len)
        dec.append(step_logits.numpy())
    eng.close()
    return logits.numpy(), dec, shapes


def _tp_rank(rank, world, data, params):
    """Every four-rank case: the sharded loss and gradients, the forward's
    FLOPs and all-gathers, the meshed engine's prefill, decode and cache,
    and the repair's; results on rank 0 (the counts and shapes on every
    rank)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import split_forward_flops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train_loop import (batch_rows, init_train_state,
                                                 loss_fn,
                                                 make_sharded_train_step)
    meshes = {k: make_mesh(v, ("data", "model"), "cpu")
              for k, v in MESHES.items()}
    out = {}
    gathers = []
    plain_all_gather = C.all_gather

    def counting_all_gather(x, dim, axis):
        gathers.append(axis.group)
        return plain_all_gather(x, dim, axis)

    for mname, policy, name in CASES:
        tag = f"{mname}.{policy}.{name}"
        mesh = meshes[mname]
        cfg = _cfg(name, policy)
        model = get_model(cfg)
        p = {k: v.float() for k, v in params[name].items()}
        batch = _inputs(data, name, True)
        bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh, policy)
        tc = TrainConfig(learning_rate=1e-2, schedule="constant")
        step, _, sh = make_sharded_train_step(model, tc, mesh, policy, bp)
        state = shd.shard_tree(init_train_state(model, tc, p), sh)
        rows = {k: v[shd.slices(v.shape, bp[k], mesh)]
                for k, v in batch.items()}
        model_group = mesh.get_group("model")
        gathers.clear()
        C.all_gather = counting_all_gather
        try:
            loss, grads = step.grads(state, rows)
        finally:
            C.all_gather = plain_all_gather
        out[tag + ".gathers_over_model"] = sum(g is model_group
                                               for g in gathers)
        out[tag + ".gathers"] = len(gathers)
        specs = {k: s.spec for k, s in sh["params"].items()}
        with torch.no_grad():
            whole = {k: shd.gather(g, specs[k], mesh)
                     for k, g in grads.items()}
        view = shd.MeshView(mesh, rows=batch_rows(bp), policy=policy)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            loss_fn(model, state["params"], rows, mesh=view)
        layers, head = split_forward_flops(cfg, T, view.sizes())
        out[tag + ".flops"] = (fc.get_total_flops(),
                               rows["tokens"].numel() * (layers + head))
        logits, dec, shapes = _serve(
            ServeEngine(model, p, S, SB, device="cpu", mesh=mesh,
                        policy=policy), data, name)
        out[tag + ".cache"] = shapes
        if rank == 0:
            out[tag + ".loss"] = float(loss)
            out[tag + ".grads"] = {k: v.numpy() for k, v in whole.items()}
            out[tag + ".prefill"] = logits
            out[tag + ".decode"] = dec
    for name in REPAIR:
        model = get_model(_cfg(name, "tp", REPAIR))
        p = {k: v.float() for k, v in params[name].items()}
        logits, dec, shapes = _serve(
            ServeEngine(model, p, ODD, SB, device="cpu",
                        mesh=meshes["1x4"], policy="tp"), data, name, ODD)
        out[f"repair.{name}.cache"] = shapes
        if rank == 0:
            out[f"repair.{name}.prefill"] = logits
            out[f"repair.{name}.decode"] = dec
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import params_from_jax
    tmp = tmp_path_factory.mktemp("tp_ssm")
    rng = np.random.default_rng(0)
    data, params = {}, {}
    for name, (arch, kw) in {**MODELS, **REPAIR}.items():
        cfg = jget_smoke(arch).replace(**kw)
        v = cfg.vocab_size
        data[name + ".tokens"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[name + ".labels"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[name + ".req"] = rng.integers(0, v, (SB, T)).astype(np.int32)
        data[name + ".gen"] = rng.integers(0, v, (SB, GEN)).astype(np.int32)
        if cfg.family == "audio":
            frames = (cfg.encoder_tokens, cfg.d_model)
            data[name + ".audio_frames"] = rng.standard_normal(
                (B,) + frames).astype(np.float32)
            data[name + ".req_audio_frames"] = rng.standard_normal(
                (SB,) + frames).astype(np.float32)
    np.savez(tmp / "in.npz", **data)
    # the reference's compiles are most of the time: one process a model
    # (the qwen2 repair beside mamba2), each on four forced devices
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / f"out.{name}.npz"), name, fixes],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, fixes in (("mamba2", "qwen2,mamba2_h2"),
                            ("zamba2", "zamba2"), ("whisper", "whisper"))]
    try:
        for name, (arch, kw) in {**MODELS, **REPAIR}.items():
            jm = jget_model(jget_smoke(arch).replace(dtype="float32", **kw))
            params[name] = params_from_jax(jax.tree.map(
                np.asarray, jm.init(jax.random.key(0))), device="cpu")
        got = run_ranks(_tp_rank, 4, "cpu", args=(data, params), threads=1,
                        timeout=300)
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    want = {}
    for ref, err, name in zip(refs, errs, MODELS):
        assert ref.returncode == 0, err[-3000:]
        want.update(np.load(tmp / f"out.{name}.npz"))
    return got, want


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_meet_the_reference(ranks, case):
    got, want = ranks
    np.testing.assert_allclose(got[0][case + ".loss"], want[case + ".loss"],
                               rtol=RTOL)
    grads = got[0][case + ".grads"]
    assert set(grads) == {k[len(case) + 6:] for k in want
                          if k.startswith(case + ".grad.")}
    for k, g in grads.items():
        w = want[f"{case}.grad.{k}"]
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def _meets(got, want, tag):
    """Logits within 1e-4 relative, and, for those near zero, 1e-6 of the
    largest (the gradients' bound): the sums over "model" add the ranks'
    shares in another order than GSPMD's."""
    pairs = [(got[tag + ".prefill"], want[tag + ".prefill"], "prefill")]
    pairs += [(g, want[f"{tag}.decode{i}"], f"decode step {i}")
              for i, g in enumerate(got[tag + ".decode"])]
    for g, w, what in pairs:
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0),
                                   err_msg=what)


@pytest.mark.parametrize("case", IDS)
def test_prefill_and_decode_meet_the_reference(ranks, case):
    got, want = ranks
    _meets(got[0], want, case)


@pytest.mark.parametrize("case", IDS)
def test_forward_flops_are_split_over_model(ranks, case):
    got, _ = ranks
    for r, out in enumerate(got):
        counted, analytic = out[case + ".flops"]
        assert abs(counted - analytic) <= 0.1 * analytic, (r, counted,
                                                           analytic)


@pytest.mark.parametrize("case", IDS)
def test_no_leaf_is_gathered_over_a_tensor_parallel_dim(ranks, case):
    got, _ = ranks
    for out in got:
        assert out[case + ".gathers_over_model"] == 0
    # fsdp_tp at (2, 2) stores d_model over "data": those dims are gathered
    assert (got[0][case + ".gathers"] > 0) == case.startswith("2x2.fsdp_tp")


def _cache_shapes(cfg, data, model, seq_len):
    """The reference's split of each cache leaf for ``SB`` rows over
    (data, model) ranks: rows over "data", the sequence over "model"
    (``seq_len`` divides it here), the SSM heads and the conv's d_inner
    over "model", the cross-attention's kv heads over "model"."""
    L, hd, Hk = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    H, shd_, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    K, di, b = cfg.ssm_conv_kernel, cfg.ssm_d_inner, SB // data
    ssm = {"ssm": (b, H // model, shd_, N), "conv": (b, K - 1, di // model)}
    kv = (b, seq_len // model, Hk, hd)
    if cfg.family == "ssm":
        return {k: (L,) + v for k, v in ssm.items()}
    if cfg.family == "hybrid":
        na, per = L // cfg.shared_attn_every, cfg.shared_attn_every
        return {"attn.k": (na,) + kv, "attn.v": (na,) + kv,
                **{"ssm." + k: (na, per) + v for k, v in ssm.items()}}
    xkv = (L, b, cfg.encoder_tokens, Hk // model, hd)
    return {"k": (L,) + kv, "v": (L,) + kv, "xk": xkv, "xv": xkv}


@pytest.mark.parametrize("case", IDS)
def test_each_rank_holds_the_reference_split_of_the_caches(ranks, case):
    got, _ = ranks
    mname, policy, name = case.split(".")
    want = _cache_shapes(_cfg(name, policy), *MESHES[mname], S)
    for out in got:
        assert out[case + ".cache"] == want


@pytest.mark.parametrize("name", KV_REPAIR)
def test_an_indivisible_cache_splits_over_kv_heads(ranks, name):
    """22 positions do not split over the 4 "model" ranks: the sequence
    stays whole and the kv heads take "model", as the reference's greedy
    rule gives them (the port raised here before); prefill and decode
    meet the reference's engine at ``max_seq`` 22."""
    got, want = ranks
    cfg = _cfg(name, "tp", REPAIR)
    kv = (SB, ODD, cfg.num_kv_heads // 4, cfg.resolved_head_dim)
    lead = (cfg.num_layers // cfg.shared_attn_every,) \
        if cfg.family == "hybrid" else (cfg.num_layers,)
    pre = "attn." if cfg.family == "hybrid" else ""
    for out in got:
        shapes = out[f"repair.{name}.cache"]
        assert shapes[pre + "k"] == shapes[pre + "v"] == lead + kv
    _meets(got[0], want, "repair." + name)


def test_a_mixer_whose_heads_do_not_split_computes_whole(ranks):
    """mamba2 with 2 SSM heads on (1, 4): the heads do not divide "model"
    but d_inner does, so the mixer gathers its blocks and computes whole
    (``mamba2.mixer_params``) while the cache keeps the reference's split
    (``ssm`` whole, ``conv`` over d_inner); prefill and decode meet the
    reference's engine."""
    got, want = ranks
    cfg = _cfg("mamba2_h2", "tp", REPAIR)
    L, K, di = cfg.num_layers, cfg.ssm_conv_kernel, cfg.ssm_d_inner
    for out in got:
        assert out["repair.mamba2_h2.cache"] == {
            "ssm": (L, SB, cfg.ssm_num_heads, cfg.ssm_head_dim,
                    cfg.ssm_state),
            "conv": (L, SB, K - 1, di // 4)}
    _meets(got[0], want, "repair.mamba2_h2")


def test_cache_split_of_reads_the_layout_from_the_block():
    """``transformer.cache_split`` splits a cache along the sequence where
    every "model" rank divides it, over kv heads where it does not, and
    leaves it whole where neither divides; ``cache_block`` is the block
    that split gives this rank.  On a mesh it refuses a cache whose
    length it is not given."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tf

    class Mesh:   # four "model" ranks, this one the third
        mesh_dim_names = ("data", "model")
        shape = (1, 4)

        def get_local_rank(self, name):
            return {"data": 0, "model": 2}[name]

    view = shd.MeshView(Mesh(), policy="tp")
    assert tf.cache_split(view, 24, 4) == tf.CacheSplit(("model",), 12, 6)
    assert tf.cache_split(view, 22, 4) == tf.CacheSplit((), 0, 22,
                                                        ("model",))
    assert tf.cache_split(view, 22, 2) is None
    for seq_len, heads, block in ((24, 4, (6, 4)), (22, 4, (22, 1)),
                                  (24, 2, (6, 2)), (22, 2, (22, 2))):
        assert tf.cache_block(view, seq_len, heads) == block
    assert tf.cache_split(None, None, 4) is None
    with pytest.raises(ValueError, match="pass max_seq"):
        tf.cache_split(view, None, 4)
