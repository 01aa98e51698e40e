"""LM training on one device (the port's ``training/``, ``data/loader.py``,
``distributed/`` and ``launch/train.py``) against the JAX package, on the
same numpy inputs and params (carried across by ``models.convert``).

Tolerances, each with its reason:
- attention gradients through ``ops.attention``'s CPU path against
  ``jax.grad`` of the reference's ``blockwise_attention``, fp32: atol =
  rtol = 1e-5 (the same online softmax; sums in another order);
- ``chunked_cross_entropy``: value rtol 1e-6, gradients atol = rtol =
  1e-5 (fp32 products in another order);
- ``loss_fn`` on the smoke configs in fp32: loss rtol 1e-5, gradients
  atol 1e-5 + rtol 1e-3 (a whole model's fp32 sums in another order);
- one train step: the loss to 1e-5, each param to 1e-6 except where the
  reference's gradient is below 1e-5, where Adam's first step turns
  last-bit differences into up to lr (``test_torch_fit.py`` documents the
  hazard), bounded there by 2 lr;
- the optimizer's slots: bf16 ``m`` equal, int8 ``m_q`` equal, fp32 ones
  and the params to 1e-6;
- schedules: ``constant`` and ``paper_steps`` equal to the reference's
  jitted fp32 values, ``cosine`` to 1e-6 relative (XLA's fp32 cos);
- tokens, the loader's batch order, the straggler monitor's events and
  checkpoints' bits: exact.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.loader import ShardedLoader as JShardedLoader
from repro.data.synth import make_lm_tokens as jmake_lm_tokens
from repro.distributed import checkpoint as jckpt
from repro.distributed.straggler import StragglerMonitor as JStraggler
from repro.models import layers as JL
from repro.models.registry import get_model as jget_model
from repro.training import optimizer as jopt
from repro.training.schedules import make_schedule as jmake_schedule
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import loss_fn as jloss_fn
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synth import make_lm_tokens
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule
from repro_torch.training.train_loop import (init_train_state, loss_fn,
                                             make_train_step)
from repro_torch.training.trainer import Trainer, TrainerConfig
from test_torch_dense import cast_tree, make_jax_tree


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# attention gradients
# ---------------------------------------------------------------------------


# (B, H, Hk, Tq, Tk, hd, causal, window, kv_chunk): causal; windowed GQA;
# non-causal with Tq != Tk and Tk off the chunk (a ragged last chunk)
ATTN_GRAD = [(2, 4, 4, 24, 24, 16, True, 0, 8),
             (1, 6, 2, 40, 40, 8, True, 12, 16),
             (2, 3, 3, 10, 13, 16, False, 0, 8)]


@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window,ck", ATTN_GRAD)
def test_attention_cpu_gradients_match_jax_blockwise(B, H, Hk, Tq, Tk, hd,
                                                     causal, window, ck):
    rng = np.random.default_rng(Tq + Tk + H)
    q = rng.normal(size=(B, Tq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Tk, Hk, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, Tq, H, hd)).astype(np.float32)

    def jloss(q, k, v):
        out = JL.blockwise_attention(q, k, v, causal=causal, window=window,
                                     kv_chunk=ck)
        return jnp.sum(out * do)
    jout = JL.blockwise_attention(q, k, v, causal=causal, window=window,
                                  kv_chunk=ck)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=causal, window=window, kv_chunk=ck)
    g = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(masked):
    """V = 50 over chunks of 16: padded to 64, the last chunk ragged."""
    rng = np.random.default_rng(4)
    T, D, V = 12, 24, 50
    h = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, (2, T // 2)).astype(np.int32)
    lab[0, 0] = V - 1                     # a label in the padded chunk
    mask = (rng.random((2, T // 2)) > 0.3).astype(np.float32) \
        if masked else None
    jfn = functools.partial(JL.chunked_cross_entropy, chunk=16,
                            mask=None if mask is None else jnp.asarray(mask))
    jval, jg = jax.value_and_grad(jfn, argnums=(0, 1))(h, w, lab)
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    val = L.chunked_cross_entropy(th, tw, _t(lab), chunk=16,
                                  mask=None if mask is None else _t(mask))
    g = torch.autograd.grad(val, (th, tw))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    # the materialized loss is the same function
    logits = (th @ tw)
    full = L.cross_entropy(logits, _t(lab),
                           None if mask is None else _t(mask))
    np.testing.assert_allclose(float(full.detach()), float(val.detach()),
                               rtol=1e-6)


LOSS_ARCHS = [("qwen2-1.5b", 0), ("qwen2-1.5b", 64), ("internvl2-26b", 0),
              ("mamba2-1.3b", 0), ("whisper-tiny", 0), ("zamba2-2.7b", 0)]


def _batch(cfg, seed, n=2, t=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, t + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(n, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = rng.normal(
            size=(n, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _fp32_pair(arch, **kw):
    """The smoke config in fp32 for both packages, and one fp32 param tree
    (numpy) for both."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32", **kw)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **kw)
    tree = cast_tree(make_jax_tree(arch), "float32")
    return jget_model(jcfg), get_model(cfg), tree


@pytest.mark.parametrize("arch,chunk", LOSS_ARCHS)
def test_loss_fn_and_grads_match_jax(arch, chunk):
    jm, m, tree = _fp32_pair(arch, logits_chunk=chunk)
    batch = _batch(m.cfg, 7)
    jval, jg = jax.value_and_grad(functools.partial(jloss_fn, jm))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(tree, device="cpu").items()}
    val = loss_fn(m, params, {k: _t(v) for k, v in batch.items()})
    names = sorted(params)
    g = dict(zip(names, torch.autograd.grad(val, [params[k] for k in names])))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    jflat = {P._keystr(k): v for k, v in P.iter_specs(m.specs)}
    want = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(want) == sorted(jflat)
    for name in names:
        np.testing.assert_allclose(g[name].numpy(), want[P._keystr(name)],
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_remat_recomputes_to_the_same_gradients():
    """``remat="layer"`` (the full configs') recomputes each layer in the
    backward: on the CPU the gradients are bit-equal to keeping them."""
    _, m, tree = _fp32_pair("qwen2-1.5b")
    m2 = get_model(dataclasses.replace(m.cfg, remat="layer"))
    batch = {k: _t(v) for k, v in _batch(m.cfg, 8).items()}
    grads = []
    for model in (m, m2):
        params = {k: v.requires_grad_(True)
                  for k, v in params_from_jax(tree, device="cpu").items()}
        val = loss_fn(model, params, batch)
        grads.append(torch.autograd.grad(val, [params[k]
                                               for k in sorted(params)]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step, the optimizer and the schedules
# ---------------------------------------------------------------------------


def test_one_lm_train_step_matches_jax():
    """qwen2-smoke, fp32, one AdamW step at lr 1e-2 (constant)."""
    jm, m, tree = _fp32_pair("qwen2-1.5b")
    kw = dict(learning_rate=1e-2, schedule="constant", total_steps=4)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    batch = _batch(m.cfg, 9, n=4, t=16)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams,
              "opt": jopt.init_slots(compat.tree_leaves(jparams), jtc),
              "step": jnp.zeros((), jnp.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # before the step, which donates the state
    jgrad = jax.grad(functools.partial(jloss_fn, jm))(jparams, jbatch)
    jnew, jmet = jmake_train_step(jm, jtc)(jstate, jbatch)
    state = init_train_state(m, tc, params_from_jax(tree, device="cpu"))
    new, met = make_train_step(m, tc)(state, {k: _t(v)
                                              for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert new["step"] == int(jnew["step"]) == 1
    got = {P._keystr(k): v.numpy() for k, v in new["params"].items()}
    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jnew["params"])[0]}
    gref = {jax.tree_util.keystr(p): np.abs(np.asarray(a)) for p, a in
            jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        sure = gref[k] >= 1e-5
        assert (diff[sure] <= 1e-6 + 1e-6 * np.abs(w[sure])).all(), k
        assert (diff <= 2 * 1e-2).all(), k


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_grad_accum_step_matches_jax(accum_dtype):
    """qwen2-smoke, fp32 params, one step over 2 microbatches pre-split on a
    leading axis, the gradients summed in ``accum_dtype``: the loss, the
    global norm and the params as ``test_one_lm_train_step_matches_jax``
    holds them (a bf16 carry rounds both packages' sums alike, so only
    the microbatches' fp32 gradients differ in their last bits)."""
    jm, m, tree = _fp32_pair("qwen2-1.5b")
    kw = dict(learning_rate=1e-2, schedule="constant", grad_accum=2,
              accum_dtype=accum_dtype)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    batch = {k: v.reshape((2, 2) + v.shape[1:])
             for k, v in _batch(m.cfg, 12, n=4, t=16).items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the summed gradient, for the Adam hazard's mask
    gsum = jax.tree.map(lambda *g: sum(g), *[
        jax.grad(functools.partial(jloss_fn, jm))(
            jparams, {k: v[i] for k, v in jbatch.items()}) for i in (0, 1)])
    jstate = {"params": jparams,
              "opt": jopt.init_slots(compat.tree_leaves(jparams), jtc),
              "step": jnp.zeros((), jnp.int32)}
    jnew, jmet = jmake_train_step(jm, jtc)(jstate, jbatch)
    state = init_train_state(m, tc, params_from_jax(tree, device="cpu"))
    new, met = make_train_step(m, tc)(state, {k: _t(v)
                                              for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    got = {P._keystr(k): v.numpy() for k, v in new["params"].items()}
    gref = {jax.tree_util.keystr(p): np.abs(np.asarray(a)) / 2 for p, a in
            jax.tree_util.tree_flatten_with_path(gsum)[0]}
    for path, w in jax.tree_util.tree_flatten_with_path(jnew["params"])[0]:
        k, w = jax.tree_util.keystr(path), np.asarray(w)
        diff = np.abs(got[k] - w)
        sure = gref[k] >= 1e-5
        assert (diff[sure] <= 1e-6 + 1e-6 * np.abs(w[sure])).all(), k
        assert (diff <= 2 * 1e-2).all(), k


@pytest.mark.parametrize("moment,factored", [("bfloat16", False),
                                             ("int8", False),
                                             ("float32", True),
                                             ("int8", True)])
def test_optimizer_slots_match_jax(moment, factored):
    """Three AdamW steps from zero slots on fixed numpy gradients, leaves
    factorable (>= 8 x 8) and not."""
    rng = np.random.default_rng(11)
    shapes = {"a": (9, 12), "b": (12,), "c": (2, 8, 10), "d": (3, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(moment_dtype=moment, factored_second_moment=factored,
              learning_rate=1e-2)
    tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    js = jopt.init_slots([jp[k] for k in sorted(jp)], jtc)
    tp = {k: _t(a) for k, a in p.items()}
    ts = opt.init_slots(tp, tc)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 0.1 + 0.05).astype(np.float32)
             for k, s in shapes.items()}
        jp, js = jopt.adamw_update(jp, {k: jnp.asarray(a)
                                        for k, a in g.items()}, js,
                                   jnp.int32(step), jnp.float32(1e-2), jtc)
        tp, ts = opt.adamw_update(tp, {k: _t(a) for k, a in g.items()}, ts,
                                  step, 1e-2, tc)
    for k in sorted(p):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)
    for t_slot, j_slot in zip(ts, js):
        assert sorted(t_slot) == sorted(j_slot)
        for name, a in t_slot.items():
            w = np.asarray(j_slot[name])
            assert tuple(a.shape) == w.shape
            if name == "m_q":
                np.testing.assert_array_equal(a.numpy(), w)
            elif a.dtype == torch.bfloat16:
                np.testing.assert_array_equal(a.float().numpy(),
                                              w.astype(np.float32))
            else:
                np.testing.assert_allclose(a.numpy(), w, rtol=1e-6,
                                           atol=1e-9)
    q = opt.quantize_int8(_t(p["a"]))
    jq = jopt.quantize_int8(jnp.asarray(p["a"]))
    np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(opt.dequantize_int8(q).numpy(),
                                  np.asarray(jopt.dequantize_int8(jq)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_slot_order_is_the_reference_leaf_order(arch):
    """The slots (and a checkpoint's leaves) follow the params' sorted
    dotted paths: the order the reference's pytrees flatten in."""
    jspecs = jget_model(jget_smoke(arch)).specs
    jorder = [jax.tree_util.keystr(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(
                  jspecs, is_leaf=lambda x: hasattr(x, "logical"))[0]]
    flat = {path: torch.zeros(1) for path, _ in
            P.iter_specs(get_model(get_smoke(arch)).specs)}
    assert [P._keystr(k) for k in sorted(flat)] == jorder
    assert [k for k, _ in ckpt.leaves({"params": flat})] == \
        ["['params']" + k for k in jorder]


@pytest.mark.parametrize("schedule", ["constant", "cosine", "paper_steps"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_jax(schedule, warmup):
    for total in (6, 37):
        kw = dict(schedule=schedule, total_steps=total, warmup_steps=warmup,
                  learning_rate=3e-4)
        want = jax.jit(jmake_schedule(JTrainConfig(**kw)))
        got = make_schedule(TrainConfig(**kw))
        for step in range(total + 3):
            g, w = np.float32(got(step)), np.asarray(want(jnp.int32(step)))
            if schedule == "cosine":
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                assert g == w, (total, step)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule(TrainConfig(schedule="linear"))
    assert TrainConfig().schedule == JTrainConfig().schedule == "paper_steps"


# ---------------------------------------------------------------------------
# data, straggler, checkpoints
# ---------------------------------------------------------------------------


def test_make_lm_tokens_is_the_reference_bits():
    for args in ((6, 33, 256, 0), (3, 10, 51872, 5), (4, 2049, 151936, 1)):
        a, b = make_lm_tokens(*args), jmake_lm_tokens(*args)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batch_order_matches_jax(drop_last):
    data = {"x": np.arange(44 * 3).reshape(44, 3).astype(np.float32),
            "y": np.arange(44, dtype=np.int32)}
    ours = ShardedLoader(data, 8, seed=3, drop_last=drop_last, device="cpu")
    ref = JShardedLoader(data, 8, seed=3, drop_last=drop_last)
    for _ in range(2):                       # two epochs: the rng advances
        got, want = list(ours.epoch()), list(ref.epoch())
        assert len(got) == len(want) == (5 if drop_last else 6)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    # over a one-rank mesh the loader's batches are the same rows, placed
    from repro_torch.launch.mesh import run_ranks
    meshed, = run_ranks(_one_rank_loader, 1, "cpu", args=(data, drop_last),
                        threads=1, timeout=120)
    plain = ShardedLoader(data, 8, seed=3, drop_last=drop_last,
                          device="cpu")
    for _ in range(2):
        want = [{k: v.numpy() for k, v in b.items()} for b in plain.epoch()]
        got = meshed.pop(0)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def _one_rank_loader(rank, world, data, drop_last):
    """Two epochs of ``ShardedLoader(mesh=)`` on a one-rank mesh: each
    batch's leaves as numpy, after checking they are placed whole."""
    from repro_torch.distributed.sharding import is_placed
    from repro_torch.launch.mesh import make_host_mesh
    loader = ShardedLoader(data, 8, mesh=make_host_mesh("cpu"), seed=3,
                           drop_last=drop_last, device="cpu")
    out = []
    for _ in range(2):
        epoch = []
        for b in loader.epoch():
            assert all(is_placed(v) and v.to_local().shape == v.shape
                       for v in b.values())
            epoch.append({k: v.to_local().numpy() for k, v in b.items()})
        out.append(epoch)
    return out


def test_straggler_events_match_jax():
    times = [0.10 + 0.002 * (i % 3) for i in range(20)] + \
        [0.5, 0.11, 0.3, 0.1, 0.9] + [0.1] * 40 + [0.2]
    got, want = [], []
    ours = StragglerMonitor(min_samples=8, k_mad=4.0,
                            on_straggler=got.append)
    ref = JStraggler(min_samples=8, k_mad=4.0, on_straggler=want.append)
    for t in times:
        a, b = ours.observe(t), ref.observe(t)
        assert (a is None) == (b is None)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    assert len(got) >= 3


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("moment", ["float32", "int8"])
def test_checkpoints_restore_across_packages(tmp_path, moment):
    """Each package restores the other's checkpoint of a qwen2-smoke train
    state (bf16 params, ``moment`` slots, the step) bit for bit."""
    arch = "qwen2-1.5b"
    tree = make_jax_tree(arch)                        # bf16 weights
    kw = dict(moment_dtype=moment, learning_rate=1e-2, schedule="constant")
    tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
    jm, m = jget_model(jget_smoke(arch)), get_model(get_smoke(arch))
    batch = _batch(m.cfg, 3)
    state = init_train_state(m, tc, params_from_jax(tree, device="cpu"))
    state, _ = make_train_step(m, tc)(state, {k: _t(v)
                                              for k, v in batch.items()})
    ckpt.save(str(tmp_path / "port"), 1, state, extra={"who": "port"})
    jlike = jinit_train_state(jm, jtc, jax.random.key(1))
    jgot, man = jckpt.restore(str(tmp_path / "port"), 1, jlike)
    assert man["extra"] == {"who": "port"} and int(jgot["step"]) == 1
    want = dict(ckpt.leaves(state))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgot)[0]:
        w = want[jax.tree_util.keystr(path)]
        w = w.view(torch.int16).numpy().view(np.uint16) \
            if isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16 \
            else np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w)
        np.testing.assert_array_equal(_bits(leaf), w)
    # and the other way: the reference's step on its state, restored here
    jstate = dict(jlike, params=jax.tree.map(jnp.asarray, tree))
    jstate, _ = jmake_train_step(jm, jtc)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jckpt.save(str(tmp_path / "jax"), 1, jstate)
    like = init_train_state(m, tc, params_from_jax(tree, device="cpu"))
    got, _ = ckpt.restore(str(tmp_path / "jax"), ckpt.latest_step(
        str(tmp_path / "jax")), like)
    assert got["step"] == 1 and sorted(got["params"]) == sorted(like["params"])
    assert got["params"]["embed"].dtype == torch.bfloat16
    back = params_to_numpy(got["params"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_bits(a),
                                                            _bits(b)),
                 back, jax.tree.map(np.asarray, jstate["params"]))
    for slot, jslot in zip(got["opt"], jstate["opt"]):
        for name, a in slot.items():
            np.testing.assert_array_equal(a.numpy(), np.asarray(jslot[name]))


def _lm_data(cfg, n=64, t=33):
    toks = make_lm_tokens(n, t, cfg.vocab_size, seed=0)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _recorded(trainer, losses):
    """Record each step's loss as the trainer reads it."""
    step_fn = trainer.step_fn

    def step(state, batch):
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        return state, met
    trainer.step_fn = step
    return trainer


def test_trainer_checkpoints_and_resumes(tmp_path):
    """The port's twin of the reference's system test, and more: the
    resumed state equals the saved one bit for bit, and the resumed run's
    losses equal those of an uninterrupted run over the same batches (the
    first trainer drew one batch past its last step and dropped it, as the
    reference's does)."""
    cfg = get_smoke("qwen2-1.5b")
    model = get_model(cfg)
    tc = TrainConfig(learning_rate=1e-2, schedule="constant", total_steps=8)
    data = _lm_data(cfg)
    d = str(tmp_path)
    tcfg = TrainerConfig(ckpt_dir=d, ckpt_every=2, max_steps=4, log_every=0)
    tr = Trainer(model, tc, tcfg, seed=0, log_fn=lambda *_: None,
                 device="cpu")
    loader = ShardedLoader(data, 8, seed=0, device="cpu")
    seen = []

    def batches():
        while True:
            for b in loader.epoch():
                seen.append(b)
                yield b

    gen = batches()
    losses = []
    _recorded(tr, losses).fit(gen)
    assert tr.step == 4 and ckpt.latest_step(d) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_0000000002", "step_0000000004"]
    logs = []
    tr2 = Trainer(model, tc, TrainerConfig(ckpt_dir=d, ckpt_every=2,
                                           max_steps=6, log_every=1),
                  seed=1, log_fn=logs.append, device="cpu")
    assert tr2.step == 4 and logs == ["[trainer] resumed from step 4"]
    for (k, a), (_, b) in zip(ckpt.leaves(tr2.state), ckpt.leaves(tr.state)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b), k
    _recorded(tr2, losses).fit(gen)
    assert tr2.step == 6 and len(losses) == 6
    assert logs[1:] == [f"[trainer] step {s} loss {losses[s - 1]:.4f}"
                        for s in (5, 6)]
    # uninterrupted, over the batches the two trainers stepped on
    stepped = seen[:4] + seen[5:7]
    once_losses = []
    once = _recorded(Trainer(model, tc, TrainerConfig(max_steps=6,
                                                      log_every=0),
                             seed=0, log_fn=lambda *_: None, device="cpu"),
                     once_losses)
    once.fit(iter(stepped))
    assert once_losses == losses
    for (k, a), (_, b) in zip(ckpt.leaves(tr2.state),
                              ckpt.leaves(once.state)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b), k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_launcher_trains_qwen2_smoke_on_cpu(tmp_path, capsys, arch):
    trainer, metrics = launch_train.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
         "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert trainer.step == 4 and np.isfinite(metrics["loss"])
    assert ckpt.latest_step(str(tmp_path)) == 4
    out = capsys.readouterr().out
    assert "[train] done at step 4" in out
    assert trainer.tc.schedule == "paper_steps" and trainer.tc.total_steps == 4


@pytest.mark.parametrize("arch,error", [("whisper-tiny", AttributeError),
                                        ("internvl2-26b", ValueError)])
def test_launcher_refuses_frontend_arches_where_the_reference_fails(
        monkeypatch, arch, error):
    """ROADMAP C.6: the reference's launcher builds token batches only, and
    its whisper and internvl2 losses fail without frames or patches; the
    port's launcher refuses them and names ``Trainer``."""
    from repro.launch import train as jlaunch_train
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke",
                                      "--steps", "2", "--batch", "2",
                                      "--seq", "16"])
    with pytest.raises(error):
        jlaunch_train.main()
    with pytest.raises(NotImplementedError, match="Trainer"):
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2"])
