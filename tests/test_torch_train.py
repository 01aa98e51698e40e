"""LM training on one device (the port's ``training/``: the loss, the
train step, the optimizer and the schedules; the LM token draw) against
the JAX package, on the same numpy inputs and params (carried across by
``models.convert``).  The loader, the straggler monitor, checkpoints,
``Trainer`` and the launcher are ``test_torch_train_launch.py``'s.

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
- tokens: exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.synth import make_lm_tokens as jmake_lm_tokens
from repro.models import layers as JL
from repro.models.registry import get_model as jget_model
from repro.training import optimizer as jopt
from repro.training.schedules import make_schedule as jmake_schedule
from repro.training.train_loop import loss_fn as jloss_fn
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synth import make_lm_tokens
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule
from repro_torch.training.train_loop import (init_train_state, loss_fn,
                                             make_train_step)
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


# gemma3-4b: the only shipped config with a sliding window (local layers at
# window 8 over 12 tokens, the sixth layer global) and a tied head (its
# embedding's gradient sums the lookup's and the head's)
LOSS_ARCHS = [("qwen2-1.5b", 0), ("qwen2-1.5b", 64), ("internvl2-26b", 0),
              ("mamba2-1.3b", 0), ("whisper-tiny", 0), ("zamba2-2.7b", 0),
              ("gemma3-4b", 0), ("gemma3-4b", 64)]


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
