"""Tensor-parallel and sequence-split compute for the Mamba2 mixer,
zamba2's Mamba layers and whisper's encoder-decoder against the
reference's GSPMD runs.

Four gloo ranks on ("data", "model") = (2, 2) and (1, 4), in one spawn,
against the reference on four forced CPU devices, under ``tp``,
``fsdp_tp`` and ``fsdp_tp_seq``, for fp32 variants of three smoke configs:
mamba2's (8 SSM heads, split over 2 and 4), zamba2's, and whisper's with 4
heads (its 3 do not split):

* the loss and every leaf's gradient (``step.grads`` of
  ``make_sharded_train_step``, gathered whole) meet the reference's
  ``jax.value_and_grad`` of its ``loss_fn`` under the same shardings, the
  prefill's logits and three decode steps' logits (fixed tokens) meet the
  reference's ``ServeEngine(mesh=, policy=)``, all within 1e-4 relative;
* per rank, ``FlopCounterMode``'s count of the loss's forward lies within
  10% of ``dryrun.split_forward_flops`` (the mixer's projections and SSD
  on the rank's heads, B and C whole; whisper's heads, MLP columns and
  vocabulary over "model");
* no all-gather runs over "model" in the loss and its gradients (under
  ``tp`` and ``fsdp_tp``: ``fsdp_tp_seq`` stores every "model" dim);
* each rank's ``ssm`` / ``conv`` / ``k`` / ``v`` / ``xk`` / ``xv`` cache
  has the reference's split shape (``sharding.cache_pspec`` of its
  logical axes: under ``fsdp_tp_seq`` the SSM heads whole, the conv over
  d_inner, the cross-attention's frames over "model").

Under ``fsdp_tp_seq`` the sequence splits over "model"
(``transformer.seq_split``): two ``make_sharded_train_step`` steps (their
losses and gradient norms, and the loss at the params they leave, meet
the reference's steps), the forward's hidden states meet the reference's,
and each rank's Mamba2 blocks, shared attention block and whisper's
encoder and decoder layers run on T / model positions (the frames too:
16 divide over 2 and 4 ranks).  One forced rank runs two mamba2 ``fsdp_tp_seq``
steps, the unmeshed steps to the bit.  Without ranks, the SSD scan's
incoming state: ``ops.ssd(h0=)`` (the kernel's plain version on the CPU)
meets the reference's ``ssd_chunked(h0=)``, blocks chained through ``h0``
are the whole sequence, and ``h0``'s gradient through the plain version
meets ``jax.grad``'s.

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
POLICIES = ("tp", "fsdp_tp", "fsdp_tp_seq")
# the policies that split the sequence over "model"
SEQ = ("fsdp_tp_seq",)
B, T = 8, 16            # the training batch
SB, S, GEN = 4, 24, 3   # serving: rows, cache length, decode steps
ODD = 22                # the repair's cache length: 22 % 4 != 0
RTOL, ATOL = 1e-4, 1e-6
CASES = list(itertools.product(MESHES, POLICIES, MODELS))
IDS = [".".join(c) for c in CASES]
SEQ_IDS = [i for i in IDS if i.split(".")[1] in SEQ]
TP_IDS = [i for i in IDS if i.split(".")[1] not in SEQ]
STEPS = 2               # the sequence split's steps before its gradients

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
from repro.training import optimizer as opt
from repro.training.train_loop import (loss_fn, make_sharded_train_step,
                                       state_pspecs)
data = np.load(sys.argv[1])
models, repair, meshes, policies, seq, (B, T, SB, S, GEN, ODD, STEPS) = %r
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
            shardings = (shd.tree_named(mesh, ps["params"]),
                         {k: shd.named(mesh, v) for k, v in bp.items()})
            if policy in seq:
                # the split's steps (on a copy: the step donates its
                # state) and the loss and gradients at the params they
                # leave; the hidden states at the initial params
                tc = TrainConfig(learning_rate=1e-2, schedule="constant")
                state = {"params": jax.tree.map(jnp.copy, params),
                         "step": jnp.zeros((), jnp.int32),
                         "opt": opt.init_slots(jax.tree.leaves(params), tc)}
                step, _, _ = make_sharded_train_step(model, tc, mesh, policy,
                                                     bp)
                for i in range(STEPS):
                    state, m = step(state, batch)
                    out[tag + ".loss%%d" %% i] = np.asarray(m["loss"])
                    out[tag + ".gnorm%%d" %% i] = np.asarray(m["grad_norm"])
                with mesh:
                    loss, grads = jax.jit(jax.value_and_grad(
                        lambda p, b: loss_fn(model, p, b, mesh=mesh)),
                        in_shardings=shardings)(state["params"], batch)
                    out[tag + ".loss_after"] = np.asarray(loss)
                    for path, g in flat(grads):
                        out[tag + ".grad_after." + path] = np.asarray(g)
                    fwd = jax.jit(lambda p, b: model.forward(p, b, mesh=mesh),
                                  in_shardings=shardings)
                    out[tag + ".hidden"] = np.asarray(fwd(params, batch))
            with mesh:
                fn = jax.jit(jax.value_and_grad(
                    lambda p, b: loss_fn(model, p, b, mesh=mesh)),
                    in_shardings=shardings)
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
        SEQ, (B, T, SB, S, GEN, ODD, STEPS)),)


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


def _recording(mod, name, seen):
    """Wrap ``mod.<name>`` (a layer function taking x (B, T, D) third) so
    that each call adds its T to ``seen``; returns the plain function."""
    plain = getattr(mod, name)

    def wrapped(cfg, p, x, *args, **kw):
        seen.append(x.shape[1])
        return plain(cfg, p, x, *args, **kw)
    setattr(mod, name, wrapped)
    return plain


def _tp_rank(rank, world, data, params):
    """Every four-rank case: the sharded loss and gradients, the forward's
    FLOPs and all-gathers, the meshed engine's prefill, decode and cache,
    and the repair's; under the sequence split also its steps, hidden
    states and each layer's positions; results on rank 0 (the counts,
    positions and shapes on every rank)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import seq_ways, split_forward_flops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec, mamba2
    from repro_torch.models import transformer as tf
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

    positions = []
    layers = ((mamba2, "mamba_block_with_state"), (tf, "_block"),
              (encdec, "_enc_layer"), (encdec, "_dec_layer"))

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
        view = shd.MeshView(mesh, rows=batch_rows(bp), policy=policy)
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
        positions.clear()
        plain = [_recording(m, f, positions) for m, f in layers]
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                loss_fn(model, state["params"], rows, mesh=view)
        finally:
            for (m, f), fn in zip(layers, plain):
                setattr(m, f, fn)
        out[tag + ".positions"] = sorted(set(positions))
        per_token, head = split_forward_flops(cfg, T, view.sizes())
        tokens = rows["tokens"].numel() // seq_ways(cfg, T, view.sizes())
        out[tag + ".flops"] = (fc.get_total_flops(),
                               tokens * (per_token + head))
        if policy in SEQ:
            with torch.no_grad():
                hidden = model.forward(state["params"], rows, mesh=view)
                out[tag + ".hidden"] = shd.gather(
                    hidden, (view.rows or None,), view).numpy()
            losses = []
            for _ in range(STEPS):
                state, m = step(state, rows)
                losses.append((float(m["loss"]), float(m["grad_norm"])))
            out[tag + ".steps"] = losses
            loss_after, after = step.grads(state, rows)
            out[tag + ".loss_after"] = float(loss_after)
            with torch.no_grad():
                after = {k: shd.gather(g, specs[k], mesh).numpy()
                         for k, g in after.items()}
            if rank == 0:
                out[tag + ".grads_after"] = after
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


def _plain_steps(data, params):
    """The unmeshed port's gradients after ``STEPS`` steps of the split's
    training (the same params, batch and optimizer), per model: how far
    the port's own arithmetic carries its gradients from the reference's
    through two Adam steps, with no mesh."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import (init_train_state, loss_fn,
                                                 make_train_step)
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    out = {}
    for name in MODELS:
        model = get_model(_cfg(name, SEQ[0]))
        batch = _inputs(data, name, True)
        state = init_train_state(model, tc, {k: v.float().clone()
                                             for k, v in params[name].items()})
        step = make_train_step(model, tc)
        for _ in range(STEPS):
            state, _ = step(state, batch)
        p = {k: v.detach().requires_grad_(True)
             for k, v in state["params"].items()}
        gs = torch.autograd.grad(loss_fn(model, p, batch), list(p.values()))
        out.update({f"plain.{name}.grad_after.{k}": g.numpy()
                    for k, g in zip(p, gs)})
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
        plain = _plain_steps(data, params)
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    want = {}
    for ref, err, name in zip(refs, errs, MODELS):
        assert ref.returncode == 0, err[-3000:]
        want.update(np.load(tmp / f"out.{name}.npz"))
    # beside the reference's results, the unmeshed port's drift from them
    want.update(plain)
    return got, want


# the split's gradients after its steps may part from the reference's by
# this many times the unmeshed port's own drift (on top of the gradients'
# bound): Adam's first steps move an entry whose gradient is near zero by
# the whole learning rate either way, so where rounding flips such a sign
# the params, and the gradients at them, part by more than rounding
DRIFT = 4


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_meet_the_reference(ranks, case):
    """The loss and every leaf's gradient; under the sequence split also
    two steps from the same params, whose losses and gradient norms, and
    the loss and every leaf's gradient at the params they leave, meet the
    reference's.  After the steps each leaf is held to the gradients'
    bound plus ``DRIFT`` times the largest difference between the
    unmeshed port's gradients after the same steps and the reference's,
    since the port's arithmetic alone carries them apart."""
    got, want = ranks
    for i, (loss, gnorm) in enumerate(got[0].get(case + ".steps", ())):
        np.testing.assert_allclose(loss, want[f"{case}.loss{i}"], rtol=RTOL,
                                   err_msg=f"step {i + 1} loss")
        np.testing.assert_allclose(gnorm, want[f"{case}.gnorm{i}"],
                                   rtol=RTOL, err_msg=f"step {i + 1} norm")
    if case in SEQ_IDS:
        assert len(got[0][case + ".steps"]) == STEPS
        np.testing.assert_allclose(got[0][case + ".loss_after"],
                                   want[case + ".loss_after"], rtol=RTOL,
                                   err_msg="the loss after the steps")
        name = case.split(".")[2]
        after = got[0][case + ".grads_after"]
        assert set(after) == {k[len(case) + 12:] for k in want
                              if k.startswith(case + ".grad_after.")}
        for k, g in after.items():
            w = want[f"{case}.grad_after.{k}"]
            drift = np.abs(want[f"plain.{name}.grad_after.{k}"] - w).max()
            np.testing.assert_allclose(
                g, w, rtol=RTOL,
                atol=ATOL * max(np.abs(w).max(), 1.0) + DRIFT * drift,
                err_msg=f"{k} after the steps")
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


@pytest.mark.parametrize("case", SEQ_IDS)
def test_hidden_states_meet_the_reference(ranks, case):
    got, want = ranks
    w = want[case + ".hidden"]
    np.testing.assert_allclose(got[0][case + ".hidden"], w, rtol=RTOL,
                               atol=ATOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("case", IDS)
def test_each_rank_computes_its_block_of_positions(ranks, case):
    """Every Mamba2 block, shared attention block and whisper encoder and
    decoder layer of the loss's forward runs on T / model positions under
    the sequence split (whisper's 16 frames divide "model" too), on all T
    otherwise."""
    got, _ = ranks
    mname, policy, _ = case.split(".")
    want = T // MESHES[mname][1] if policy in SEQ else T
    for out in got:
        assert out[case + ".positions"] == [want]


@pytest.mark.parametrize("case", TP_IDS)
def test_no_leaf_is_gathered_over_a_tensor_parallel_dim(ranks, case):
    got, _ = ranks
    for out in got:
        assert out[case + ".gathers_over_model"] == 0
    # fsdp_tp at (2, 2) stores d_model over "data": those dims are gathered
    assert (got[0][case + ".gathers"] > 0) == case.startswith("2x2.fsdp_tp")


# the reference's logical axes of each cache leaf (its models'
# ``cache_specs``)
_KV = ("layers", "cache_batch", "cache_seq", "kv", None)
_SSM = {"ssm": ("layers", "cache_batch", "ssm_heads", None, "state"),
        "conv": ("layers", "cache_batch", "conv", "mlp")}
_LOGICAL = {
    "ssm": _SSM,
    "hybrid": {"attn.k": _KV, "attn.v": _KV,
               **{"ssm." + k: v[:1] + (None,) + v[1:]
                  for k, v in _SSM.items()}},
    "audio": {"k": _KV, "v": _KV,
              "xk": ("layers", "cache_batch", "seq", "kv", None),
              "xv": ("layers", "cache_batch", "seq", "kv", None)}}


def _cache_shapes(cfg, policy, data, model, seq_len):
    """Each cache leaf's block for ``SB`` rows over (data, model) ranks as
    ``sharding.cache_pspec`` splits it over the leaf's logical axes under
    ``policy``: the rows over the policy's batch axes, every other dim by
    the reference's greedy rule (the sequence over "model"; under ``tp``
    and ``fsdp_tp`` the SSM heads and the cross-attention's kv heads over
    "model", under ``fsdp_tp_seq`` the SSM heads whole and the
    cross-attention's frames over "model"; the conv's d_inner over "model"
    under all three)."""
    import math
    from repro_torch.distributed import sharding as shd

    class Mesh:   # (data, model) ranks, seen from one of them
        mesh_dim_names = ("data", "model")
        shape = (data, model)

        def get_local_rank(self, name):
            return 0
    sizes = dict(zip(Mesh.mesh_dim_names, Mesh.shape))
    rows = shd._axes(shd.logical_to_pspec((SB,), ("batch",), sizes,
                                          policy)[0])
    view = shd.MeshView(Mesh(), rows=rows, policy=policy)
    L, hd, Hk = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    H, N, K = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_conv_kernel
    na, per = (L // cfg.shared_attn_every, cfg.shared_attn_every) \
        if cfg.family == "hybrid" else (L, 1)
    whole = {"ssm": (L, SB, H, cfg.ssm_head_dim, N),
             "conv": (L, SB, K - 1, cfg.ssm_d_inner),
             "k": (L, SB, seq_len, Hk, hd), "v": (L, SB, seq_len, Hk, hd),
             "xk": (L, SB, cfg.encoder_tokens, Hk, hd),
             "xv": (L, SB, cfg.encoder_tokens, Hk, hd)}
    whole.update({"attn.k": (na, SB, seq_len, Hk, hd),
                  "attn.v": (na, SB, seq_len, Hk, hd),
                  "ssm.ssm": (na, per) + whole["ssm"][1:],
                  "ssm.conv": (na, per) + whole["conv"][1:]})
    out = {}
    for leaf, logical in _LOGICAL[cfg.family].items():
        shape = whole[leaf]
        spec = shd.cache_pspec(view, shape, logical)
        out[leaf] = tuple(n // math.prod(sizes[a] for a in shd._axes(e))
                          for n, e in zip(shape, spec))
    return out


@pytest.mark.parametrize("case", IDS)
def test_each_rank_holds_the_reference_split_of_the_caches(ranks, case):
    got, _ = ranks
    mname, policy, name = case.split(".")
    want = _cache_shapes(_cfg(name, policy), policy, *MESHES[mname], S)
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


# the SSD scan's incoming state: (B, T, H, hd, N, chunk, blocks)
H0_CASES = [(2, 64, 3, 8, 4, 16, 4), (1, 48, 2, 16, 8, 16, 3),
            (2, 40, 4, 8, 4, 8, 2)]


def _close(got, want):
    """Within 1e-4 relative and 1e-6 of the largest value, the bound of
    the gradients above."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


def _ssd_inputs(case):
    """The scan's inputs and an incoming state, fp32 numpy, from a seed."""
    B_, T_, H, hd, N = case[:5]
    rng = np.random.default_rng(sum(case))
    f = np.float32
    return (rng.standard_normal((B_, T_, H, hd)).astype(f),
            (np.abs(rng.standard_normal((B_, T_, H))) * 0.5 + 0.01).astype(f),
            (np.abs(rng.standard_normal(H)) * 0.5 + 0.1).astype(f),
            rng.standard_normal((B_, T_, N)).astype(f),
            rng.standard_normal((B_, T_, N)).astype(f),
            rng.standard_normal((B_, H, hd, N)).astype(f))


@pytest.mark.parametrize("case", H0_CASES,
                         ids=["-".join(map(str, c)) for c in H0_CASES])
def test_ssd_from_an_incoming_state_meets_the_reference(case):
    """``ops.ssd(h0=)`` on the CPU (the kernel's plain version) against the
    reference's ``ssd_chunked(h0=)`` on the same inputs: y and the final
    state; and the sequence cut into chunk-aligned blocks, each scanned
    from the last one's final state, gives the whole sequence's."""
    import jax.numpy as jnp
    import torch
    from repro.models import mamba2 as jm
    from repro_torch.kernels import ops
    *ins, h0 = _ssd_inputs(case)
    chunk, blocks = case[5], case[6]
    wy, wh = jm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk,
                            h0=jnp.asarray(h0))
    t = [torch.as_tensor(a) for a in ins]
    y, h = ops.ssd(*t, chunk=chunk, h0=torch.as_tensor(h0))
    _close(y.numpy(), wy)
    _close(h.numpy(), wh)
    n = t[0].shape[1] // blocks
    hb, ys = torch.as_tensor(h0), []
    for r in range(blocks):
        part = [a if a.ndim == 1 else a[:, r * n:(r + 1) * n] for a in t]
        yb, hb = ops.ssd(*part, chunk=chunk, h0=hb)
        ys.append(yb)
    _close(torch.cat(ys, 1).numpy(), y.numpy())
    _close(hb.numpy(), h.numpy())


@pytest.mark.parametrize("case", H0_CASES,
                         ids=["-".join(map(str, c)) for c in H0_CASES])
def test_incoming_state_gradient_meets_jax_grad(case):
    """The gradient of h0 (and of every input) through the plain version
    against ``jax.grad`` of the reference's ``ssd_chunked`` for the same
    cotangents of y and the final state; the kernel's split of the
    backward (``ref.ssd_scan_bwd_passes_ref(with_dh0=True)``) gives the
    same dh0."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import mamba2 as jm
    from repro_torch.kernels import ops, ref
    *ins, h0 = _ssd_inputs(case)
    chunk = case[5]
    rng = np.random.default_rng(7)
    dy = rng.standard_normal(ins[0].shape).astype(np.float32)
    dh = rng.standard_normal(h0.shape).astype(np.float32)

    def loss(*a):
        y, h = jm.ssd_chunked(*a[:5], chunk, h0=a[5])
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in ins + [h0]))
    t = [torch.as_tensor(a).requires_grad_(True) for a in ins + [h0]]
    y, h = ops.ssd(*t[:5], chunk=chunk, h0=t[5])
    got = torch.autograd.grad((y * torch.as_tensor(dy)).sum()
                              + (h * torch.as_tensor(dh)).sum(), t)
    for name, g, w in zip(("xh", "dt", "A", "Bm", "Cm", "h0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)
    plain = [torch.as_tensor(a) for a in ins]
    _, _, h_in = ref.ssd_scan_passes_ref(*plain, chunk=chunk,
                                         h0=torch.as_tensor(h0))
    split = ref.ssd_scan_bwd_passes_ref(*plain, h_in, torch.as_tensor(dy),
                                        torch.as_tensor(dh), chunk=chunk,
                                        with_dh0=True)
    _close(split[5].numpy(), got[5].numpy())


def _one_rank(rank, world):
    """mamba2's smoke config under ``fsdp_tp_seq`` on a forced one-rank
    mesh against the unmeshed step: two steps' losses and norms and the
    final params, and the gathers of the conv's halo and of the state
    exchange."""
    import torch
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_sharded_train_step,
                                                 make_train_step)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    model = get_model(get_smoke("mamba2-1.3b").replace(sharding="fsdp_tp_seq"))
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, model.cfg.vocab_size, (B, T), generator=g)
         for k in ("tokens", "labels")}
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    out = {}
    for name in ("plain", "forced"):
        if name == "plain":
            step = make_train_step(model, tc)
            state = init_train_state(model, tc, params)
        else:
            bp = input_pspecs(model.cfg, ShapeConfig("t", T, B, "train"),
                              mesh, "fsdp_tp_seq")
            step, _, sh = make_sharded_train_step(model, tc, mesh,
                                                  "fsdp_tp_seq", bp,
                                                  force=True)
            state = shd.shard_tree(init_train_state(model, tc, params), sh)
        gathers = []
        plain_all_gather = C.all_gather

        def counting_all_gather(x, dim, axis):
            gathers.append((x.ndim, dim))
            return plain_all_gather(x, dim, axis)
        C.all_gather = counting_all_gather
        try:
            for _ in range(STEPS):
                state, m = step(state, b)
                out.setdefault(name, []).append(
                    (float(m["loss"]), float(m["grad_norm"])))
        finally:
            C.all_gather = plain_all_gather
        # the halo (B, K-1, d_inner) along dim 1 and the packed states
        # (1, B, H, hd N + 1) along dim 0
        out[name + ".exchanges"] = (gathers.count((3, 1)),
                                    gathers.count((4, 0)))
        out[name + ".params"] = shd.full_tree(state["params"]) \
            if name == "forced" else state["params"]
    return out


def test_one_forced_rank_splits_mamba2_as_the_unmeshed_step_to_the_bit():
    """On one forced rank the split is one block at offset 0: its halo is
    zeros (gathered at every layer) and it runs one scan from zero, with
    no state to exchange, so two steps (the hidden states gathered, the
    loss's shares summed) are the unmeshed steps to the bit."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    out, = run_ranks(_one_rank, 1, "cpu", threads=1, timeout=120)
    assert out["forced"] == out["plain"]
    for k, v in out["plain.params"].items():
        assert torch.equal(out["forced.params"][k], v), k
    layers = 4   # mamba2's smoke config
    assert out["plain.exchanges"] == (0, 0)
    assert out["forced.exchanges"] == (STEPS * layers, 0)
