"""``fsdp_tp_seq``'s sequence split against the reference's GSPMD runs, and
the attention mask's ``q_offset`` / ``kv_start`` against the reference's
``layers.blockwise_attention``.

Without ranks:

* ``ops.attention`` (the kernel's plain version on the CPU) at
  ``q_offset`` and ``kv_start`` meets ``blockwise_attention`` with the same
  arguments: causal, windowed, non-causal, GQA, Tq < Tk, hd 16 and 64,
  fp32, within 2e-5; M query blocks at their offsets over the whole keys,
  put back together, are the whole sequence's result; and
  ``ref.flash_attention_bwd_tiled_ref`` (the backward kernel's route step
  by step) at those settings meets autograd through the plain version.

Four gloo ranks on ("data", "model") = (2, 2) and (1, 4), in one spawn,
against the reference on four forced CPU devices (two processes a mesh),
from the port's initial parameters, under ``fsdp_tp_seq`` for fp32 copies
of four smoke configs: qwen2's,
gemma3's (five windowed layers of six), dbrx's on its ``a2a`` route and
internvl2's (8 patches before 16 tokens: at (1, 4) rank 0's block is all
patches):

* two ``make_sharded_train_step`` steps (losses and gradient norms), then
  the loss and every leaf's gradient at the parameters they leave
  (``step.grads``, gathered whole) meet the reference's steps and its
  ``jax.value_and_grad`` of ``loss_fn``, within 1e-4 relative (the VLM's
  loss and gradients at its initial parameters, without steps);
* the forward's hidden states and the meshed engine's prefill logits and
  cache (``ServeEngine(mesh=, policy="fsdp_tp_seq")``, each rank's block
  gathered whole) meet the reference's;
* each rank's layers run on its T / model positions, and for the dense
  configs its forward's FLOPs (``FlopCounterMode``) lie within 10% of the
  split's analytic count (``dryrun.split_forward_flops`` per token, this
  rank's rows and positions).

On one forced rank (every collective over axes of one rank, as the card
runs it) the split is one block at offset 0: two steps are the unmeshed
steps to the bit, and so are two steps of ``Trainer(mesh=,
policy="fsdp_tp_seq")``.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
POLICY = "fsdp_tp_seq"
MODELS = {"qwen2": ("qwen2-1.5b", {}), "gemma3": ("gemma3-4b", {}),
          "moe": ("dbrx-132b", dict(moe_route="a2a")),
          "vlm": ("internvl2-26b", {})}
DENSE = ("qwen2", "gemma3")
# the models each reference process takes
GROUPS = (("qwen2", "moe"), ("gemma3", "vlm"))
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, T = 8, 16             # the training batch (tokens; a VLM's patches more)
STEPS = {"qwen2": 2, "gemma3": 2, "moe": 2, "vlm": 0}
SB, S = 4, 32            # serving: rows, cache length
RTOL, ATOL = 1e-4, 1e-6
CASES = list(itertools.product(MESHES, MODELS))
IDS = [".".join(c) for c in CASES]
# (B, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start)
MASK_CASES = [(2, 4, 2, 16, 64, 16, True, 0, 48, 0),
              (1, 4, 1, 32, 96, 64, True, 0, 32, 0),
              (2, 4, 4, 24, 40, 16, True, 16, 16, 16),
              (1, 2, 1, 32, 40, 64, True, 8, 8, 8),
              (2, 4, 2, 16, 48, 16, False, 0, 0, 8),
              (1, 6, 2, 20, 30, 64, True, 0, 7, 3),
              (2, 4, 2, 33, 70, 16, True, 24, 37, 5)]
MASK_TOL = 2e-5

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
models, policy, steps, (B, T, SB, S) = %r
mname, shape = sys.argv[3], tuple(int(n) for n in sys.argv[4].split("x"))
mine = sys.argv[5].split(",")
mesh = make_mesh(shape, ("data", "model"), axis_types=True)
out = {}

def nest(flat):
    tree = {}
    for path, a in flat.items():
        *outer, leaf = path.split(".")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return tree

def flat(tree, prefix=""):
    for k in sorted(tree):
        path = prefix + "." + k if prefix else k
        if isinstance(tree[k], dict):
            yield from flat(tree[k], path)
        else:
            yield path, tree[k]

for name, (arch, kw) in models.items():
    if name not in mine:
        continue
    tag = mname + "." + name
    cfg = get_smoke(arch).replace(dtype="float32", sharding=policy, **kw)
    model = get_model(cfg)
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    batch = {k[len(name) + 1:]: jnp.asarray(v) for k, v in data.items()
             if k.startswith(name + ".") and not k.startswith(name + ".req")}
    req = {k[len(name) + 5:]: jnp.asarray(v) for k, v in data.items()
           if k.startswith(name + ".req.")}
    bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh, policy)
    params0 = {k[len(name) + 3:]: v for k, v in data.items()
               if k.startswith("p." + name + ".")}
    params = nest(params0)
    state = {"params": params, "step": jnp.zeros((), jnp.int32),
             "opt": opt.init_slots(jax.tree.leaves(params), tc)}
    if steps[name]:
        step, _, _ = make_sharded_train_step(model, tc, mesh, policy, bp)
    for i in range(steps[name]):
        state, m = step(state, batch)
        out[tag + ".loss%%d" %% i] = np.asarray(m["loss"])
        out[tag + ".gnorm%%d" %% i] = np.asarray(m["grad_norm"])
    _, ps = state_pspecs(model, tc, mesh, policy)
    shardings = (shd.tree_named(mesh, ps["params"]),
                 {k: shd.named(mesh, v) for k, v in bp.items()})
    with mesh:
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(model, p, b, mesh=mesh)),
            in_shardings=shardings)
        loss, grads = fn(state["params"], batch)
        out[tag + ".loss"] = np.asarray(loss)
        for path, g in flat(grads):
            out[tag + ".grad." + path] = np.asarray(g)
        fwd = jax.jit(lambda p, b: model.forward(p, b, mesh=mesh),
                      in_shardings=shardings)
        out[tag + ".hidden"] = np.asarray(fwd(nest(params0), batch))
        eng = ServeEngine(model, nest(params0), S, SB, mesh=mesh,
                          policy=policy)
        logits, cache, _ = eng.prefill(req)
        out[tag + ".prefill"] = np.asarray(logits)
        out[tag + ".cache.k"] = np.asarray(cache["k"])
        out[tag + ".cache.v"] = np.asarray(cache["v"])
np.savez(sys.argv[2], **out)
""" % ((MODELS, POLICY, STEPS, (B, T, SB, S)),)


def _config(name):
    from repro_torch.configs import get_smoke
    arch, kw = MODELS[name]
    return get_smoke(arch).replace(dtype="float32", sharding=POLICY, **kw)


def _seq_rank(rank, world, data, params):
    """Every four-rank case: the split's steps, loss and gradients, its
    forward's hidden states, positions and FLOPs, and the meshed engine's
    prefill; each case's results on rank 0 (positions and counts on every
    rank)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import split_forward_flops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train_loop import (batch_rows, init_train_state,
                                                 loss_fn,
                                                 make_sharded_train_step)
    meshes = {k: make_mesh(v, ("data", "model"), "cpu")
              for k, v in MESHES.items()}
    positions = []
    plain_block = tf._block

    def recording_block(cfg, p, x, **kw):
        positions.append(x.shape[1])
        return plain_block(cfg, p, x, **kw)

    tf._block = recording_block
    out = {}
    for mname, name in CASES:
        tag = f"{mname}.{name}"
        mesh = meshes[mname]
        cfg = _config(name)
        model = get_model(cfg)
        p = {k: v.float() for k, v in params[name].items()}
        batch = {k[len(name) + 1:]: torch.as_tensor(v)
                 for k, v in data.items() if k.startswith(name + ".")
                 and not k.startswith(name + ".req")}
        req = {k[len(name) + 5:]: torch.as_tensor(v)
               for k, v in data.items() if k.startswith(name + ".req.")}
        bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh, POLICY)
        tc = TrainConfig(learning_rate=1e-2, schedule="constant")
        step, _, sh = make_sharded_train_step(model, tc, mesh, POLICY, bp)
        state0 = shd.shard_tree(init_train_state(model, tc, p), sh)
        rows = {k: v[shd.slices(v.shape, bp[k], mesh)]
                for k, v in batch.items()}
        view = shd.MeshView(mesh, rows=batch_rows(bp), policy=POLICY)
        # the loss's forward: positions and FLOPs
        positions.clear()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            loss_fn(model, state0["params"], rows, mesh=view)
        out[tag + ".positions"] = sorted(set(positions))
        total = T + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        out[tag + ".total"] = total
        if name in DENSE:
            layers, head = split_forward_flops(cfg, T, view.sizes())
            tokens = rows["tokens"].shape[0] * T // mesh.size(1)
            out[tag + ".flops"] = (fc.get_total_flops(),
                                   tokens * (layers + head))
        with torch.no_grad():
            hidden = model.forward(state0["params"], rows, mesh=view)
            hidden = shd.gather(hidden, (view.rows or None,), view)
        state, losses = state0, []
        for _ in range(STEPS[name]):
            state, m = step(state, rows)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        loss, grads = step.grads(state, rows)
        specs = {k: s.spec for k, s in sh["params"].items()}
        with torch.no_grad():
            whole = {k: shd.gather(g, specs[k], mesh)
                     for k, g in grads.items()}
        eng = ServeEngine(model, p, S, SB, device="cpu", mesh=mesh,
                          policy=POLICY)
        logits, cache, _ = eng.prefill(req)
        srows = shd._axes(shd.logical_to_pspec((SB,), ("batch",), mesh,
                                               POLICY)[0])
        sview = shd.MeshView(mesh, rows=srows, policy=POLICY)
        split = tf.cache_split(sview, S, cfg.num_kv_heads)
        spec = (None, srows or None, split.axes or None, split.kv or None,
                None)
        with torch.no_grad():
            cache = {k: shd.gather(cache[k], spec, sview) for k in "kv"}
        eng.close()
        if rank == 0:
            out[tag + ".steps"] = losses
            out[tag + ".loss"] = float(loss)
            out[tag + ".grads"] = {k: v.numpy() for k, v in whole.items()}
            out[tag + ".hidden"] = hidden.numpy()
            out[tag + ".prefill"] = logits.numpy()
            out[tag + ".cache"] = {k: v.numpy() for k, v in cache.items()}
    tf._block = plain_block
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.registry import get_model
    tmp = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    data, params = {}, {}
    for name in MODELS:
        cfg = _config(name)
        params[name] = {k: p.float() for k, p in
                        get_model(cfg).init(0, device="cpu").items()}
        data.update({f"p.{name}.{k}": p.numpy()
                     for k, p in params[name].items()})
        v = cfg.vocab_size
        data[name + ".tokens"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[name + ".labels"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[name + ".req.tokens"] = rng.integers(0, v, (SB, T)).astype(
            np.int32)
        if cfg.family == "vlm":
            patches = (cfg.frontend_tokens, cfg.d_model)
            data[name + ".patch_embeds"] = rng.standard_normal(
                (B,) + patches).astype(np.float32)
            data[name + ".req.patch_embeds"] = rng.standard_normal(
                (SB,) + patches).astype(np.float32)
    np.savez(tmp / "in.npz", **data)
    # the reference's compiles are most of the time: two processes a mesh
    jobs = list(itertools.product(MESHES, GROUPS))
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / f"out.{i}.npz"), mname,
         "x".join(map(str, MESHES[mname])), ",".join(group)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (mname, group) in enumerate(jobs)]
    try:
        got = run_ranks(_seq_rank, 4, "cpu", args=(data, params), threads=1,
                        timeout=300)
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    want = {}
    for i, (ref, err) in enumerate(zip(refs, errs)):
        assert ref.returncode == 0, err[-3000:]
        want.update(np.load(tmp / f"out.{i}.npz"))
    return got, want


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1.0),
                               err_msg=msg)


@pytest.mark.parametrize("case", IDS)
def test_steps_loss_and_gradients_meet_the_reference(ranks, case):
    got, want = ranks
    out = got[0]
    for i, (loss, gnorm) in enumerate(out[case + ".steps"]):
        np.testing.assert_allclose(loss, want[f"{case}.loss{i}"], rtol=RTOL,
                                   err_msg=f"step {i + 1} loss")
        np.testing.assert_allclose(gnorm, want[f"{case}.gnorm{i}"],
                                   rtol=RTOL, err_msg=f"step {i + 1} norm")
    np.testing.assert_allclose(out[case + ".loss"], want[case + ".loss"],
                               rtol=RTOL)
    grads = out[case + ".grads"]
    assert set(grads) == {k[len(case) + 6:] for k in want
                          if k.startswith(case + ".grad.")}
    for k, g in grads.items():
        _close(g, want[f"{case}.grad.{k}"], k)


@pytest.mark.parametrize("case", IDS)
def test_hidden_states_and_prefill_meet_the_reference(ranks, case):
    got, want = ranks
    out = got[0]
    _close(out[case + ".hidden"], want[case + ".hidden"], "hidden")
    _close(out[case + ".prefill"], want[case + ".prefill"], "prefill")
    for k in "kv":
        _close(out[case + ".cache"][k], want[f"{case}.cache.{k}"],
               f"cache {k}")


@pytest.mark.parametrize("case", IDS)
def test_each_rank_computes_its_block_of_positions(ranks, case):
    got, _ = ranks
    model = MESHES[case.split(".")[0]][1]
    for out in got:
        assert out[case + ".positions"] == [out[case + ".total"] // model]


@pytest.mark.parametrize("case", [c for c in IDS
                                  if c.split(".")[1] in DENSE])
def test_forward_flops_are_the_splits(ranks, case):
    got, _ = ranks
    for r, out in enumerate(got):
        counted, analytic = out[case + ".flops"]
        assert abs(counted - analytic) <= 0.1 * analytic, (r, counted,
                                                           analytic)


@pytest.mark.parametrize("case", MASK_CASES,
                         ids=["-".join(map(str, c)) for c in MASK_CASES])
def test_attention_at_an_offset_meets_blockwise_attention(case):
    import jax.numpy as jnp
    from repro.models import layers as jl
    from repro_torch.kernels import ops
    B_, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((B_, Tq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B_, Tk, Hk, hd)).astype(np.float32)
            for _ in "kv")
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_start=kv_start, kv_chunk=16)
    want = np.asarray(jl.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    got = ops.attention(*(torch.as_tensor(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=MASK_TOL, rtol=0)


@pytest.mark.parametrize("blocks", [2, 4])
def test_query_blocks_at_their_offsets_are_the_whole_sequence(blocks):
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(blocks)
    B_, Tn, H, Hk, hd = 2, 48, 4, 2, 16
    q = torch.randn(B_, Tn, H, hd, generator=g)
    k, v = (torch.randn(B_, Tn, Hk, hd, generator=g) for _ in "kv")
    for window in (0, 10):
        whole = ops.attention(q, k, v, causal=True, window=window,
                              kv_chunk=16)
        n = Tn // blocks
        parts = [ops.attention(q[:, i * n:(i + 1) * n], k, v, causal=True,
                               window=window, q_offset=i * n, kv_chunk=16)
                 for i in range(blocks)]
        torch.testing.assert_close(torch.cat(parts, dim=1), whole,
                                   atol=MASK_TOL, rtol=0)


@pytest.mark.parametrize("case", MASK_CASES[:4],
                         ids=["-".join(map(str, c)) for c in MASK_CASES[:4]])
def test_tiled_backward_at_an_offset_meets_autograd(case):
    """The backward kernel's route step by step at ``q_offset`` and
    ``kv_start`` (fp32: nothing rounds) against autograd through the plain
    version, whose log-sum-exp it takes from the forward's definition;
    keys below ``kv_start`` get zero gradients."""
    from repro_torch.kernels import ref
    B_, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    q = torch.randn(B_, H, Tq, hd, generator=g, requires_grad=True)
    k, v = (torch.randn(B_, Hk, Tk, hd, generator=g, requires_grad=True)
            for _ in "kv")
    dout = torch.randn(B_, H, Tq, hd, generator=g)
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                kv_start=kv_start)
    out = ref.flash_attention_ref(q, k, v, **mask)
    want = torch.autograd.grad(out, (q, k, v), dout)
    G = H // Hk
    s = torch.einsum("bhqd,bhkd->bhqk", q.detach() * hd ** -0.5,
                     k.detach().repeat_interleave(G, dim=1))
    vis = torch.zeros(Tq, Tk, dtype=torch.bool)
    for i in range(Tq):
        for j in range(Tk):
            qp = q_offset + i
            vis[i, j] = (j >= kv_start and (not causal or qp >= j)
                         and (window == 0 or qp - j < window))
    lse = torch.logsumexp(s.masked_fill(~vis, -1e30), dim=-1)
    got = ref.flash_attention_bwd_tiled_ref(
        q.detach(), k.detach(), v.detach(), out.detach(), dout, lse, **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
    assert not got[1][:, :, :kv_start].any() and \
        not got[2][:, :, :kv_start].any()


def _one_rank(rank, world):
    """qwen2's smoke config under ``fsdp_tp_seq`` on a forced one-rank
    mesh against the unmeshed step: two steps' losses and norms, the
    final params, the K / V gathers; and ``Trainer`` on the mesh."""
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
    from repro_torch.training.trainer import Trainer, TrainerConfig
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    model = get_model(get_smoke("qwen2-1.5b").replace(sharding=POLICY))
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
                              mesh, POLICY)
            step, _, sh = make_sharded_train_step(model, tc, mesh, POLICY,
                                                  bp, force=True)
            state = shd.shard_tree(init_train_state(model, tc, params), sh)
        gathers = []
        plain_all_gather = C.all_gather

        def counting_all_gather(x, dim, axis):
            gathers.append((x.ndim, dim))
            return plain_all_gather(x, dim, axis)
        C.all_gather = counting_all_gather
        try:
            for _ in range(2):
                state, m = step(state, b)
                out.setdefault(name, []).append(
                    (float(m["loss"]), float(m["grad_norm"])))
        finally:
            C.all_gather = plain_all_gather
        # K and V (B, T, Hk, hd) gathered along the sequence
        out[name + ".seq_gathers"] = gathers.count((4, 1))
        out[name + ".params"] = shd.full_tree(state["params"]) \
            if name == "forced" else state["params"]
    trainer = Trainer(model, tc, TrainerConfig(max_steps=2, log_every=0),
                      mesh=mesh, policy=POLICY, batch_pspecs=bp,
                      device="cpu", params=params, force=True,
                      log_fn=lambda m: None)
    trainer.fit([b, b])
    out["trainer.params"] = shd.full_tree(trainer.state["params"])
    return out


def test_one_forced_rank_is_the_unmeshed_step_to_the_bit():
    from repro_torch.launch.mesh import run_ranks
    out, = run_ranks(_one_rank, 1, "cpu", threads=1, timeout=120)
    assert out["forced"] == out["plain"]
    for k, v in out["plain.params"].items():
        assert torch.equal(out["forced.params"][k], v), k
        assert torch.equal(out["trainer.params"][k], v), k
    # K and V gathered over the axis of one rank at each of the 3 layers
    # of both steps
    assert out["plain.seq_gathers"] == 0
    assert out["forced.seq_gathers"] == 2 * 2 * 3
