"""The policy-sharded train step (``train_loop.make_sharded_train_step``)
against the reference's.

* No processes: for every shipped config's state tree, under ``tp``,
  ``fsdp_tp`` and ``fsdp`` on a (2, 2) ("data", "model") mapping, the four
  ranks' blocks (``sharding.slices``) tile every leaf exactly as often as
  it is replicated; at the smoke sizes the blocks of real tensors put
  back together are the whole tree.  ``input_pspecs`` and
  ``state_pspecs`` equal the reference's.
* Four gloo ranks on (2, 2), in one spawn, against the reference's
  ``make_sharded_train_step`` on four forced CPU devices: qwen2-1.5b's
  smoke config under ``fsdp_tp`` from the reference's initial parameters
  in fp32, 4 steps: loss and ``grad_norm`` within 1e-4 relative of the
  reference's and of the port's unsharded step; again with int8 first
  moments and the factored second moment (the sharded max and means).
  ``tests/test_moe_gather.py``'s contract (its config, batch and mesh;
  its parameters cast to fp32, as the reference's run here is too): the
  bf16 and int8 expert gathers both learn, int8 tracks bf16 within
  0.15 |a| + 0.05, and each meets the reference's losses within 1e-4
  relative (int8: 5e-3).  (With the parameters left in bf16 the two
  frameworks' forwards part by 8e-5 relative at step 1, before any
  update, and by 2.9e-4 at step 4, as ROADMAP C.7 records for qwen2; in
  fp32 they meet within 1e-6.)  mamba2-1.3b's smoke config
  under ``tp`` (``ssm_heads`` over "model"), and qwen2's with two
  microbatches a step (``grad_accum``, the microbatch dim whole), meet
  their unsharded steps.
* One rank: the meshed step, plain and forced (every collective over the
  policy's axes of one rank, as the card runs it), equals the unmeshed
  step to the bit.
"""
import itertools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
RTOL = 1e-4
B, T = 8, 16
MOE_CFG = dict(name="m", family="moe", num_layers=2, d_model=32, num_heads=4,
               num_kv_heads=2, head_dim=8, d_ff=16, vocab_size=128,
               num_experts=4, experts_per_token=2, sharding="fsdp_tp",
               remat="none", dtype="float32")
MOE_B = 4
FACTORED = dict(moment_dtype="int8", factored_second_moment=True)
POLICIES = ("tp", "fsdp_tp", "fsdp")
MESH = {"data": 2, "model": 2}

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke, input_pspecs
from repro.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro.models.registry import get_model
from repro.training import optimizer as opt
from repro.training.train_loop import (init_train_state,
                                       make_sharded_train_step)
data = np.load(sys.argv[1])
steps, moe_cfg, factored = %r, %r, %r
mesh = make_mesh((2, 2), ("data", "model"), axis_types=True)
out = {}

def run(tag, cfg, tc, batch, f32):
    model = get_model(cfg)
    shape = ShapeConfig("t", seq_len=batch["tokens"].shape[1],
                        global_batch=batch["tokens"].shape[0], kind="train")
    bp = input_pspecs(cfg, shape, mesh, "fsdp_tp")
    step, _, _ = make_sharded_train_step(model, tc, mesh, "fsdp_tp", bp)
    state = init_train_state(model, tc, jax.random.key(0))
    if f32:
        state["params"] = jax.tree.map(lambda a: a.astype(jnp.float32),
                                       state["params"])
        state["opt"] = opt.init_slots(jax.tree.leaves(state["params"]), tc)
    for _ in range(steps):
        state, m = step(state, batch)
        out.setdefault(tag + ".loss", []).append(float(m["loss"]))
        out.setdefault(tag + ".gnorm", []).append(float(m["grad_norm"]))

cfg = get_smoke("qwen2-1.5b").replace(dtype="float32", sharding="fsdp_tp")
b = {k: jnp.asarray(data["qwen2." + k]) for k in ("tokens", "labels")}
run("qwen2", cfg, TrainConfig(learning_rate=1e-2, schedule="constant"),
    b, True)
run("qwen2_factored", cfg, TrainConfig(learning_rate=1e-2,
                                       schedule="constant", **factored),
    b, True)
base = ModelConfig(**moe_cfg)
b = {k: jnp.asarray(data["moe." + k]) for k in ("tokens", "labels")}
for mode in ("bf16", "int8"):
    run("moe_" + mode, base.replace(moe_gather_dtype=mode),
        TrainConfig(learning_rate=1e-2, schedule="constant"), b, True)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""" % (STEPS, MOE_CFG, FACTORED)


def _fake_mesh(sizes):
    """The attributes the reference's rule functions read from a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _coords():
    return [dict(zip(MESH, c)) for c in itertools.product(
        *(range(n) for n in MESH.values()))]


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_specs(v, path))
        else:
            out[path] = tuple(v)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_blocks_tile_every_state_tree(policy):
    """Every rank's block of every leaf of every shipped config's state
    (the specs of ``state_pspecs``): each dim's blocks cut it in equal
    parts, each part held by as many ranks as the leaf is replicated
    over; at the smoke sizes the blocks put back together are the whole
    tensors."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 state_pspecs)
    tc = TrainConfig(**FACTORED)
    world = 4
    for arch in ARCH_IDS:
        model = get_model(get_config(arch))
        ab, specs = state_pspecs(model, tc, MESH, policy)
        leaves = list(zip(ab["params"].values(), specs["params"].values()))
        leaves += [(ab_s[k], sp_s[k]) for ab_s, sp_s in
                   zip(ab["opt"], specs["opt"]) for k in ab_s]
        for (shape, _), spec in leaves:
            held = {}
            for at in _coords():
                blk = shd.slices(shape, spec, MESH, at)
                held[blk] = held.get(blk, 0) + 1
            # each dim cut in equal parts that cover it
            for d, n in enumerate(shape):
                cuts = sorted({(b[d].start, b[d].stop) for b in held})
                assert cuts[0][0] == 0 and cuts[-1][1] == n, (arch, spec)
                assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
                assert len({b - a for a, b in cuts}) == 1, (arch, spec)
            parts = len(held)
            assert world % parts == 0, (arch, shape, spec)
            assert set(held.values()) == {world // parts}, (arch, spec)
        # the smoke state, whole from its blocks
        smoke = get_model(get_smoke(arch))
        state = init_train_state(smoke, tc, smoke.init(0, device="cpu"))
        _, specs = state_pspecs(smoke, tc, MESH, policy)
        pairs = list(zip(state["params"].values(), specs["params"].values()))
        pairs += [(s[k], sp[k]) for s, sp in zip(state["opt"], specs["opt"])
                  for k in s]
        for whole, spec in pairs:
            back = torch.full(whole.shape, float("nan"), dtype=torch.float32)
            for at in _coords():
                idx = shd.slices(whole.shape, spec, MESH, at)
                back[idx] = shd.local_slice(whole, spec, MESH, at).float()
            torch.testing.assert_close(back, whole.float(), rtol=0, atol=0)


def test_input_and_state_pspecs_are_the_references():
    from repro.configs import get_config as jget_config
    from repro.configs import input_pspecs as jinput_pspecs
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.models.registry import get_model as jget_model
    from repro.training.train_loop import state_pspecs as jstate_pspecs
    from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                     input_pspecs, input_specs)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import state_pspecs
    meshes = [{"data": 2, "model": 2}, {"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16}]
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for mesh, policy, shape in itertools.product(meshes, POLICIES,
                                                     SHAPES):
            for accum in (1, 4):
                if accum > 1 and shape.kind != "train":
                    continue
                js = JShape(shape.name, shape.seq_len, shape.global_batch,
                            shape.kind)
                from repro.configs import input_specs as jinput_specs
                want = jinput_specs(jcfg, js, accum)
                got = input_specs(cfg, shape, accum)
                assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in want.items()} == \
                    {k: (sh, str(dt).split(".")[-1])
                     for k, (sh, dt) in got.items()}
                want = jinput_pspecs(jcfg, js, _fake_mesh(mesh), policy,
                                     accum)
                got = input_pspecs(cfg, shape, mesh, policy, accum)
                assert {k: tuple(v) for k, v in want.items()} == \
                    {k: tuple(v) for k, v in got.items()}, (arch, policy)
        for tckw in ({}, FACTORED):
            for mesh, policy in itertools.product(meshes[:2], POLICIES):
                _, want = jstate_pspecs(jget_model(jcfg), JTrain(**tckw),
                                        _fake_mesh(mesh), policy)
                _, got = state_pspecs(get_model(cfg), TrainConfig(**tckw),
                                      mesh, policy)
                assert _flat_specs(want["params"]) == \
                    {k: tuple(v) for k, v in got["params"].items()}
                assert [{k: tuple(v) for k, v in s.items()}
                        for s in want["opt"]] == \
                    [{k: tuple(v) for k, v in s.items()}
                     for s in got["opt"]], (arch, policy, tckw)
                assert tuple(want["step"]) == tuple(got["step"]) == ()


def _run(model, tc, mesh, policy, params, batch, steps=STEPS):
    """``steps`` sharded steps from ``params`` (whole): losses, norms and
    the whole final params."""
    from repro_torch.configs import input_pspecs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_sharded_train_step)
    accum = tc.grad_accum
    lead = batch["tokens"].shape[:-1]   # (B,) or (accum, B / accum)
    shape = ShapeConfig("t", batch["tokens"].shape[-1],
                        int(np.prod(lead)), "train")
    bp = input_pspecs(model.cfg, shape, mesh, policy, accum)
    step, _, sh = make_sharded_train_step(model, tc, mesh, policy, bp)
    state = shd.shard_tree(init_train_state(model, tc, params), sh)
    rows = {k: v[shd.slices(v.shape, bp[k], mesh)] for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, rows)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def _run_plain(model, tc, params, batch, steps=STEPS):
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    step = make_train_step(model, tc)
    state = init_train_state(model, tc, params)
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def _train_rank(rank, world, data, params):
    """Every four-rank case of the file, with the unsharded runs they are
    held to on rank 0."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    qwen2 = get_model(get_smoke("qwen2-1.5b").replace(dtype="float32"))
    p32 = {k: v.float() for k, v in params["qwen2"].items()}
    b = {k: torch.as_tensor(data["qwen2." + k]) for k in ("tokens", "labels")}
    for tag, kw in (("qwen2", {}), ("qwen2_factored", FACTORED)):
        tc = TrainConfig(learning_rate=1e-2, schedule="constant", **kw)
        out[tag] = _run(qwen2, tc, mesh, "fsdp_tp", p32, b)
        if rank == 0:
            out[tag + ".plain"] = _run_plain(qwen2, tc, p32, b)
    # two microbatches a step, the leading microbatch dim whole
    tc = TrainConfig(learning_rate=1e-2, schedule="constant", grad_accum=2)
    micro = {k: v.reshape(2, B // 2, T) for k, v in b.items()}
    out["qwen2_accum"] = _run(qwen2, tc, mesh, "fsdp_tp", p32, micro, 2)
    if rank == 0:
        out["qwen2_accum.plain"] = _run_plain(qwen2, tc, p32, micro, 2)
    base = ModelConfig(**MOE_CFG)
    b = {k: torch.as_tensor(data["moe." + k]) for k in ("tokens", "labels")}
    for mode in ("bf16", "int8"):
        model = get_model(base.replace(moe_gather_dtype=mode))
        out["moe_" + mode] = _run(model, TrainConfig(
            learning_rate=1e-2, schedule="constant"), mesh, "fsdp_tp",
            {k: v.float() for k, v in params["moe"].items()}, b)
    mamba = get_model(get_smoke("mamba2-1.3b").replace(dtype="float32"))
    pm = {k: v.float() for k, v in mamba.init(0, device="cpu").items()}
    b = {k: torch.as_tensor(data["qwen2." + k]) % mamba.cfg.vocab_size
         for k in ("tokens", "labels")}
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    out["mamba2"] = _run(mamba, tc, mesh, "tp", pm, b, 2)
    if rank == 0:
        out["mamba2.plain"] = _run_plain(mamba, tc, pm, b, 2)
    return out


def test_sharded_step_meets_the_reference_on_four_ranks(tmp_path):
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro.configs.base import ModelConfig as JConfig
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import params_from_jax
    rng = np.random.default_rng(0)
    vocab = jget_smoke("qwen2-1.5b").vocab_size
    data = {"qwen2.tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "qwen2.labels": rng.integers(0, vocab, (B, T)).astype(np.int32)}
    rng = np.random.default_rng(0)   # test_moe_gather.py's batch
    data["moe.tokens"] = rng.integers(0, 128, (MOE_B, 16)).astype(np.int32)
    data["moe.labels"] = rng.integers(0, 128, (MOE_B, 16)).astype(np.int32)
    np.savez(tmp_path / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        key = jax.random.key(0)
        params = {
            "qwen2": params_from_jax(jax.tree.map(np.asarray, jget_model(
                jget_smoke("qwen2-1.5b")).init(key)), device="cpu"),
            "moe": params_from_jax(jax.tree.map(np.asarray, jget_model(
                JConfig(**MOE_CFG)).init(key)), device="cpu")}
        ranks = run_ranks(_train_rank, 4, "cpu", args=(data, params),
                          threads=1, timeout=120)
    finally:
        _, err = ref.communicate(timeout=120)
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "out.npz")
    got = ranks[0]
    for r in ranks[1:]:   # loss, grad_norm and lr are the same on every rank
        for k, v in r.items():
            assert v == got[k], k
    for tag in ("qwen2", "qwen2_factored"):
        losses, norms = got[tag]
        np.testing.assert_allclose(losses, want[tag + ".loss"], rtol=RTOL)
        np.testing.assert_allclose(norms, want[tag + ".gnorm"], rtol=RTOL)
        np.testing.assert_allclose(losses, got[tag + ".plain"][0], rtol=RTOL)
        np.testing.assert_allclose(norms, got[tag + ".plain"][1], rtol=RTOL)
    bf16, int8 = got["moe_bf16"][0], got["moe_int8"][0]
    assert all(np.isfinite(bf16)) and all(np.isfinite(int8))
    assert bf16[-1] < bf16[0] and int8[-1] < int8[0], (bf16, int8)
    for a, b in zip(bf16, int8):
        assert abs(a - b) < 0.15 * abs(a) + 0.05, (bf16, int8)
    np.testing.assert_allclose(bf16, want["moe_bf16.loss"], rtol=RTOL)
    np.testing.assert_allclose(int8, want["moe_int8.loss"], rtol=5e-3)
    for tag in ("qwen2_accum", "mamba2"):
        for i in (0, 1):   # losses, norms
            np.testing.assert_allclose(got[tag][i], got[tag + ".plain"][i],
                                       rtol=RTOL, err_msg=tag)


def _one_rank(rank, world):
    """qwen2's smoke config under ``fsdp_tp`` on a one-rank mesh, plain and
    forced, against the unmeshed step: losses, norms and final params."""
    import torch
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_sharded_train_step,
                                                 make_train_step)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    model = get_model(get_smoke("qwen2-1.5b"))
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, model.cfg.vocab_size, (B, T), generator=g)
         for k in ("tokens", "labels")}
    tc = TrainConfig(learning_rate=1e-2, schedule="constant", **FACTORED)
    out = {}
    step = make_train_step(model, tc)
    state = init_train_state(model, tc, params)
    for _ in range(2):
        state, m = step(state, b)
        out.setdefault("plain", []).append(
            (float(m["loss"]), float(m["grad_norm"])))
    out["plain.params"] = {k: v.clone() for k, v in state["params"].items()}
    bp = input_pspecs(model.cfg, ShapeConfig("t", T, B, "train"), mesh,
                      "fsdp_tp")
    for force in (False, True):
        step, _, sh = make_sharded_train_step(model, tc, mesh, "fsdp_tp", bp,
                                              force=force)
        state = shd.shard_tree(init_train_state(model, tc, params), sh)
        for _ in range(2):
            state, m = step(state, b)
            out.setdefault(force, []).append(
                (float(m["loss"]), float(m["grad_norm"])))
        out[f"{force}.params"] = shd.full_tree(state["params"])
        out[f"{force}.forced_axes"] = any(
            e is not None for e in sh["params"]["blocks.attn.wq"].spec)
    return out


def test_one_rank_mesh_is_the_unmeshed_step_to_the_bit():
    import torch
    from repro_torch.launch.mesh import run_ranks
    out, = run_ranks(_one_rank, 1, "cpu", threads=1, timeout=120)
    assert out["True.forced_axes"] and not out["False.forced_axes"]
    for force in (False, True):
        assert out[force] == out["plain"], force
        for k, v in out["plain.params"].items():
            assert torch.equal(out[f"{force}.params"][k], v), (force, k)
