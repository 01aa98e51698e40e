"""``Trainer``, ``ShardedLoader`` and checkpoints over a mesh, against the
reference on its four forced CPU devices.

* Four gloo ranks on a ("data", "model") mesh of (2, 2), in one spawn:
  ``ShardedLoader(mesh=)``'s rows on each rank equal the reference's
  ``device_put_global`` shard on the device at the same mesh position
  (``addressable_shards``), batch for batch; a checkpoint the reference's
  unmeshed ``Trainer`` wrote restores onto the four ranks through the
  meshed ``Trainer`` (``restore(shardings=)``: every leaf the saved bits,
  placed by the state's shardings), and one the port's meshed ``Trainer``
  wrote restores in the reference to the port's bits; the twin of
  ``tests/test_distributed.py``'s elastic re-shard.
* Two gloo ranks on (2, 1): a meshed ``Trainer`` (``fsdp_tp``,
  ``batch_pspecs`` given) trains four steps checkpointing at step 2; a
  second run stops at step 2, a fresh ``Trainer`` resumes there through
  ``restore(shardings=)`` and ends bit-equal to the uninterrupted run.
  ``Trainer(mesh)`` without ``batch_pspecs`` trains through the unsharded
  step (the reference's rule), its losses those of ``Trainer()``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
B, T, N = 8, 16, 32
LOADER_B, SEED = 8, 3

_REF_WRITE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.configs.base import TrainConfig
from repro.data.loader import ShardedLoader
from repro.models.registry import get_model
from repro.training.trainer import Trainer, TrainerConfig
data = np.load(sys.argv[1])
ckpt_dir, loader_b, seed, out_path = sys.argv[2], %d, %d, sys.argv[3]
mesh = make_mesh((2, 2), ("data", "model"), axis_types=True)
out = {}
loader = ShardedLoader({k: data["loader." + k] for k in ("tokens", "frames")},
                       loader_b, mesh=mesh, seed=seed)
for b, batch in enumerate(loader.epoch()):
    for k, arr in batch.items():
        for s in arr.addressable_shards:
            i, j = [int(x[0]) for x in np.nonzero(mesh.devices == s.device)]
            out[f"loader.{b}.{k}.{i}.{j}"] = np.asarray(s.data)
model = get_model(get_smoke("qwen2-1.5b"))
tr = Trainer(model, TrainConfig(learning_rate=1e-2, schedule="constant"),
             TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0,
                           max_steps=2), log_fn=lambda m: None)
tr.fit([{k: jnp.asarray(data["train." + k][i]) for k in ("tokens", "labels")}
        for i in range(2)])
np.savez(out_path, **out)
""" % (LOADER_B, SEED)

_REF_READ = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.configs.base import TrainConfig
from repro.distributed import checkpoint as ckpt
from repro.models.registry import get_model
from repro.training.train_loop import init_train_state
model = get_model(get_smoke("qwen2-1.5b"))
like = init_train_state(model, TrainConfig(), jax.random.key(1))
state, manifest = ckpt.restore(sys.argv[1], int(sys.argv[2]), like)
flat = jax.tree_util.tree_flatten_with_path(state)[0]
np.savez(sys.argv[3], **{jax.tree_util.keystr(p): np.asarray(
    v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
    for p, v in flat})
"""


def _as_f32_numpy(tree):
    """{reference path: numpy} of a whole port state (bf16 as fp32)."""
    import torch
    from repro_torch.distributed import checkpoint as ckpt
    out = {}
    for key, leaf in ckpt.leaves(tree):
        if isinstance(leaf, int):
            out[key] = np.asarray(leaf, np.int32)
        else:
            t = leaf.detach()
            out[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _four_ranks(rank, world, data, ref_ckpt, port_ckpt, elastic_dir):
    import torch
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training.trainer import Trainer, TrainerConfig
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    at = shd.coords(mesh)
    out = {"at": (at["data"], at["model"])}
    loader = ShardedLoader({k: data["loader." + k]
                            for k in ("tokens", "frames")}, LOADER_B,
                           mesh=mesh, seed=SEED, device="cpu")
    for b, batch in enumerate(loader.epoch()):
        for k, v in batch.items():
            assert shd.is_placed(v) and tuple(v.shape) == \
                (LOADER_B,) + data["loader." + k].shape[1:]
            out[f"loader.{b}.{k}"] = v.to_local().numpy()
    # the reference's checkpoint, restored onto the mesh
    model = get_model(get_smoke("qwen2-1.5b"))
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    bp = input_pspecs(model.cfg, ShapeConfig("t", T, B, "train"), mesh,
                      "fsdp_tp")
    tr = Trainer(model, tc, TrainerConfig(ckpt_dir=ref_ckpt, log_every=0),
                 mesh=mesh, policy="fsdp_tp", batch_pspecs=bp, device="cpu",
                 log_fn=lambda m: None)
    assert tr.step == 2
    for (_, leaf), (_, sh) in zip(ckpt.leaves(tr.state),
                                  ckpt.leaves(tr.state_sh)):
        if not isinstance(leaf, int):
            assert leaf.placements == sh.placements
    full = shd.full_tree(tr.state)   # collective: every rank
    restored = _as_f32_numpy(full)
    if rank == 0:
        whole, _ = ckpt.restore(ref_ckpt, 2, full)
        out["ref_ckpt_equal"] = all(
            np.array_equal(restored[k], v)
            for k, v in _as_f32_numpy(whole).items())
    # the port's meshed Trainer writes one for the reference to read
    loader = ShardedLoader({k: data["train." + k].reshape(-1, T)
                            for k in ("tokens", "labels")}, B, mesh=mesh,
                           seed=0, device="cpu")
    tr = Trainer(model, tc, TrainerConfig(ckpt_dir=port_ckpt, ckpt_every=2,
                                          log_every=0, max_steps=2),
                 mesh=mesh, policy="fsdp_tp", batch_pspecs=bp, device="cpu",
                 log_fn=lambda m: None)
    tr.fit(loader.epoch())
    state = _as_f32_numpy(shd.full_tree(tr.state))
    if rank == 0:
        out["port_state"] = state
    # the twin of tests/test_distributed.py's elastic re-shard
    host = make_host_mesh("cpu")
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(elastic_dir, 0, tree, write=rank == 0)
    torch.distributed.barrier()
    sh = {"w": shd.named(host, shd.P("data", None))}
    got, _ = ckpt.restore(elastic_dir, 0, tree, shardings=sh)
    out["elastic"] = (torch.equal(shd.full_tree(got)["w"], tree["w"]),
                      got["w"].placements == sh["w"].placements,
                      torch.equal(got["w"].to_local(), tree["w"][rank:rank + 1]))
    return out


def test_loader_and_checkpoints_cross_the_packages_on_four_ranks(tmp_path):
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(0)
    data = {"loader.tokens": rng.integers(0, 100, (N, 6)).astype(np.int32),
            "loader.frames": rng.normal(size=(N, 3, 2)).astype(np.float32),
            "train.tokens": rng.integers(0, 256, (2, B, T)).astype(np.int32),
            "train.labels": rng.integers(0, 256, (2, B, T)).astype(np.int32)}
    np.savez(tmp_path / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_ckpt, port_ckpt = tmp_path / "ref_ckpt", tmp_path / "port_ckpt"
    r = subprocess.run(
        [sys.executable, "-c", _REF_WRITE, str(tmp_path / "in.npz"),
         str(ref_ckpt), str(tmp_path / "ref.npz")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = run_ranks(_four_ranks, 4, "cpu",
                      args=(data, str(ref_ckpt), str(port_ckpt),
                            str(tmp_path / "elastic")),
                      threads=1, timeout=120)
    r = subprocess.run(
        [sys.executable, "-c", _REF_READ, str(port_ckpt), "2",
         str(tmp_path / "read.npz")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "ref.npz")
    n_batches = N // LOADER_B
    for out in ranks:
        i, j = out["at"]
        for b in range(n_batches):
            for k in ("tokens", "frames"):
                np.testing.assert_array_equal(
                    out[f"loader.{b}.{k}"], want[f"loader.{b}.{k}.{i}.{j}"])
        assert out["elastic"] == (True, True, True)
    assert ranks[0]["ref_ckpt_equal"]
    read = np.load(tmp_path / "read.npz")
    state = ranks[0]["port_state"]
    assert set(read.files) == set(state)
    for k in state:
        np.testing.assert_array_equal(read[k], state[k], err_msg=k)


def _two_ranks(rank, world, data, d_full, d_cut):
    import torch
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training.trainer import Trainer, TrainerConfig
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    model = get_model(get_smoke("qwen2-1.5b"))
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    bp = input_pspecs(model.cfg, ShapeConfig("t", T, B, "train"), mesh,
                      "fsdp_tp")
    batches = list(ShardedLoader({k: data[k] for k in ("tokens", "labels")},
                                 B, mesh=mesh, seed=0,
                                 device="cpu").epoch())[:4]

    def trainer(d, steps, **kw):
        return Trainer(model, tc, TrainerConfig(ckpt_dir=d, ckpt_every=2,
                                                log_every=0,
                                                max_steps=steps),
                       device="cpu", log_fn=lambda m: None, **kw)

    full = trainer(d_full, 4, mesh=mesh, policy="fsdp_tp", batch_pspecs=bp)
    full.fit(batches)
    cut = trainer(d_cut, 2, mesh=mesh, policy="fsdp_tp", batch_pspecs=bp)
    cut.fit(batches[:2])
    del cut   # "killed" after its checkpoint at step 2
    resumed = trainer(d_cut, 4, mesh=mesh, policy="fsdp_tp",
                      batch_pspecs=bp)
    assert resumed.step == 2
    resumed.fit(batches[2:])
    a, b = shd.full_tree(full.state), shd.full_tree(resumed.state)
    out = {"resume_equal": a["step"] == b["step"] == 4 and all(
        torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        and all(torch.equal(x[s], y[s]) for x, y in zip(a["opt"], b["opt"])
                for s in x)}
    # a mesh without batch_pspecs: the unsharded step on every rank
    whole = [{k: v.full_tensor() for k, v in bt.items()} for bt in batches]
    plain, meshed = [], []
    for mesh_kw, losses in (({}, plain), ({"mesh": mesh}, meshed)):
        tr = trainer("", 2, **mesh_kw)
        step = tr.step_fn

        def record(state, batch, step=step, losses=losses):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        tr.step_fn = record
        tr.fit(whole[:2])
        out.setdefault("unsharded", []).append(
            tr.state_sh is None and not any(
                shd.is_placed(v) for v in tr.state["params"].values()))
    out["unsharded_losses"] = (plain, meshed)
    return out


def test_meshed_trainer_resumes_bit_equal_on_two_ranks(tmp_path):
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(5)
    data = {k: rng.integers(0, 256, (4 * B, T)).astype(np.int32)
            for k in ("tokens", "labels")}
    ranks = run_ranks(_two_ranks, 2, "cpu",
                      args=(data, str(tmp_path / "full"),
                            str(tmp_path / "cut")), threads=1, timeout=120)
    for out in ranks:
        assert out["resume_equal"]
        assert out["unsharded"] == [True, True]
        plain, meshed = out["unsharded_losses"]
        assert len(plain) == 2 and plain == meshed
