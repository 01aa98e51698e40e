"""LM training's runtime on one device against the JAX package: the
loader's batch order, the straggler monitor, checkpoints across packages,
``Trainer``'s checkpoint and resume, and the train launcher (the port's
``data/loader.py``, ``distributed/`` and ``launch/train.py``).  Split from
``test_torch_train.py`` (which keeps the loss, the step, the optimizer and
the schedules) so that the two run on separate test workers.

Tolerances: tokens, the loader's batch order, the straggler monitor's
events and checkpoints' bits are exact; the trainer's resumed state and
losses equal the uninterrupted run's bit for bit.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.loader import ShardedLoader as JShardedLoader
from repro.distributed import checkpoint as jckpt
from repro.distributed.straggler import StragglerMonitor as JStraggler
from repro.models.registry import get_model as jget_model
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synth import make_lm_tokens
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig
from test_torch_dense import make_jax_tree
from test_torch_train import _batch, _t


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
