"""The port's engines driven from many threads at once, as the fleet's
tenants drive them (the CPU half; ``tests/test_torch_runtime_cuda.py``
holds the card half: the retrain graphs and the pinned staging rings).

* Eight threads making their first kernel call at once build each kernel
  library exactly once: ``kernels.build`` builds and loads under one lock,
  and each wrapper types its entry points under it.  The compiler is a
  stub script that logs its calls and writes the output file, and the
  libraries load through a stub ``ctypes``.
* One fit engine retraining for several threads gives each the params it
  gets alone; one sweep runner gives each sweeping thread its own staging
  ring.
* Several fit engines making their first captures at once (architecture
  selection's candidates) capture one at a time, under
  ``fit_device.CAPTURE_LOCK``.
"""
import os
import stat
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

STUB = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$out" >> "{log}"
sleep 0.2
echo stub > "$out"
"""


class _Fn:
    """A typed C entry point's stand-in."""

    def __init__(self, value=0):
        self.value = value
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        return self.value


class _Lib:
    def __init__(self, path):
        self.path = path
        self.margin_head_slice_cols = _Fn(128)

    def __getattr__(self, name):
        fn = _Fn()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def stub_toolchain(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STUB.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    opened = []

    def cdll(path):
        opened.append(path)
        return _Lib(path)
    monkeypatch.setattr(build, "ctypes",
                        types.SimpleNamespace(CDLL=cdll))
    return log, opened


def _together(fn, n=8):
    """Run ``fn(i)`` on ``n`` threads released at once; re-raise the
    first failure."""
    gate = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        try:
            gate.wait()
            out[i] = fn(i)
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_eight_first_loads_build_each_library_once(stub_toolchain):
    log, opened = stub_toolchain
    names = sorted(build.sources())
    libs = _together(lambda i: build.load(names[i % len(names)]))
    built = log.read_text().split()
    assert sorted(os.path.basename(p) for p in built) == sorted(
        f"lib{n}.so.{os.getpid()}.tmp" for n in names)      # once each
    assert len(opened) == len(names)                          # loaded once
    for i, lib in enumerate(libs):
        assert lib is build.load(names[i % len(names)])
    for n in names:
        assert (build.build_dir() / f"lib{n}.so").exists()
    assert not list(build.build_dir().glob("*.tmp"))


def test_eight_concurrent_build_all_calls_compile_once(stub_toolchain):
    log, _ = stub_toolchain
    paths = _together(lambda i: build.build_all())
    assert all(p == paths[0] for p in paths)
    assert len(log.read_text().split()) == len(build.sources())
    build.build_all()                   # built: nothing more to compile
    assert len(log.read_text().split()) == len(build.sources())


@pytest.mark.parametrize("module", ["margin_head", "pairwise_dist",
                                    "flash_attention", "ssd_scan"])
def test_wrappers_type_their_entry_points_once(stub_toolchain, module,
                                               monkeypatch):
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    empty = [] if isinstance(mod._fns, list) else {}
    monkeypatch.setattr(mod, "_fns", empty)
    args = () if module == "pairwise_dist" else (torch.float32,)
    got = _together(lambda i: mod._fn(*args))
    assert all(g is got[0] for g in got)
    assert len(mod._fns) == 1


def test_launch_counts_are_taken_under_the_lock():
    import inspect

    from repro_torch.kernels import (flash_attention, margin_head,
                                     pairwise_dist, ssd_scan)
    for mod in (margin_head, pairwise_dist, flash_attention, ssd_scan):
        src = inspect.getsource(mod)
        assert src.count("launches += 1") == src.count(
            "with build.COUNT_LOCK:\n        launches += 1") == 1, mod


# ---------------------------------------------------------------------------
# shared engines on the CPU
# ---------------------------------------------------------------------------

KW = dict(name="mlp-live", family="mlp", num_layers=2, d_model=32,
          num_classes=4, input_dim=8, dtype="float32")


def test_shared_fit_engine_gives_each_thread_its_serial_params():
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.fit_device import FitConfig, FitEngine
    eng = FitEngine(get_model(ModelConfig(**KW)),
                    TrainConfig(learning_rate=1e-2, schedule="constant"),
                    FitConfig(epochs=3, batch_size=64), device="cpu")
    rng = np.random.default_rng(0)
    jobs = [(seed, rng.normal(size=(100 + 13 * seed, 8)).astype(np.float32),
             rng.integers(0, 4, 100 + 13 * seed)) for seed in range(4)]
    serial = [eng.fit(*job) for job in jobs]
    got = _together(lambda i: eng.fit(*jobs[i % 4]))
    for i, (params, losses) in enumerate(got):
        want_p, want_l = serial[i % 4]
        torch.testing.assert_close(losses, want_l, rtol=0, atol=0)
        for k in want_p:
            torch.testing.assert_close(params[k], want_p[k], rtol=0,
                                       atol=0)


def test_engines_capturing_at_once_capture_one_at_a_time(monkeypatch):
    """Three engines' first uses of a bucket on three threads: each
    engine captures its graph once, and no two captures overlap."""
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training import fit_device
    lock = threading.Lock()
    active, overlap, made = [0], [0], []

    class Graph:
        def __init__(self, engine, key, state):
            with lock:
                active[0] += 1
                overlap[0] = max(overlap[0], active[0])
            threading.Event().wait(0.1)
            with lock:
                active[0] -= 1
            made.append((id(engine), key))
    monkeypatch.setattr(fit_device, "_RetrainGraph", Graph)
    engines = [fit_device.FitEngine(
        get_model(ModelConfig(**dict(KW, d_model=d))),
        TrainConfig(learning_rate=1e-2, schedule="constant"),
        fit_device.FitConfig(epochs=2, batch_size=64), device="cpu")
        for d in (16, 32, 64)]
    key = fit_device.fit_plan(100, 64)

    def first_use(i):
        eng = engines[i % 3]
        with eng._lock:          # as FitEngine._run_impl holds it
            return eng._graph(key, None)
    got = _together(first_use, 6)
    assert overlap[0] == 1
    assert sorted(made) == sorted((id(e), key) for e in engines)
    assert [e.captures for e in engines] == [1, 1, 1]
    for i, g in enumerate(got):
        assert g is engines[i % 3]._graphs[key]


def test_each_sweeping_thread_stages_through_its_own_ring():
    from repro_torch.serving.sweep import _ThreadStagers
    stagers = _ThreadStagers("cpu")
    got = _together(lambda i: (stagers.get(), stagers.get("k"),
                               stagers.get()))
    assert all(a is c and a is not b for a, b, c in got)
    assert len({id(a) for a, _, _ in got}) == len(got)
