"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's on every (arch x cell x mesh), and its FLOP formulas against
``FlopCounterMode`` over the port's own CPU forward and train step.

The twin's counts are the reference's arithmetic in the reference's order,
so parameter counts, FLOPs, HBM bytes, wire bytes and model FLOPs must be
equal exactly; only the seconds differ, each the same count over the
twin's H100 constants.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jcfg
from repro.launch import roofline as jr
from repro_torch import configs as tcfg
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch import roofline as tr
from repro_torch.models.registry import get_model

ROOT = Path(__file__).resolve().parents[1]

# the perf loop's candidate overrides (``analyze_cell``'s keys)
OVERRIDES = [None, {"remat_factor": 0.0}, {"remat_factor": 2.0},
             {"ce_fused": True}, {"moe_a2a": True}, {"grad_bytes": 2},
             {"wd": 16}, {"wd": 1}, {"opt_bytes_factor": 1.5},
             {"remat_factor": 0.5, "ce_fused": True, "moe_a2a": True,
              "grad_bytes": 1, "wd": 256, "opt_bytes_factor": 2.0}]

CELLS = [(arch, s.name, mesh) for arch in tcfg.ARCH_IDS
         for s in tcfg.cells(arch) for mesh in ("single", "multi")]


def _shape(pkg, name):
    return pkg.SHAPES_BY_NAME[name]


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_cells_equal_reference(arch):
    got = [dataclasses.astuple(s) for s in tcfg.cells(arch)]
    want = [dataclasses.astuple(s) for s in jcfg.cells(arch)]
    assert got == want
    assert tcfg.LONG_CONTEXT_OK == jcfg.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_param_counts_equal_reference_and_model(arch):
    got = tr.param_counts(tcfg.get_config(arch))
    want = jr.param_counts(jcfg.get_config(arch))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.active == want.active
    exact = get_model(tcfg.get_config(arch)).param_count()
    assert got.total == pytest.approx(exact, rel=0.02), (got.total, exact)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_counts_equal_reference(arch, shape, mesh):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    ts, js = _shape(tcfg, shape), _shape(jcfg.base, shape)
    for ga in (1, 4):
        for o in OVERRIDES:
            got = tr.analyze_cell(tc, ts, mesh, ga, o)
            want = jr.analyze_cell(jc, js, mesh, ga, o)
            for k in ("arch", "shape", "mesh", "n_devices", "flops_local",
                      "hbm_bytes_local", "wire_bytes_local", "model_flops",
                      "hlo_flops_local"):
                assert getattr(got, k) == getattr(want, k), (k, ga, o)
            assert got.useful_ratio == want.useful_ratio
            # the seconds: the same counts over the twin's constants
            assert got.compute_s == got.flops_local / tr.PEAK_FLOPS
            assert got.memory_s == got.hbm_bytes_local / tr.HBM_BW
            assert got.collective_s == got.wire_bytes_local / tr.NET_BW
            assert got.step_s == max(got.compute_s, got.memory_s,
                                     got.collective_s)
            assert got.mfu == got.model_flops / (
                got.step_s * tr.PEAK_FLOPS * got.n_devices)
            assert got.compute_s > 0 and got.memory_s > 0
            assert np.isfinite(got.collective_s)
            row = got.row()
            assert set(row) == set(want.row())
            assert row["hlo_flops"] == want.row()["hlo_flops"]


def test_h100_constants():
    assert (tr.PEAK_FLOPS, tr.HBM_BW, tr.NET_BW) == (989e12, 3.35e12, 50e9)
    assert (tr.BYTES_W, tr.BYTES_G) == (jr.BYTES_W, jr.BYTES_G)


@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_full_table_equals_reference(mesh):
    accums = {("qwen2-1.5b", "train_4k"): 4, ("gemma3-4b", "train_4k"): 2}
    got = {(r.arch, r.shape): r for r in tr.full_table(accums, mesh)}
    want = {(r.arch, r.shape): r for r in jr.full_table(accums, mesh)}
    assert set(got) == set(want)
    for k, r in got.items():
        assert (r.flops_local, r.hbm_bytes_local, r.wire_bytes_local,
                r.model_flops) == (want[k].flops_local,
                                   want[k].hbm_bytes_local,
                                   want[k].wire_bytes_local,
                                   want[k].model_flops), k


def test_main_prints_every_cell(tmp_path):
    rec = tmp_path / "dryrun.jsonl"
    rec.write_text(json.dumps({"arch": "qwen2-1.5b", "shape": "train_4k",
                               "mesh": "single", "grad_accum": 4}) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--json",
         "--dryrun-jsonl", str(rec)], capture_output=True, text=True,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        check=True).stdout
    rows = json.loads(out)
    assert len(rows) == sum(len(tcfg.cells(a)) for a in tcfg.ARCH_IDS)
    row = [r for r in rows if (r["arch"], r["shape"]) ==
           ("qwen2-1.5b", "train_4k")][0]
    want = tr.analyze_cell(tcfg.get_config("qwen2-1.5b"),
                           tcfg.SHAPES_BY_NAME["train_4k"], "single", 4)
    assert row["compute_s"] == want.compute_s


# the reference test's two small unrolled configs (tests/test_roofline.py)
PROBES = [(4, 256, 4, 1024, 1024), (2, 128, 2, 512, 512)]


def _probe(nl, d, h, ff, v):
    return ModelConfig(name="probe", family="dense", num_layers=nl,
                       d_model=d, num_heads=h, num_kv_heads=h, d_ff=ff,
                       vocab_size=v, remat="none", dtype="float32")


def _counted(cfg, B, T, train: bool) -> int:
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    g = np.random.default_rng(0)
    toks = torch.as_tensor(g.integers(0, cfg.vocab_size, (B, T)),
                           dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if train:
            from repro_torch.training.train_loop import (init_train_state,
                                                         make_train_step)
            tc = TrainConfig()
            step = make_train_step(model, tc)
            step(init_train_state(model, tc, params),
                 {"tokens": toks, "labels": toks})
        else:
            with torch.no_grad():
                model.forward(params, {"tokens": toks})
    return fc.get_total_flops()


@pytest.mark.parametrize("nl,d,h,ff,v", PROBES)
def test_forward_flops_match_flop_counter(nl, d, h, ff, v):
    cfg = _probe(nl, d, h, ff, v)
    B, T = 4, 128
    got = _counted(cfg, B, T, train=False)
    want = tr.forward_flops(cfg, B * T, (T + 1) / 2, with_head_tokens=0)
    # the counter sees the body's products; 20% for the rest, as the
    # reference's test allows XLA
    assert got == pytest.approx(want, rel=0.2), (got, want)


def test_train_flops_roughly_3x_forward_no_remat():
    cfg = _probe(2, 128, 2, 512, 512)
    B, T = 4, 128
    fwd = _counted(cfg, B, T, train=False)
    train = _counted(cfg, B, T, train=True)
    assert 2.0 <= train / fwd <= 4.0, train / fwd
