"""The port's dry-run (``repro_torch.launch.dryrun``).

``pick_train_config`` and ``pick_grad_accum`` against the JAX package's on
every arch and train cell of both production meshes (the reference's
``pick_grad_accum`` gets a stand-in mesh with ``axis_names`` and a
``devices`` array).  Cells traced on the 256-rank fake world in a
subprocess, at the smoke configs (the MoE's with 16 experts and mamba2's
with 16 SSM heads, so that they split over the 16 "model" ranks) and cut
sequence lengths: the record has the reference's keys; the train cells'
counted FLOPs per device lie within 20% of the analytic count of the
tensor-parallel design (``dryrun.expected_train_flops``: qwen2's MLP and
head split over the 16 "model" ranks, the smoke's 3 heads whole;
mamba2's mixer on a rank's heads and inner columns, B and C whole), the
serving cells' between 0.8
of the twin roofline's ``flops_local`` (less would mean the trace missed
work) and 1.2 of its global FLOPs over the data-parallel ways (more than
each rank's data shard whole); and the collectives counted are exactly
those the port issues.  ``sweep`` skips a cell already in its
output file.  The kernels' dispatch refuses a tensor that is neither on the
CPU nor on a card, so a dry-run can never hand a kernel a storage-less
tensor.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as td
from repro_torch.launch.roofline import analyze_cell, mesh_sizes

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _reference_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS`` to
    512 host devices (``src/repro/launch/dryrun.py:1-2``); the variable is
    put back at once, so the JAX tests sharing this process (JAX reads it
    when its backend starts, not here) and their subprocesses keep their
    own device count."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


jd = _reference_dryrun()
TRAIN_CELLS = [(arch, mesh) for arch in tcfg.ARCH_IDS
               for mesh in ("single", "multi")]


class _StandInMesh:
    """What the reference's ``pick_grad_accum`` reads of a JAX mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_pick_train_config_equals_reference(arch):
    from repro_torch.models.registry import get_model
    n = get_model(tcfg.get_config(arch)).param_count()
    got, want = td.pick_train_config(n), jd.pick_train_config(n)
    for k in ("moment_dtype", "factored_second_moment", "accum_dtype",
              "grad_accum", "learning_rate", "weight_decay", "grad_clip"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS)
def test_pick_grad_accum_equals_reference(arch, mesh):
    sizes = mesh_sizes(mesh)
    for policy in (None, "fsdp", "tp", "fsdp_tp_seq"):
        tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
        if policy:
            tc, jc = tc.replace(sharding=policy), jc.replace(sharding=policy)
        shape = tcfg.SHAPES_BY_NAME["train_4k"]
        got = td.pick_grad_accum(tc, shape, sizes)
        want = jd.pick_grad_accum(jc, jcfg.base.SHAPES_BY_NAME["train_4k"],
                                  _StandInMesh(sizes))
        assert got == want, policy
    for name in ("prefill_32k", "decode_32k"):
        assert td.pick_grad_accum(tcfg.get_config(arch),
                                  tcfg.SHAPES_BY_NAME[name], sizes) == 1


# smoke configs at cut sequence lengths (every global batch as the
# production cell's, so the mesh splits the rows as it would)
SEQ = 64
TRACED = [("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
          ("qwen2-1.5b", "decode_32k"), ("dbrx-132b", "decode_32k"),
          ("mamba2-1.3b", "train_4k")]
# the collectives the port issues: storage dims gathered at each use, their
# gradients reduce-scattered and the leaves' sums all-reduced in training;
# the tensor-parallel MLP's and embedding's sums over "model" (and the
# MoE's combine) all-reduced; the vocabulary's logits and decode's
# attention states gathered over "model"
ISSUED = {"train_4k": {"all-gather", "reduce-scatter", "all-reduce"},
          "prefill_32k": {"all-gather", "all-reduce"},
          "decode_32k": {"all-gather", "all-reduce"},
          "moe": {"all-gather", "all-reduce"}}
# the reference's record (src/repro/launch/dryrun.py:123-130, 259-267)
KEYS = {"arch", "shape", "mesh", "policy", "params", "flops",
        "bytes_accessed", "collective_bytes", "collective_counts", "memory",
        "n_devices"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes"}

# every cell at its smoke config and a cut sequence length
SMOKE = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch.configs import base

    def smoke(arch):
        cfg = C.get_smoke(arch)
        if cfg.family == "ssm":
            return cfg.replace(ssm_head_dim=8)
        return cfg.replace(num_experts=16) if cfg.family == "moe" else cfg

    C.get_config = smoke
    for name, s in list(base.SHAPES_BY_NAME.items()):
        base.SHAPES_BY_NAME[name] = base.ShapeConfig(name, {seq},
                                                     s.global_batch, s.kind)
    from repro_torch.launch import dryrun
""")
SCRIPT = SMOKE + textwrap.dedent("""
    out = []
    for i, (arch, shape) in enumerate({cells}):
        keep = sys.argv[1] if i == 0 else None
        out.append(dryrun.run_cell(arch, shape, False, keep_ops=keep))
        out[-1]["torn_down"] = not dist.is_initialized()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        dryrun.run_cell("qwen2-1.5b", "decode_32k", False)
        refused = False
    except RuntimeError:
        refused = True
    print(json.dumps({{"records": out, "refused": refused}}))
""")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    ops_path = tmp_path_factory.mktemp("ops") / "ops.jsonl"
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(seq=SEQ, cells=TRACED),
         str(ops_path)], capture_output=True, text=True, cwd=ROOT, env=ENV,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["ops"] = ops_path.read_text().splitlines()
    return out


def _smoke(arch):
    cfg = tcfg.get_smoke(arch)
    if cfg.family == "ssm":   # 16 SSM heads, which split over "model"
        return cfg.replace(ssm_head_dim=8)
    return cfg.replace(num_experts=16) if cfg.family == "moe" else cfg


@pytest.mark.parametrize("i", range(len(TRACED)),
                         ids=[f"{a}-{s}" for a, s in TRACED])
def test_traced_cell_record(traced, i):
    arch, shape = TRACED[i]
    rec = traced["records"][i]
    train = shape == "train_4k"
    assert set(rec) - {"torn_down"} == KEYS | ({"grad_accum"} if train
                                               else set())
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["output_bytes"] > 0
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape,
                                                        "single")
    assert rec["n_devices"] == 256 and rec["torn_down"]
    assert rec["bytes_accessed"] > 0
    assert set(rec["collective_counts"]) == set(td.COLLECTIVE_OPS) == set(
        jd.COLLECTIVE_OPS)
    # the per-device FLOPs: a train step's within 20% of the analytic
    # count of the split; a serving step's no less than the roofline's
    # share of a device (else the trace missed work), no more than the
    # rows' batch shard whole
    s = tcfg.SHAPES_BY_NAME[shape]
    cell = tcfg.base.ShapeConfig(shape, SEQ, s.global_batch, s.kind)
    sizes = mesh_sizes("single")
    dp = sizes["data"]
    if train:
        split = td.expected_train_flops(_smoke(arch), cell, sizes)
        assert abs(rec["flops"] - split) <= 0.2 * split, (rec["flops"],
                                                          split)
    want = analyze_cell(_smoke(arch), cell, "single",
                        rec.get("grad_accum", 1))
    flops_global = want.flops_local * want.n_devices
    assert 0.8 * want.flops_local <= rec["flops"] <= 1.2 * flops_global / dp
    issued = ISSUED["moe" if arch == "dbrx-132b" else shape]
    for op in td.COLLECTIVE_OPS:
        n, b = rec["collective_counts"][op], rec["collective_bytes"][op]
        assert (n > 0) == (op in issued), (op, n)
        assert (b > 0) == (n > 0), (op, b)


def test_keep_ops_writes_each_dispatched_op(traced):
    lines = [json.loads(x) for x in traced["ops"]]
    assert len(lines) > 1000
    assert all(set(x) == {"op", "in", "out"} for x in lines)
    names = {x["op"] for x in lines}
    assert "c10d.allgather_.default" in names
    assert any(n.startswith("aten.mm") or n.startswith("aten.bmm")
               for n in names)


def test_run_cell_refuses_an_initialized_group(traced):
    assert traced["refused"]


def test_the_split_traces_each_rank_of_model():
    """mamba2 ``train_4k`` under ``fsdp_tp_seq`` traced as rank 0 and as
    rank 15, the last "model" rank: rank 0 scans its block once, rank 15
    twice (from zero for the state exchange, then from its incoming
    state), so rank 15 computes more; ``expected_train_flops`` counts the
    busiest rank, within 20% of rank 15's trace."""
    code = SMOKE.format(seq=SEQ) + textwrap.dedent("""
        print(json.dumps([dryrun.run_cell("mamba2-1.3b", "train_4k", False,
                                          policy="fsdp_tp_seq", rank=r)
                          for r in (0, 15)]))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=ENV, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    first, last = json.loads(r.stdout.strip().splitlines()[-1])
    assert first["policy"] == last["policy"] == "fsdp_tp_seq"
    assert last["flops"] > first["flops"]
    s = tcfg.SHAPES_BY_NAME["train_4k"]
    cfg = _smoke("mamba2-1.3b").replace(sharding="fsdp_tp_seq")
    split = td.expected_train_flops(
        cfg, tcfg.base.ShapeConfig("train_4k", SEQ, s.global_batch, s.kind),
        mesh_sizes("single"))
    assert abs(last["flops"] - split) <= 0.2 * split, (last["flops"], split)


def test_sweep_skips_a_cell_in_its_output_file(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    out.write_text(json.dumps({"arch": "qwen2-1.5b", "shape": "decode_32k",
                               "mesh": "single"}) + "\n")
    code = ("import sys; from repro_torch.launch import dryrun; "
            "sys.exit(len(dryrun.sweep(archs=['qwen2-1.5b'], "
            f"shapes=['decode_32k'], out_path={str(out)!r})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=ENV, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "[skip] ('qwen2-1.5b', 'decode_32k', 'single')"
    assert lines[1] == "[run ] qwen2-1.5b x decode_32k x multi"
    assert "sweep done; 0 failures" in lines
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    assert recs[1]["n_devices"] == 512
    assert recs[1]["collective_counts"]["all-gather"] > 0


@pytest.mark.parametrize("entry", ["attention", "ssd", "score_head",
                                   "pairwise_sqdist"])
def test_kernel_dispatch_refuses_a_meta_tensor(entry):
    def t(*shape):
        return torch.empty(shape, device="meta")
    calls = {"attention": lambda: ops.attention(t(1, 8, 2, 16), t(1, 8, 2, 16),
                                                t(1, 8, 2, 16)),
             "ssd": lambda: ops.ssd(t(1, 8, 2, 16), t(1, 8, 2), t(2),
                                    t(1, 8, 4), t(1, 8, 4), chunk=8),
             "score_head": lambda: ops.score_head(t(4, 16), t(16, 32)),
             "pairwise_sqdist": lambda: ops.pairwise_sqdist(t(4, 16),
                                                            t(3, 16))}
    with pytest.raises(ValueError, match="meta"):
        calls[entry]()
