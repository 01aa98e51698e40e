"""The port's fits-proof (``repro_torch.launch.fitsproof``) against the JAX
package's: every resident term equal on every (arch x cell x mesh) at the
grad accumulations 1 and the one the dry-run picks; ``fits`` against the
H100's 80 GB only where the caller asks for the CPU, the card's memory on
``cuda``, and a ``cuda`` call without a card raises."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jcfg
from repro.launch import fitsproof as jf
from repro_torch import configs as tcfg
from repro_torch.launch import dryrun as td
from repro_torch.launch import fitsproof as tf
from repro_torch.launch.roofline import mesh_sizes

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, s.name, mesh) for arch in tcfg.ARCH_IDS
         for s in tcfg.cells(arch) for mesh in ("single", "multi")]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_residents_equal_reference(arch, shape, mesh):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    ts, js = tcfg.SHAPES_BY_NAME[shape], jcfg.base.SHAPES_BY_NAME[shape]
    picked = td.pick_grad_accum(tc, ts, mesh_sizes(mesh))
    for ga in sorted({1, picked}):
        got = tf.residents(tc, ts, mesh, ga, hbm=tf.capacity("cpu"))
        want = jf.residents(jc, js, mesh, ga)
        assert set(got) == set(want)
        for k in want:
            if k != "fits":
                assert got[k] == want[k], (k, ga)
        assert got["fits"] == (got["total"] <= 0.9 * 80e9)
        # at the reference's 16 GB chip, the reference's verdict
        assert tf.residents(tc, ts, mesh, ga, hbm=jf.HBM_PER_CHIP)["fits"] \
            == want["fits"]


def test_capacity_is_the_data_sheet_only_on_request():
    assert tf.capacity("cpu") == tf.HBM_PER_CHIP == 80e9
    with pytest.raises(ValueError, match="meta"):
        tf.capacity("meta")
    if torch.cuda.is_available():
        assert tf.capacity("cuda") == float(
            torch.cuda.get_device_properties(0).total_memory)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tf.capacity("cuda")
        cfg = tcfg.get_config("qwen2-1.5b")
        with pytest.raises(RuntimeError):
            tf.residents(cfg, tcfg.SHAPES_BY_NAME["train_4k"], "single")


def test_main_on_the_cpu_names_the_data_sheet(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fitsproof", "--device",
         "cpu", "--dryrun-jsonl", str(tmp_path / "none.jsonl")],
        capture_output=True, text=True, cwd=ROOT, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))).stdout
    lines = out.splitlines()
    assert lines[0].startswith("capacity 80.00 GB (data sheet)")
    assert len(lines) == 2 + sum(len(tcfg.cells(a)) for a in tcfg.ARCH_IDS)
