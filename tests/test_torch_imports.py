"""The PyTorch port imports neither JAX nor anything of the JAX package,
and switches TF32 off (checked in one fresh interpreter); its example twins
import only the port."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "repro")),
    "tf32": [torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32]}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference(probe):
    assert probe["foreign"] == []


def test_every_ported_module_was_imported(probe):
    want = {"repro_torch.core.mcal", "repro_torch.core.task",
            "repro_torch.core.scoring", "repro_torch.core.selection_device",
            "repro_torch.kernels.ops", "repro_torch.kernels.margin_head",
            "repro_torch.kernels.pairwise_dist", "repro_torch.kernels.build",
            "repro_torch.training.fit_device", "repro_torch.models.convert",
            "repro_torch.data.synth", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.layers",
            "repro_torch.models.mamba2", "repro_torch.models.transformer",
            "repro_torch.models.hybrid", "repro_torch.models.registry",
            "repro_torch.configs.zamba2_2p7b",
            "repro_torch.configs.qwen2_1p5b", "repro_torch.configs.gemma3_4b",
            "repro_torch.configs.qwen1p5_4b",
            "repro_torch.configs.phi3_medium_14b",
            "repro_torch.serving.engine", "repro_torch.launch.serve",
            "repro_torch.core.emulator", "repro_torch.core.baselines",
            "repro_torch.data.pool", "repro_torch.annotation.oracle",
            "repro_torch.annotation.aggregate",
            "repro_torch.annotation.service", "repro_torch.launch.label",
            "repro_torch.faults.errors", "repro_torch.faults.plan",
            "repro_torch.faults.retry", "repro_torch.obs.metrics",
            "repro_torch.obs.export", "repro_torch.obs.slo",
            "repro_torch.obs.health", "repro_torch.obs.profiling",
            "repro_torch.core.tenant", "repro_torch.launch.orchestrator",
            "repro_torch.launch.report"}
    assert want <= set(probe["modules"])


def test_tf32_is_off_after_import(probe):
    assert probe["tf32"] == [False, False]


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_arch_select.py",
                                  "torch_label_dataset.py",
                                  "torch_serve_batched.py"])
def test_example_twin_imports_only_the_port(name):
    """The example twins import the port and never JAX or the JAX package
    (``tests/test_torch_examples.py`` runs them and checks the modules
    they load)."""
    import ast
    roots = set()
    for node in ast.walk(ast.parse((SRC.parent / "examples" / name)
                                   .read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
