"""The port's scripts beside the package: ``chip_smoke.py`` and
``tools/*.py`` import nothing of JAX or of the JAX package, and the tools
run on the CPU at a small size."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_script_imports_no_jax_and_no_reference(path):
    assert not imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_kcenter_distances_routes_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "kcenter_distances.py"),
         "--pool", "3000", "--max-iters", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    routes = {r["route"]: r for r in res["routes"]}
    assert list(routes) == ["kernels", "split", "plain", "plain_all"]
    # on the CPU the kernels route is the plain version: the same campaign,
    # and each of its selections made again with plain distances agrees
    keys = ("decision", "B", "S", "cost", "measured_error", "iterations",
            "calls")
    for name in ("plain", "plain_all"):
        assert {k: routes[name][k] for k in keys} == \
            {k: routes["kernels"][k] for k in keys}
    sel = routes["kernels"]["selections"]
    assert sel and all(s["plain_first_difference"] == -1 for s in sel)
    assert routes["kernels"]["calls"]["pairwise_sqdist"] == len(sel)


def test_fleet_spans_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "fleet_spans.py"),
         "--pool", "1000", "--max-iters", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res["modes"]) == ["serial", "concurrent"]
    for mode in res["modes"].values():
        spans = mode["spans"]
        assert {"bootstrap", "iteration", "commit", "fit", "sweep",
                "kcenter", "round"} <= set(spans)
        assert spans["bootstrap"]["calls"] == 8
        assert spans["commit"]["calls"] == 8
        assert mode["wall"] > 0
    assert res["modes"]["serial"]["spans"]["fit"]["calls"] == \
        res["modes"]["concurrent"]["spans"]["fit"]["calls"]


def test_concurrent_captures_on_cpu():
    """The threads and the serial comparison run on the CPU, where the
    engines capture nothing; with or without the lock every round equals
    the serial retrains."""
    for flags in ([], ["--no-lock"]):
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "concurrent_captures.py"),
             "--rounds", "2", "--widths", "16", "32", "--device", "cpu",
             *flags], capture_output=True, text=True, timeout=300,
            check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res == {"lock": not flags, "widths": [16, 32],
                       "bad_rounds": 0, "rounds": 2}
