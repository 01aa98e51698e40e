"""The port's twins of the MCAL examples, each run in a fresh process with
``--device cpu``: ``torch_quickstart.py`` and ``torch_arch_select.py``
print the reference examples' output exactly (the emulator's draws are
numpy in both packages); ``torch_label_dataset.py`` prints the reference
report's lines and meets its error target (the two packages' classifiers
differ in their last bits, so its numbers are not the reference's);
``torch_serve_batched.py`` prints the reference's lines with the port's
own numbers (its weights are the port's draws).  No twin loads a ``jax*``
or ``repro*`` module."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# run an example as __main__, then report the foreign modules it loaded
_RUN = """
import json, runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def _run(example, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _RUN, str(ROOT / "examples" / example),
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True).stdout.splitlines()
    return out[:-1], json.loads(out[-1])


@pytest.mark.parametrize("name", ["quickstart", "arch_select"])
def test_emulated_twin_prints_the_reference_output(name):
    got, foreign = _run(f"torch_{name}.py", "--device", "cpu")
    want, _ = _run(f"{name}.py")
    assert foreign == []
    assert got == want


def test_label_dataset_twin_reports_like_the_reference():
    got, foreign = _run("torch_label_dataset.py", "--device", "cpu")
    assert foreign == []
    report = {line.split(":", 1)[0].rstrip(): line.split(":", 1)[1]
              for line in got if ":" in line}
    # the reference's report lines (examples/label_dataset.py), in order
    keys = ["decision", "trained on", "machine-labeled", "measured error",
            "cost", "ledger"]
    assert [k for k in report if k in keys] == keys
    assert got[0] == ("generating a 6,000-sample / 10-class pool "
                      "(25% hard tail) ...")
    assert report["decision"].strip() in ("hybrid", "human_all")
    err = float(report["measured error"].split("%")[0]) / 100
    assert err <= 0.05 + 0.01              # the example's own assertion
    ledger = report["ledger"].strip()
    assert ledger.startswith("{'human': ") and "'total': " in ledger


def test_serve_batched_twin_prints_the_reference_lines():
    """The reference's four lines (``examples/serve_batched.py``), numbers
    aside: 8 x 16 generated tokens and 256 scored positions."""
    got, foreign = _run("torch_serve_batched.py", "--device", "cpu")
    assert foreign == []
    assert [re.sub(r"\d+(\.\d+)?", "#", line) for line in got] == [
        "generated #x# tokens in #s (# tok/s on CPU)",
        "scored # positions: margin p#=# p#=#, mean entropy=# nats",
        "lowest-margin (most uncertain) positions would be routed to "
        "humans;",
        "highest-margin positions are machine-labeled — MCAL's L(.)/M(.)."]
    assert got[0].startswith("generated 8x16 tokens in ")
    assert got[1].startswith("scored 256 positions: ")
