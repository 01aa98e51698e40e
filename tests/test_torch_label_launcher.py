"""The port's labeling launcher (``repro_torch.launch.label``): the flags it
shares with the JAX package's launcher have the same defaults and choices,
``--help`` loads no torch, and ``--state``/``--iters-per-run`` preempt and
resume a campaign to the uninterrupted result."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.launch import label as jlabel
from repro_torch.launch import label

SRC = Path(__file__).resolve().parents[1] / "src"


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_shared_flags_have_the_reference_defaults_and_choices():
    mine, ref = _actions(label.build_parser()), \
        _actions(jlabel.build_parser())
    shared = set(mine) & set(ref)
    assert set(mine) - shared == {"device"}
    assert {"live", "dataset", "arch", "pool", "classes", "difficulty",
            "eps", "budget", "metric", "service", "sweep_page",
            "sweep_async", "fit_fused", "fit_async", "fit_resident", "state",
            "sweep_ckpt_pages", "iters_per_run", "annotator_noise",
            "annotator_workers", "annotator_spammers", "annotator_aggregate",
            "label_repeats", "max_repeats", "adaptive_repeats",
            "repeat_confidence", "seed", "out", "trace", "trace_replay",
            "trace_diff", "autosave", "sweep_timeout", "fit_timeout",
            "chaos", "chaos_seed", "metrics", "slo", "prom", "profile",
            "profile_iter", "mesh"} == shared
    assert set(ref) - shared == set()
    for dest in shared:
        assert mine[dest].default == ref[dest].default, dest
        assert mine[dest].choices == ref[dest].choices, dest
        assert mine[dest].option_strings == ref[dest].option_strings, dest
    assert label.build_parser().parse_args([]).device == "cuda"
    assert label.METRIC_CHOICES == jlabel.METRIC_CHOICES
    assert label.AGGREGATE_CHOICES == jlabel.AGGREGATE_CHOICES


@pytest.mark.parametrize("argv", [["--help"], ["--live", "--help"]])
def test_help_loads_no_torch(argv):
    probe = ("import runpy, sys\n"
             f"sys.argv = ['label'] + {argv!r}\n"
             "try:\n"
             "    runpy.run_module('repro_torch.launch.label',"
             " run_name='__main__')\n"
             "except SystemExit:\n"
             "    pass\n"
             "print(sorted(m for m in sys.modules"
             " if m.split('.')[0] in ('torch', 'jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert "--sweep-async" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("argv", [
    ["--dataset", "cifar10", "--annotator-noise", "0.2", "--label-repeats",
     "3", "--annotator-aggregate", "ds"],
    ["--dataset", "fashion", "--annotator-noise", "0.2", "--label-repeats",
     "2", "--max-repeats", "4", "--adaptive-repeats",
     "--annotator-spammers", "0.2"]])
def test_noisy_replay_report_matches_jax(argv, tmp_path, monkeypatch,
                                         capsys):
    """The noisy replay campaign through both launchers: the reference's
    report keys with equal values, and the annotation block (the residual
    estimate comes from fp32 DS posteriors on each side)."""
    jout, out = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    monkeypatch.setattr(sys, "argv", ["label", *argv, "--out", jout])
    jlabel.main()
    label.main([*argv, "--device", "cpu", "--out", out])
    got, want = json.load(open(out)), json.load(open(jout))
    ann, jann = got.pop("annotation"), want.pop("annotation")
    assert got.pop("device") == "cpu"
    assert got == want
    assert ann["residual_error_est"] == pytest.approx(
        jann.pop("residual_error_est"), abs=1e-6)
    ann.pop("residual_error_est")
    assert ann == jann
    assert got["ledger"]["human_votes"] == ann["votes"]


def test_state_file_preempt_and_resume(tmp_path, capsys):
    """Preempted every two iterations and resumed from ``--state`` (with
    the commit cursor cut every page), the campaign ends where the
    uninterrupted one does; its trace diffs clean against it and replays
    to its report."""
    base = ["--live", "--device", "cpu", "--pool", "1500", "--seed", "3",
            "--sweep-page", "512"]
    plain = str(tmp_path / "plain.json")
    ptrace = str(tmp_path / "plain.jsonl")
    label.main(base + ["--out", plain, "--trace", ptrace])
    capsys.readouterr()
    state, out = str(tmp_path / "state.json"), str(tmp_path / "res.json")
    trace = str(tmp_path / "prem.jsonl")
    hops = 0
    while True:
        label.main(base + ["--state", state, "--iters-per-run", "2",
                           "--sweep-ckpt-pages", "1", "--trace", trace,
                           "--out", out, "--fit-async", "--sweep-async"])
        hops += 1
        assert hops < 20
        if not os.path.exists(state):
            break
        assert json.loads(capsys.readouterr().out)["resumable"]
    assert hops > 1
    got, want = json.load(open(out)), json.load(open(plain))
    for k in ("decision", "cost", "measured_error", "iterations", "S_frac",
              "B_frac"):
        assert got[k] == want[k], k
    capsys.readouterr()
    label.main(["--trace-diff", ptrace, trace])
    assert json.loads(capsys.readouterr().out) == {"identical": True}
    label.main(["--trace-replay", trace])
    rp = json.loads(capsys.readouterr().out)
    assert rp["cost"] == want["cost"] and rp["decision"] == want["decision"]
    assert rp["runtime"] == {"sweep_async": True, "fit_async": True}
    assert np.isclose(rp["S_size"] / 1500, want["S_frac"])


def test_chaos_metrics_health_report_matches_jax(tmp_path, monkeypatch):
    """The noisy replay campaign under ``--chaos`` with ``--metrics``,
    ``--slo`` and ``--prom`` through both launchers: the same report,
    its ``chaos`` (faults fired and sites ticked), ``metrics`` and
    ``health`` keys included, and traces that diff clean against each
    other and against a fault-free run."""
    from repro_torch.trace import diff
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"cost_per_label_max": 0.02}))
    base = ["--dataset", "cifar10", "--annotator-noise", "0.2",
            "--label-repeats", "3", "--annotator-aggregate", "ds"]

    def argv(tag, chaos=True):
        d = tmp_path / tag
        d.mkdir()
        return base + (["--chaos", "--chaos-seed", "3"] if chaos else []) \
            + ["--trace", str(d / "t.jsonl"), "--metrics",
               str(d / "m.jsonl"), "--slo", str(slo), "--prom",
               str(d / "m.prom"), "--out", str(d / "r.json")], d

    ja, jd = argv("jax")
    monkeypatch.setattr(sys, "argv", ["label", *ja])
    jlabel.main()
    pa, pd = argv("port")
    label.main([*pa, "--device", "cpu"])
    ca, cd = argv("clean", chaos=False)
    label.main([*ca, "--device", "cpu"])
    got, want = (json.load(open(pd / "r.json")),
                 json.load(open(jd / "r.json")))
    assert got["chaos"] == want["chaos"]
    assert got["chaos"]["faults_injected"] > 0
    assert got["health"] == want["health"]
    assert got["health"]["slo_breaches"] > 0
    for k in ("decision", "cost", "ledger", "iterations", "theta_final"):
        assert got[k] == want[k], k
    assert diff(str(pd / "t.jsonl"), str(jd / "t.jsonl")) is None
    assert diff(str(pd / "t.jsonl"), str(cd / "t.jsonl")) is None
    assert (pd / "m.prom").read_text().startswith("# TYPE repro_")
