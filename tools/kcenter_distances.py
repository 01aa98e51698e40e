#!/usr/bin/env python3
"""Which distances steer the k-center campaign of ``chip_smoke.py``.

    python3 tools/kcenter_distances.py [--pool 50000] [--max-iters 200]
                                       [--device cuda]

Runs the k-center MCAL campaign of ``chip_smoke.py`` (the same data,
config and seed: ``make_classification(pool, 10 classes, dim 32)``,
eps_target 0.05) once per route, in one process.  A route says what
computes the two functions of the campaign's path, ``kernels.ops``
``pairwise_sqdist`` and ``score_head``:

- ``kernels``: the hand-written kernels, as the main path runs them;
- ``split``: ``pairwise_sqdist`` by ``ref.pairwise_sqdist_split_ref``
  (x.c as the kernel takes it, six bf16 products, in plain PyTorch on the
  same device), ``score_head`` by the kernel;
- ``plain``: ``pairwise_sqdist`` by ``ref.pairwise_sqdist_ref`` (fp32
  x.c), ``score_head`` by the kernel;
- ``plain_all``: both functions by their plain versions.

On a CPU device every route but ``split`` runs the plain versions.  For
each route it prints the decision, |B|, |S|, cost, measured error,
iterations and the calls of each function (on a card, after the card's
name and power limit).  In the ``kernels`` route each
k-center selection is made again on the same inputs with each plain
version of the distances (calls not counted); printed are the first
position where its picks leave the kernel's (-1: none) and there the two
candidates' min distances to the centres before it, in fp64, with their
relative gap.  The last line
is one JSON object of all of it.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROUTES = ("kernels", "split", "plain", "plain_all")


def first_difference(a, b) -> int:
    """The first position where two index sequences differ, else -1."""
    n = min(len(a), len(b))
    diff = [i for i in range(n) if a[i] != b[i]]
    return diff[0] if diff else (-1 if len(a) == len(b) else n)


def exact_gap(torch, features, anchors, ours, theirs, i, device):
    """Where two greedy selections first part (pick ``i``, the same
    centres before it): each candidate's min squared distance to those
    centres in fp64, and their gap over the larger.  A gap near fp32's
    rounding of the distances is a near-tie that the rounding decides."""
    f = torch.as_tensor(features, device=device).double()
    centres = [f[torch.as_tensor(ours[:i], device=device)]]
    if anchors is not None and len(anchors):
        centres.append(torch.as_tensor(anchors, device=device).double())
    cs = torch.cat(centres)
    a, b = (float(((f[int(j)] - cs) ** 2).sum(-1).min())
            for j in (ours[i], theirs[i]))
    return {"ours": a, "theirs": b, "rel_gap": abs(a - b) / max(a, b)}


def run_route(route, x, y, args):
    import torch
    from repro_torch.core import AMAZON, LiveTask, MCALConfig, run_mcal
    from repro_torch.core import selection_device as sd
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import ScoreStats

    calls = {"pairwise_sqdist": 0, "score_head": 0}
    checks = []
    pairwise, score_head = ops.pairwise_sqdist, ops.score_head
    greedy = sd.k_center_greedy_device
    # what computes the distances; "counted" is off for the kernels route's
    # extra selections
    now = {"pairwise": {"kernels": "kernels", "split": "split",
                        "plain": "plain", "plain_all": "plain"}[route],
           "counted": True}

    def routed_pairwise(a, c):
        calls["pairwise_sqdist"] += now["counted"]
        if now["pairwise"] == "split":
            return ref.pairwise_sqdist_split_ref(a, c)
        if now["pairwise"] == "plain":
            return ref.pairwise_sqdist_ref(a, c)
        return pairwise(a, c)

    def routed_head(hidden, w):
        calls["score_head"] += 1
        if route != "plain_all":
            return score_head(hidden, w)
        lead = hidden.shape[:-1]
        outs = ref.margin_head_ref(hidden.reshape(-1, hidden.shape[-1]), w)
        return ScoreStats(*(o.reshape(lead) for o in outs))

    def checked_greedy(features, k, anchors=None, **kw):
        """The kernels route's selection, made again with each plain
        version of the distances on the same inputs."""
        picks = {}
        for name in ("split", "plain", "kernels"):
            now["pairwise"], now["counted"] = name, name == "kernels"
            picks[name] = greedy(features, k, anchors=anchors, **kw)
        n_anchors = 0 if anchors is None else len(anchors)
        check = {"k": int(k), "anchors": int(n_anchors)}
        for name in ("split", "plain"):
            i = first_difference(picks["kernels"], picks[name])
            check[f"{name}_first_difference"] = i
            if i >= 0:
                check[f"{name}_gap_at_difference"] = exact_gap(
                    torch, features, anchors, picks["kernels"],
                    picks[name], i, args.device)
        checks.append(check)
        return picks["kernels"]

    ops.pairwise_sqdist, ops.score_head = routed_pairwise, routed_head
    if route == "kernels":
        sd.k_center_greedy_device = checked_greedy
    try:
        task = LiveTask(features=x, groundtruth=y, num_classes=10,
                        device=args.device)
        res = run_mcal(task, AMAZON, MCALConfig(
            eps_target=0.05, seed=0, metric="kcenter",
            max_iters=args.max_iters))
    finally:
        ops.pairwise_sqdist, ops.score_head = pairwise, score_head
        sd.k_center_greedy_device = greedy
    return {"route": route, "decision": res.decision, "B": res.B_size,
            "S": res.S_size, "cost": res.total_cost,
            "measured_error": res.measured_error,
            "iterations": len(res.history), "calls": calls,
            "selections": checks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=50_000)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from repro_torch.data.synth import make_classification

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        sys.path.insert(0, str(ROOT))
        from chip_smoke import card_line
        print(card_line(), flush=True)
    x, y = make_classification(args.pool, num_classes=10, dim=32,
                               difficulty=0.3, seed=0)
    out = []
    for route in ROUTES:
        r = run_route(route, x, y, args)
        out.append(r)
        print(f"route={route} pool={args.pool}: decision {r['decision']}, "
              f"|B| {r['B']}, |S| {r['S']}, cost {r['cost']:.2f}, measured "
              f"error {r['measured_error']:.5f}, iterations "
              f"{r['iterations']}, calls {r['calls']}", flush=True)
        for c in r["selections"]:
            print("  k-center selection: " + ", ".join(
                f"{k} {v}" for k, v in c.items()), flush=True)
    print(json.dumps({"pool": args.pool, "device": args.device,
                      "routes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
