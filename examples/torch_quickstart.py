"""Quickstart on the PyTorch port: label an emulated CIFAR-10 pool with
MCAL at minimum cost (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]

Runs in seconds: MCAL learns the truncated power-law error model on the
fly, jointly picks (|B|, theta), and labels the whole 50k pool ~3x cheaper
than the $2,000 human-only bill while keeping labeling error under 5%.
The emulator's draws are numpy, so the report is ``quickstart.py``'s line
for line.  ``--device`` is where the task's device work runs (default
cuda); the tests run it with ``--device cpu``.
"""
import argparse

from repro_torch.core import AMAZON, MCALConfig, make_emulated_task, run_mcal

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

task = make_emulated_task("cifar10", "resnet18", seed=0, device=args.device)
result = run_mcal(task, AMAZON, MCALConfig(eps_target=0.05, seed=0))

X = task.pool_size
print(f"pool size            : {X:,}")
print(f"decision             : {result.decision}")
print(f"human-labeled (train): {result.B_size:,} ({result.B_size / X:.1%})")
print(f"machine-labeled      : {result.S_size:,} ({result.S_size / X:.1%})")
print(f"measured label error : {result.measured_error:.2%} (bound: 5%)")
print(f"total cost           : ${result.total_cost:,.0f}"
      f"  (human-only: ${X * AMAZON.price_per_label:,.0f})")
print(f"savings              : "
      f"{1 - result.total_cost / (X * AMAZON.price_per_label):.1%}")
print("\nper-iteration trace (C* = predicted optimal cost):")
for rec in result.history:
    print(f"  it {rec.i:2d}  |B|={rec.B_size:6,}  delta={rec.delta:6,}  "
          f"C*=${rec.cstar:7,.0f}  B_opt={rec.B_opt:6,}  "
          f"theta*={rec.theta_opt:.2f}")
