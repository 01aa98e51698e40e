"""Architecture selection + budget-constrained labeling (paper §4) on the
PyTorch port (the twin of ``examples/arch_select.py``).

    PYTHONPATH=src python examples/torch_arch_select.py [--device cuda]

1. MCAL explores CNN18 / ResNet18 / ResNet50 over a SHARED label pool until
   the per-architecture cost predictions stabilize, then continues only the
   cheapest one (labels are bought once; every candidate's training spend is
   the exploration tax).
2. The budget variant flips the optimization: minimize labeling error
   subject to a hard dollar budget.

The emulator's draws are numpy, so the report is ``arch_select.py``'s line
for line.  ``--device`` is where the tasks' device work runs (default
cuda); the tests run it with ``--device cpu``.
"""
import argparse

from repro_torch.core import (AMAZON, MCALConfig, make_emulated_task,
                              run_mcal, select_architecture)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

print("=== architecture selection on emulated CIFAR-10 ===")
tasks = {a: make_emulated_task("cifar10", a, seed=0, device=args.device)
         for a in ("cnn18", "resnet18", "resnet50")}
winner, result, histories = select_architecture(tasks, AMAZON,
                                                MCALConfig(seed=0))
print(f"winner          : {winner}")
print(f"total cost      : ${result.total_cost:,.0f} "
      f"(incl. ${result.ledger['training']:.0f} exploration tax)")
print(f"measured error  : {result.measured_error:.2%}")
for name, hist in histories.items():
    cs = hist[-1].cstar if hist else float("nan")
    print(f"  {name:10s} explored {len(hist):2d} iterations, "
          f"final C* estimate ${cs:,.0f}")

print("\n=== budget-constrained variant ===")
for budget in (600.0, 1000.0, 1500.0):
    task = make_emulated_task("cifar10", "resnet18", seed=0,
                              device=args.device)
    res = run_mcal(task, AMAZON, MCALConfig(seed=0, budget=budget))
    print(f"budget ${budget:6,.0f} -> spent ${res.total_cost:7,.0f}, "
          f"error {res.measured_error:.2%}, machine-labeled {res.S_size:,}")
