"""Architecture registry (``repro.configs``): ``get_config(arch_id)`` and
``get_smoke(arch_id)`` give the full and reduced configs of the ported
architectures and raise for the others."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401

# the reference's ARCH_IDS that the port serves so far
ARCH_IDS = ("zamba2-2.7b", "qwen2-1.5b", "gemma3-4b", "qwen1.5-4b",
            "phi3-medium-14b")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ported: "
            f"{', '.join(ARCH_IDS)})")
    name = arch_id.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
