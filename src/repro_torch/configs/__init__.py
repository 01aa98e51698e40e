"""Architecture registry (``repro.configs``): ``get_config(arch_id)`` and
``get_smoke(arch_id)`` give the full and reduced configs of the ported
architectures (every one of the reference's ``ARCH_IDS`` since whisper-tiny)
and raise for any other id.  ``cells(arch_id)`` lists the (shape) cells
defined for an architecture.  ``input_specs`` and ``input_pspecs`` give the
step inputs of a (config x shape) cell and their partition specs, as
``(shape, dtype)`` pairs in place of the reference's ``ShapeDtypeStruct``s."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME,  # noqa: F401
                                      ModelConfig, ShapeConfig, TrainConfig)

# the reference's ARCH_IDS, all ported
ARCH_IDS = ("zamba2-2.7b", "qwen2-1.5b", "gemma3-4b", "qwen1.5-4b",
            "phi3-medium-14b", "mamba2-1.3b", "dbrx-132b", "kimi-k2-1t-a32b",
            "internvl2-26b", "whisper-tiny")

# long_500k needs sub-quadratic attention; pure full-attention archs skip it
LONG_CONTEXT_OK = {"zamba2-2.7b", "mamba2-1.3b", "gemma3-4b"}


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


def cells(arch_id: str):
    """The (shape) cells defined for this arch (applies the long_500k
    skip)."""
    return [s for s in SHAPES
            if s.name != "long_500k" or arch_id in LONG_CONTEXT_OK]


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                grad_accum: int = 1) -> Dict[str, Tuple]:
    """``{input: (shape, dtype)}`` of a cell's token-side step inputs: the
    tokens (one a row when decoding), a VLM's fp32 ``patch_embeds``, an
    audio model's fp32 ``audio_frames``, and a train cell's labels.
    ``grad_accum > 1`` pre-splits train batches to (A, B // A, ...): the
    microbatch dim leads and is never sharded."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "decode":
        specs = {"tokens": ((B, 1), i32)}
    else:
        if cfg.family == "vlm" and cfg.frontend_tokens:
            specs = {"tokens": ((B, S - cfg.frontend_tokens), i32),
                     "patch_embeds": ((B, cfg.frontend_tokens, cfg.d_model),
                                      f32)}
        elif cfg.family == "audio":
            specs = {"tokens": ((B, S), i32),
                     "audio_frames": ((B, cfg.encoder_tokens, cfg.d_model),
                                      f32)}
        else:
            specs = {"tokens": ((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = ((B, specs["tokens"][0][1]), i32)
            if grad_accum > 1:
                assert B % grad_accum == 0, (B, grad_accum)
                specs = {k: ((grad_accum, sh[0] // grad_accum) + sh[1:], dt)
                         for k, (sh, dt) in specs.items()}
    return specs


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh, policy: str,
                 grad_accum: int = 1) -> Dict:
    """Partition specs matching :func:`input_specs`: the batch dim over the
    policy's ``batch`` axes where they divide it (the leading microbatch
    dim, when present, whole)."""
    from repro_torch.distributed.sharding import logical_to_pspec
    accum = grad_accum > 1 and shape.kind == "train"
    out = {}
    for k, (sh, _) in input_specs(cfg, shape, grad_accum).items():
        logical = [None] * len(sh)
        logical[1 if accum else 0] = "batch"
        out[k] = logical_to_pspec(sh, logical, mesh, policy)
    return out
