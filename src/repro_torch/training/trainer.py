"""Trainer (``repro.training.trainer``): loader + train step + checkpoint +
straggler monitor.

* builds the train step: over a ``mesh`` with ``batch_pspecs`` the
  policy-sharded one (``train_loop.make_sharded_train_step``; the state
  stored as ``policy`` shards it, batches from ``ShardedLoader(mesh=)``),
  else the unsharded one (the reference's rule: a mesh without
  ``batch_pspecs`` trains unsharded, every rank the same step);
  ``grad_compression="int8_ef"`` is refused here: it trains through
  ``training.compressed_dp``'s step alone;
* resumes from the latest published checkpoint if one exists (onto the
  mesh, each rank reading its blocks: ``checkpoint.restore(shardings=)``);
* checkpoints every ``ckpt_every`` steps, atomically, and once at the end
  (over a mesh every rank gathers, rank 0 alone writes and logs);
* times each step through the StragglerMonitor, reading the loss back once
  a step (the reference's ``block_until_ready``), so a step's time spans
  its device work.

The same class drives the smoke train runs and ``launch/train.py``.  It
takes any batch dict the model's loss takes (an audio model's
``audio_frames``, a VLM's ``patch_embeds`` included).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.training.train_loop import (init_train_state,
                                             make_sharded_train_step,
                                             make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = ""
    ckpt_every: int = 100
    log_every: int = 10
    max_steps: int = 1000


class Trainer:
    """``params``, where given, is the state's starting point in place of
    ``model.init(seed)`` (a caller that already holds the weights); a
    published checkpoint overrides either."""

    def __init__(self, model, tc: TrainConfig, tcfg: TrainerConfig,
                 mesh=None, policy: str = "fsdp_tp",
                 batch_pspecs: Optional[Dict] = None, seed: int = 0,
                 log_fn: Callable[[str], None] = print, device="cuda",
                 params: Optional[Dict] = None, force: bool = False):
        if tc.grad_compression != "none":
            raise NotImplementedError(
                f"grad_compression={tc.grad_compression!r} trains through "
                f"training.compressed_dp.make_compressed_dp_train_step on "
                f"a mesh; Trainer trains uncompressed")
        self.model = model
        self.tc = tc
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = device
        self.monitor = StragglerMonitor()
        self.rank0 = _rank() == 0
        self.log = log_fn if self.rank0 else (lambda msg: None)
        if mesh is not None and batch_pspecs is not None:
            self.step_fn, _, self.state_sh = make_sharded_train_step(
                model, tc, mesh, policy, batch_pspecs, force=force)
        else:
            self.step_fn, self.state_sh = make_train_step(model, tc), None
        self.state = self._init_or_resume(seed, params)

    def _init_or_resume(self, seed: int, params: Optional[Dict]):
        if params is None:
            params = self.model.init(seed, device=self.device)
        state = init_train_state(self.model, self.tc, params)
        if self.state_sh is not None:
            state = shd.shard_tree(state, self.state_sh)
        if self.tcfg.ckpt_dir:
            last = ckpt.latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                state, _ = ckpt.restore(self.tcfg.ckpt_dir, last, state,
                                        shardings=self.state_sh)
                self.log(f"[trainer] resumed from step {last}")
        return state

    def _save(self, step: int) -> None:
        """Every rank gathers a sharded state; rank 0 writes; the ranks
        meet after it, so none reads a checkpoint before it is
        published."""
        ckpt.save(self.tcfg.ckpt_dir, step, self.state, write=self.rank0)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def fit(self, batches: Iterable[Dict]) -> Dict[str, Any]:
        last_metrics: Dict[str, Any] = {}
        for batch in batches:
            if self.step >= self.tcfg.max_steps:
                break
            self.monitor.start()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = dict(metrics, loss=float(metrics["loss"]))
            event = self.monitor.stop()
            if event is not None:
                self.log(f"[trainer] straggler at step {event.step}: "
                         f"{event.duration * 1e3:.0f}ms vs median "
                         f"{event.median * 1e3:.0f}ms")
            s = self.step
            if self.tcfg.log_every and s % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {s} loss {metrics['loss']:.4f}")
            if self.tcfg.ckpt_dir and self.tcfg.ckpt_every and \
                    s % self.tcfg.ckpt_every == 0:
                self._save(s)
            last_metrics = metrics
        if self.tcfg.ckpt_dir:
            self._save(self.step)
        return {k: float(v) for k, v in last_metrics.items()}


def _rank() -> int:
    """This process's rank in the initialized process group (0 without
    one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0
