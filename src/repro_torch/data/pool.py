"""Unlabeled-pool bookkeeping for labeling campaigns (``repro.data.pool``;
numpy only, and its files are the reference's: either package loads what
the other saved).

A thin, explicit state machine over sample indices: every sample is in
exactly one of {unlabeled, test, train(B), machine(S), residual-human}.
The MCAL driver keeps richer per-iteration state; this class is the
serving-side view used by the launch/label CLI and the checkpointable
campaign state (a campaign can be preempted and resumed mid-loop).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

UNLABELED, TEST, TRAIN, MACHINE, HUMAN = 0, 1, 2, 3, 4
_STATE_NAMES = {0: "unlabeled", 1: "test", 2: "train", 3: "machine", 4: "human"}


@dataclasses.dataclass
class LabelPool:
    size: int

    def __post_init__(self):
        self.state = np.zeros(self.size, np.int8)
        self.labels = np.full(self.size, -1, np.int64)

    # -- transitions --------------------------------------------------------
    def mark(self, idx: np.ndarray, state: int,
             labels: Optional[np.ndarray] = None):
        idx = np.asarray(idx, np.int64)
        self.state[idx] = state
        if labels is not None:
            self.labels[idx] = labels

    def indices(self, state: int) -> np.ndarray:
        return np.nonzero(self.state == state)[0]

    @property
    def unlabeled(self) -> np.ndarray:
        return self.indices(UNLABELED)

    def counts(self) -> Dict[str, int]:
        return {_STATE_NAMES[s]: int(np.sum(self.state == s))
                for s in _STATE_NAMES}

    # -- persistence (campaign fault tolerance) -----------------------------
    def save(self, path: str):
        tmp = path + ".tmp"
        np.savez(tmp, state=self.state, labels=self.labels)
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    @classmethod
    def load(cls, path: str) -> "LabelPool":
        z = np.load(path)
        p = cls(size=len(z["state"]))
        p.state = z["state"]
        p.labels = z["labels"]
        return p
