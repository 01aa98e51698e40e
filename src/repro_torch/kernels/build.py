"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Builds go to
``build/repro_torch_kernels/<hash>/`` at the repo root, keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one is
loaded as built.  All sources build at the first use of any kernel, one
``nvcc`` each, started together, once per process whatever the threads:
:data:`LOCK` guards the build, the loaded libraries and each wrapper's
cache of typed entry points.  A failed build raises with nvcc's output;
there is no fallback.  :func:`call` runs an entry point on PyTorch's
current stream of a tensor's device; each wrapper counts its launches
under :data:`COUNT_LOCK`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# one build and one load per process, and the wrappers' entry-point caches
# (reentrant: a wrapper's first use loads under it)
LOCK = threading.RLock()
# the wrappers' ``launches += 1`` (threads would drop increments)
COUNT_LOCK = threading.Lock()
# nvcc's output per source (ptxas registers / shared memory / spills)
LOG: Dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built (in parallel); return the
    library path of each."""
    with LOCK:
        return _build_all()


def _build_all() -> Dict[str, Path]:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in sources()}
    todo = {name: src for name, src in sources().items()
            if not libs[name].exists()}
    procs = {}
    for name, src in todo.items():
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        LOG[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{LOG[name]}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with LOCK:
        if name not in _libs:
            for n, path in build_all().items():
                _libs.setdefault(n, ctypes.CDLL(str(path)))
        return _libs[name]


def stream(index: int) -> int:
    """The raw handle of PyTorch's current CUDA stream on device ``index``,
    read without building a Stream object (what Triton's launcher reads)."""
    return torch._C._cuda_getCurrentRawStream(index)


def call(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on PyTorch's current stream of the CUDA
    ``device``, made the current device only where it is not already;
    returns ``fn``'s CUDA error code (0 for success)."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, stream(index))
    with torch.cuda.device(index):
        return fn(*args, stream(index))
