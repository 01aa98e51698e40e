"""Meshes and ranks (``repro.launch.mesh``).

JAX drives every device of a mesh from one process; the port runs one
process per rank, as ``torchrun`` does, each with a process group and a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the reference's axis names.  The backend follows the device: ``nccl`` for
``cuda`` (rank r on card r), ``gloo`` for the CPU.  Ranks join through a
``file://`` store (no network), and every group waits at most
:data:`TIMEOUT_S` seconds for a peer, so a rank that dies fails the others
instead of hanging them.

Mesh axes (the reference's):
  single-pod: (16, 16)      -> ("data", "model")      = 256 ranks
  multi-pod:  (2, 16, 16)   -> ("pod", "data", "model") = 512 ranks

:func:`run_ranks` spawns the ranks of one host (the tests' four CPU ranks;
on a card host one rank per card), each running the same function.

Collectives on one group must be issued in the same order on every rank,
but the campaign issues pool passes from several threads (the main
thread, the sweep and fit workers, a fleet's tenant threads).
:func:`thread_groups` gives each named thread its own copy of a mesh
dimension's group, created on every rank in the same order before any of
the threads runs; :func:`group_of_thread` picks the caller's.  Within one
thread the passes come in the campaign's deterministic order.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

TIMEOUT_S = 120   # the longest any rank waits for a peer

# the threads a campaign's pool passes run on: the caller's, and the
# sweep and fit workers (core.worker.SerialWorker names)
CAMPAIGN_THREADS = ("MainThread", "pool-sweep", "fit-engine")


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_cards(world: int, device) -> None:
    """On ``cuda`` each rank takes a card of its own: refuse a world larger
    than this host's card count (never run it on the CPU instead)."""
    import torch
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"a {world}-rank mesh on cuda needs {world} cards, one a "
                f"rank; this host has {cards}")


def init_rank(rank: int, world: int, device="cuda",
              store_dir: Optional[str] = None) -> None:
    """Join this process to a ``world``-rank group as ``rank`` through a
    file store in ``store_dir`` (a fresh temporary directory when None,
    which only a one-rank world can use).  On ``cuda`` rank r takes card
    r."""
    import torch
    import torch.distributed as dist
    check_cards(world, device)
    if store_dir is None:
        if world != 1:
            raise ValueError("ranks of a multi-rank world share a store_dir")
        store_dir = tempfile.mkdtemp(prefix="mesh-store-")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend_for(device),
        init_method="file://" + os.path.join(store_dir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    world (a one-rank world is initialized here when there is none)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if world_size() == 1 and math.prod(shape) == 1:
        import torch.distributed as dist
        if not dist.is_initialized():
            init_rank(0, 1, device)
    if math.prod(shape) != world_size():
        raise ValueError(
            f"a mesh of shape {shape} over axes {axes} needs "
            f"{math.prod(shape)} ranks; this world has {world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``.  It
    raises, naming the world size, anywhere else than on 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device="cuda"):
    """Every rank of the world as a 1-D ``data`` mesh (tests, smoke runs)."""
    return make_mesh((world_size(),), ("data",), device)


def _groups_along(mesh, axis: str) -> List[List[int]]:
    """The rank lists of ``axis``'s groups, one per index of the other
    axes, in mesh order."""
    dim = mesh.mesh_dim_names.index(axis)
    ranks = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.shape[dim])
    return [[int(r) for r in row] for row in ranks.tolist()]


def thread_groups(mesh, axis: str, names: Sequence[str]) -> Dict[str, Any]:
    """``{thread name: its own copy of axis's group}`` for each name in
    ``names``.  ``new_group`` is collective over the whole world: every
    rank calls this with the same names in the same order, from one
    thread, before the named threads issue collectives."""
    import torch.distributed as dist
    out = {}
    for name in names:
        for ranks in _groups_along(mesh, axis):
            g = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=TIMEOUT_S))
            if dist.get_rank() in ranks:
                out[name] = g
    return out


def group_of_thread(groups: Dict[str, Any]):
    """The calling thread's group in ``groups`` (:func:`thread_groups`)."""
    name = threading.current_thread().name
    g = groups.get(name)
    if g is None:
        raise RuntimeError(
            f"thread {name!r} issues collectives without a group of its "
            f"own (groups exist for {sorted(groups)})")
    return g


def _rank_entry(rank: int, fn: Callable, world: int, device, store_dir: str,
                args: tuple, threads: Optional[int]) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    init_rank(rank, world, device, store_dir)
    try:
        out = fn(rank, world, *args)
        tmp = os.path.join(store_dir, f"result.{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(store_dir, f"result.{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, device="cuda",
              store_dir: Optional[str] = None, args: tuple = (), *,
              threads: Optional[int] = None,
              timeout: float = 4 * TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of this
    host joined as one process group, and return each rank's result (a
    picklable value), in rank order.  ``fn`` must be importable (a
    module-level function).  ``threads`` sets each rank's
    ``torch.set_num_threads``.  On ``cuda`` each rank takes its own card:
    a world larger than the card count is refused before any rank starts,
    never run on the CPU instead.  A rank that raises fails the call; a
    world still running after ``timeout`` seconds is killed and raises
    ``TimeoutError``."""
    import torch.multiprocessing as mp
    check_cards(world, device)
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="mesh-store-") if own else store_dir
    os.makedirs(store_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_entry, args=(fn, world, device, store_dir, args, threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} still "
                    f"running after {timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(world):
        with open(os.path.join(store_dir, f"result.{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    if own:
        import shutil
        shutil.rmtree(store_dir, ignore_errors=True)
    return out
