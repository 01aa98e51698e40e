"""Halo-exchange windowed attention on four ranks (gloo, a ("model",) mesh
of 4) against the port's whole-sequence windowed ``blockwise_attention``
and against the reference's halo output on its four forced CPU devices:
the three cases of ``tests/test_halo_attention.py``, error at most 2e-5."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CASES = [(2, 128, 4, 4, 16, 16), (1, 256, 4, 2, 8, 64), (2, 64, 2, 2, 8, 16)]
TOL = 2e-5

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.serving.halo_attention import halo_window_attention
mesh = make_mesh((4,), ("model",), axis_types=True)
out = {}
data = np.load(sys.argv[1])
for i, (B, T, H, Hk, hd, w) in enumerate(%r):
    q, k, v = (jnp.asarray(data[f"{n}{i}"]) for n in "qkv")
    with mesh:
        out[f"o{i}"] = np.asarray(halo_window_attention(
            q, k, v, window=w, mesh=mesh, axis="model", batch_axes=()))
np.savez(sys.argv[2], **out)
""" % (CASES,)


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for i, (B, T, H, Hk, hd, w) in enumerate(CASES):
        out[f"q{i}"] = rng.normal(size=(B, T, H, hd)).astype(np.float32)
        out[f"k{i}"] = rng.normal(size=(B, T, Hk, hd)).astype(np.float32)
        out[f"v{i}"] = rng.normal(size=(B, T, Hk, hd)).astype(np.float32)
    return out


def _halo_rank(rank, world, data):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.halo_attention import halo_window_attention
    mesh = make_mesh((world,), ("model",), "cpu")
    outs = []
    for i, (B, T, H, Hk, hd, w) in enumerate(CASES):
        loc = T // world
        q, k, v = (torch.as_tensor(data[f"{n}{i}"][:, rank * loc:
                                                   (rank + 1) * loc])
                   for n in "qkv")
        outs.append(halo_window_attention(q, k, v, window=w, mesh=mesh,
                                          axis="model").numpy())
    return outs


def test_halo_matches_windowed_attention_and_the_reference(tmp_path):
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.layers import blockwise_attention
    data = _inputs()
    np.savez(tmp_path / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_halo_rank, 4, "cpu", args=(data,), threads=1,
                          timeout=240)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    jref = np.load(tmp_path / "out.npz")
    errs = {}
    for i, (B, T, H, Hk, hd, w) in enumerate(CASES):
        got = np.concatenate([r[i] for r in ranks], axis=1)
        want = blockwise_attention(*(torch.as_tensor(data[f"{n}{i}"])
                                     for n in "qkv"), causal=True,
                                   window=w, kv_chunk=32).numpy()
        errs[f"{B}x{T}x{H}x{Hk}x{hd}w{w}"] = (
            float(np.max(np.abs(got - want))),
            float(np.max(np.abs(got - jref[f"o{i}"]))))
    assert all(a <= TOL and b <= TOL for a, b in errs.values()), \
        json.dumps(errs)
