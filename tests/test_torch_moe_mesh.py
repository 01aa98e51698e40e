"""The MoE's sharded routes on four ranks (gloo, a ("data", "model") mesh
of (2, 2)) against the reference's on its (2, 2) mesh of forced CPU
devices, the scripts of ``tests/test_moe_a2a.py`` with capacity factor 8
(no copy dropped), in fp32: replicate + psum with the gather route, the
a2a route with gather in the weights' dtype and in int8, and the psum FFN
mode.  Held: the forward output and the gradients of <out, ct> with
respect to x, the router and the expert weights, at 1e-4, divided by 50
for int8 as the reference scales it; every rank ends with the same whole
result.  On one rank, ``moe_sharded(force=True)`` (every collective of the
route over axes of one rank, what the card runs) equals the local block:
bit for bit on the replicate, a2a and psum routes, at int8's tolerance on
its gather."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
ROUTES = {"replicate": dict(moe_route="replicate_psum", moe_ffn_mode="gather",
                            moe_gather_dtype="bf16"),
          "a2a_bf16": dict(moe_route="a2a", moe_ffn_mode="gather",
                           moe_gather_dtype="bf16"),
          "a2a_int8": dict(moe_route="a2a", moe_ffn_mode="gather",
                           moe_gather_dtype="int8"),
          "psum_ffn": dict(moe_route="replicate_psum", moe_ffn_mode="psum",
                           moe_gather_dtype="bf16")}
CFG = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=16, vocab_size=64, num_experts=4,
           experts_per_token=2, moe_capacity_factor=8.0, dtype="float32")
LEAVES = ("router", "w_gate", "w_up", "w_down")

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs.base import ModelConfig
from repro.models.transformer import moe_block
data = np.load(sys.argv[1])
routes, cfg = %r, %r
mesh = make_mesh((2, 2), ("data", "model"), axis_types=True)
base = ModelConfig(**cfg)
p = {k: jnp.asarray(data[k]) for k in %r}
x, ct = jnp.asarray(data["x"]), jnp.asarray(data["ct"])
out = {}
for name, kw in list(routes.items()) + [("solo", None)]:
    c = base.replace(**kw) if kw else base
    m = mesh if kw else None
    def f(x, p):
        return moe_block(c, p, x, mesh=m)

    @jax.jit
    def run(x, p, ct):
        y, vjp = jax.vjp(f, x, p)
        return (y,) + vjp(ct)
    with mesh:
        y, gx, gp = run(x, p, ct)
    out[name + ".out"] = np.asarray(y)
    out[name + ".x"] = np.asarray(gx)
    for k, v in gp.items():
        out[name + "." + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
""" % (ROUTES, CFG, LEAVES)


def _inputs():
    rng = np.random.default_rng(0)
    E, D, F = CFG["num_experts"], CFG["d_model"], CFG["d_ff"]
    return {"router": (rng.normal(size=(D, E)) / np.sqrt(D)),
            "w_gate": rng.normal(size=(E, D, F)) / np.sqrt(E * D),
            "w_up": rng.normal(size=(E, D, F)) / np.sqrt(E * D),
            "w_down": rng.normal(size=(E, F, D)) / np.sqrt(E * F),
            "x": rng.normal(size=(2, 8, D)) * 0.5,
            "ct": rng.normal(size=(2, 8, D))}


def _results(cfg, p, x, ct, fn):
    """Forward and the gradients of <out, ct>, numpy."""
    import torch
    x = torch.as_tensor(x).requires_grad_(True)
    p = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    y = fn(cfg, p, x)
    (y * torch.as_tensor(ct)).sum().backward()
    out = {"out": y.detach().numpy(), "x": x.grad.numpy()}
    out.update({k: v.grad.numpy() for k, v in p.items()})
    return out


def _moe_rank(rank, world, data):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    base = ModelConfig(**CFG)
    p = {k: data[k] for k in LEAVES}
    out = {}
    for name, kw in ROUTES.items():
        res = _results(base.replace(**kw), p, data["x"], data["ct"],
                       lambda c, p, x: T.moe_block(c, p, x, mesh))
        out.update({f"{name}.{k}": v for k, v in res.items()})
    return out


def test_sharded_routes_match_the_reference_forward_and_gradients(tmp_path):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    data = {k: v.astype(np.float32) for k, v in _inputs().items()}
    np.savez(tmp_path / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_moe_rank, 4, "cpu", args=(data,), threads=1,
                          timeout=240)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "out.npz")
    errs = {}
    for key, got in ranks[0].items():
        scale = 50.0 if key.startswith("a2a_int8") else 1.0
        errs[key] = float(np.max(np.abs(got - want[key]))) / scale
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key], got, err_msg=key)
    assert max(errs.values()) < TOL, json.dumps(errs)
    # the replicate route is the unmeshed block, as in the reference test
    solo = _results(ModelConfig(**CFG), {k: data[k] for k in LEAVES},
                    data["x"], data["ct"], T.moe_block)
    for k, v in solo.items():
        np.testing.assert_allclose(v, want[f"solo.{k}"], atol=TOL, rtol=0)
        np.testing.assert_allclose(ranks[0][f"replicate.{k}"], v, atol=TOL,
                                   rtol=0)


def _forced_rank(rank, world, data):
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    base = ModelConfig(**CFG)
    p = {k: torch.as_tensor(data[k]) for k in LEAVES}
    x = torch.as_tensor(data["x"])
    local = T._moe_local(base, p, x.reshape(-1, x.shape[-1])).reshape(
        x.shape)
    return {name: (T.moe_sharded(base.replace(**kw), p, x, mesh,
                                 force=True) - local).abs().max().item()
            for name, kw in ROUTES.items()}


def test_forced_routes_on_one_rank_equal_the_local_block():
    from repro_torch.launch.mesh import run_ranks
    data = {k: v.astype(np.float32) for k, v in _inputs().items()}
    errs = run_ranks(_forced_rank, 1, "cpu", args=(data,), threads=1,
                     timeout=120)[0]
    assert errs["a2a_int8"] / 50.0 < TOL, errs
    assert {k: v for k, v in errs.items() if k != "a2a_int8"} == {
        "replicate": 0.0, "a2a_bf16": 0.0, "psum_ffn": 0.0}, errs
