"""The serving engine over a mesh against the reference's, on four gloo
ranks against its four forced CPU devices.

* ``ServeEngine(mesh=, policy=)`` on a ("data", "model") mesh of (2, 2),
  under ``tp`` and ``fsdp_tp``, for qwen2-1.5b's and dbrx-132b's smoke
  configs in fp32 from the reference's initial parameters: ``score`` on 4
  rows, ``score_pool`` over 12 rows in pages of 4 (the stats, and the
  top 5 by margin through ``TopKSink``) and ``generate`` (3 steps) equal
  the reference's ``ServeEngine(mesh=)``: tokens and top-k exactly, the
  stats within 1e-5.  Against the port's unmeshed engine likewise: tokens,
  top-k and top1 exactly, the stats within 1e-5 (each "model" rank
  computes its MLP columns, experts and vocabulary block, and the sums
  over "model" round in their own order; dbrx with
  capacity factor 8, since the MoE's capacity
  counts a forward's rows (a rank's, over a mesh, as in the reference),
  so at the config's capacity the meshed and unmeshed engines drop
  different copies: 0.018 apart in margin on these inputs).
* On a forced one-rank mesh (``force=True``: every collective of the
  split, over axes of one rank), the same engines equal the unmeshed
  engine bit for bit, every key.
* gemma3-4b's smoke config with ``sharding="seq_serve"`` on a (1, 4)
  mesh, 32 tokens (8 a rank: the window of 8 fits, so the local layers
  exchange a halo): the prefill's last hidden states and the greedy
  tokens meet the reference's within 2e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-1.5b", "dbrx-132b")
POLICIES = ("tp", "fsdp_tp")
B, T, POOL, PAGE, K, GEN = 4, 16, 12, 4, 5, 3
SEQ_B, SEQ_T = 2, 32
TOL = 1e-5

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.models.registry import get_model
from repro.serving.engine import ServeEngine
from repro.serving.sweep import TopKSink
data = np.load(sys.argv[1])
archs, policies, (B, T, page, k, gen, sb, st) = %r, %r, %r
out = {}
mesh = make_mesh((2, 2), ("data", "model"), axis_types=True)
for arch in archs:
    cfg = get_smoke(arch).replace(dtype="float32")
    model = get_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.key(0)))
    req = {"tokens": jnp.asarray(data[arch + ".req"])}
    pool = {"tokens": data[arch + ".pool"]}
    for policy in policies:
        tag = arch + "." + policy
        with mesh:
            eng = ServeEngine(model, params, T + 8, B, mesh=mesh,
                              policy=policy)
            for name, s in zip(("margin", "entropy", "max_logprob", "top1"),
                               eng.score(req)):
                out[tag + ".score." + name] = np.asarray(s)
            for name, s in zip(("margin", "entropy", "max_logprob", "top1"),
                               eng.score_pool(pool, page_rows=page)):
                out[tag + ".pool." + name] = np.asarray(s)
            out[tag + ".topk"] = np.asarray(
                eng.score_pool(pool, page_rows=page, sink=TopKSink(k)))
            out[tag + ".gen"] = np.asarray(eng.generate(req, gen))
mesh = make_mesh((1, 4), ("data", "model"), axis_types=True)
cfg = get_smoke("gemma3-4b").replace(dtype="float32", sharding="seq_serve")
model = get_model(cfg)
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      model.init(jax.random.key(0)))
req = {"tokens": jnp.asarray(data["gemma3.req"])}
with mesh:
    hidden, _ = jax.jit(lambda p, b: model.prefill(p, b, mesh=mesh))(
        params, req)
    eng = ServeEngine(model, params, st + 8, sb, mesh=mesh,
                      policy="seq_serve")
    out["gemma3.last"] = np.asarray(hidden[:, -1, :])
    out["gemma3.gen"] = np.asarray(eng.generate(req, gen))
np.savez(sys.argv[2], **out)
""" % (ARCHS, POLICIES, (B, T, PAGE, K, GEN, SEQ_B, SEQ_T))

STATS = ("margin", "entropy", "max_logprob", "top1")


def _engine_results(eng, req, pool):
    from repro_torch.serving.sweep import TopKSink
    out = {}
    for name, s in zip(STATS, eng.score(req)):
        out["score." + name] = s.numpy()
    for name, s in zip(STATS, eng.score_pool(pool, page_rows=PAGE)):
        out["pool." + name] = s.numpy()
    out["topk"] = np.asarray(eng.score_pool(pool, page_rows=PAGE,
                                            sink=TopKSink(K)))
    out["gen"] = eng.generate(req, GEN).numpy()
    eng.close()
    return out


def _serve_rank(rank, world, data, params):
    """Every case of the file on this rank: the meshed engines, and on rank
    0 the unmeshed ones they are held to."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in ARCHS:
        p = {k: v.float() for k, v in params[arch].items()}
        req = {"tokens": data[arch + ".req"]}
        pool = {"tokens": data[arch + ".pool"]}
        base = get_smoke(arch).replace(dtype="float32")
        caps = [("", base)]
        if base.family == "moe":
            caps.append((".cap8", base.replace(moe_capacity_factor=8.0)))
        for suffix, cfg in caps:
            model = get_model(cfg)
            for policy in POLICIES:
                got = _engine_results(
                    ServeEngine(model, p, T + 8, B, device="cpu", mesh=mesh,
                                policy=policy), req, pool)
                out.update({f"{arch}{suffix}.{policy}.{k}": v
                            for k, v in got.items()})
            if rank == 0:
                got = _engine_results(ServeEngine(model, p, T + 8, B,
                                                  device="cpu"), req, pool)
                out.update({f"{arch}{suffix}.plain.{k}": v
                            for k, v in got.items()})
    seq_mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    cfg = get_smoke("gemma3-4b").replace(dtype="float32",
                                         sharding="seq_serve")
    model = get_model(cfg)
    p = {k: v.float() for k, v in params["gemma3-4b"].items()}
    eng = ServeEngine(model, p, SEQ_T + 8, SEQ_B, device="cpu",
                      mesh=seq_mesh, policy="seq_serve")
    req = {"tokens": torch.as_tensor(data["gemma3.req"])}
    from repro_torch.distributed.sharding import MeshView
    with torch.no_grad():
        hidden, _ = model.prefill(eng.params, req, mesh=MeshView(seq_mesh))
    out["gemma3.last"] = hidden[:, -1, :].numpy()
    out["gemma3.gen"] = eng.generate(req, GEN).numpy()
    return out


def _one_rank_serve(rank, world, data):
    """Every arch and policy of the file on a forced one-rank mesh, and
    unmeshed, from the port's initial parameters in fp32."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    for arch in ARCHS:
        model = get_model(get_smoke(arch).replace(dtype="float32"))
        p = {k: v.float() for k, v in model.init(0, device="cpu").items()}
        req = {"tokens": data[arch + ".req"]}
        pool = {"tokens": data[arch + ".pool"]}
        engines = [("plain", {})] + [
            (policy, dict(mesh=mesh, policy=policy, force=True))
            for policy in POLICIES]
        for name, kw in engines:
            eng = ServeEngine(model, p, T + 8, B, device="cpu", **kw)
            if kw:   # the heads are stored split over "model"
                out[f"{arch}.{name}.split"] = "model" in shd.spec_of(
                    eng.params["blocks.attn.wq"])
            got = _engine_results(eng, req, pool)
            out.update({f"{arch}.{name}.{k}": v for k, v in got.items()})
    return out


def test_one_rank_meshed_engine_is_the_unmeshed_engine_to_the_bit():
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(1)
    data = {}
    for arch in ARCHS:
        v = get_smoke(arch).vocab_size
        data[arch + ".req"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[arch + ".pool"] = rng.integers(0, v, (POOL, T)).astype(np.int32)
    got, = run_ranks(_one_rank_serve, 1, "cpu", args=(data,), threads=1,
                     timeout=120)
    keys = [k[len(ARCHS[0]) + 7:] for k in got
            if k.startswith(ARCHS[0] + ".plain.")]
    assert len(keys) == 2 * len(STATS) + 2
    for arch in ARCHS:
        for policy in POLICIES:
            assert got[f"{arch}.{policy}.split"], (arch, policy)
            for k in keys:
                np.testing.assert_array_equal(
                    got[f"{arch}.{policy}.{k}"], got[f"{arch}.plain.{k}"],
                    err_msg=f"{arch} {policy} {k} on one forced rank")


def _close(a, b, what):
    if np.asarray(a).dtype.kind in "iu":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


def test_meshed_engine_and_seq_serve_meet_the_reference(tmp_path):
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import params_from_jax
    rng = np.random.default_rng(0)
    data = {}
    for arch in ARCHS:
        v = jget_smoke(arch).vocab_size
        data[arch + ".req"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[arch + ".pool"] = rng.integers(0, v, (POOL, T)).astype(np.int32)
    data["gemma3.req"] = rng.integers(
        0, jget_smoke("gemma3-4b").vocab_size, (SEQ_B, SEQ_T)).astype(np.int32)
    np.savez(tmp_path / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        params = {a: params_from_jax(jax.tree.map(
            np.asarray, jget_model(jget_smoke(a)).init(jax.random.key(0))),
            device="cpu") for a in ARCHS + ("gemma3-4b",)}
        ranks = run_ranks(_serve_rank, 4, "cpu", args=(data, params),
                          threads=1, timeout=120)
    finally:
        _, err = ref.communicate(timeout=120)
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "out.npz")
    got = ranks[0]
    keys = ["score." + s for s in STATS] + ["pool." + s for s in STATS] \
        + ["topk", "gen"]
    for rank, r in enumerate(ranks[1:], 1):   # every rank returns the same
        for k, v in r.items():
            np.testing.assert_array_equal(v, got[k], err_msg=f"rank {rank} {k}")
    for arch in ARCHS:
        for policy in POLICIES:
            for k in keys:
                _close(got[f"{arch}.{policy}.{k}"],
                       want[f"{arch}.{policy}.{k}"],
                       f"{arch} {policy} {k} against the reference")
        unmeshed = arch + (".cap8" if arch == "dbrx-132b" else "")
        for policy in POLICIES:
            for k in keys:
                _close(got[f"{unmeshed}.{policy}.{k}"],
                       got[f"{unmeshed}.plain.{k}"],
                       f"{unmeshed} {policy} {k} against unmeshed")
    np.testing.assert_allclose(got["gemma3.last"], want["gemma3.last"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got["gemma3.gen"], want["gemma3.gen"])
