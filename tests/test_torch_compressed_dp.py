"""Int8 error-feedback compression and the compressed data-parallel step
against the reference.

* ``quantize_ef`` bit-equal to the reference's (half-to-even rounding in
  both), and the error-feedback average of ``tests/test_distributed.py``.
* On four gloo ranks of a ("data",) mesh, in one spawn: ``compressed_psum``
  with a different gradient and residual on each rank against the
  reference's shard-map on its four forced CPU devices (means and
  residuals at fp32 rounding, 1e-6 of the gradient's scale), and four
  compressed-DP steps of qwen2-1.5b's smoke config from the reference's
  initial parameters, the batch of ``tests/test_compressed_dp.py``, in
  fp32 (parameters and activations): the losses meet the reference's
  compressed losses within 1e-4 relative; and in the config's bf16
  (parameters and activations), where the two frameworks' forwards
  already part by 4e-5 relative at step 1, before any update, within the
  reference test's own bound, 0.05 |a| + 0.05
  (``tests/test_compressed_dp.py``).  Every residual stays within half
  its scale (and the fp32 rounding of q * scale).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
LOSS_RTOL = 1e-4
# a residual's bound in units of its scale: half a step, plus the fp32
# rounding of q * scale (|q| <= 127) that the subtraction carries
EF_BOUND = 0.5 + 127 * 2.0 ** -24

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke
from repro.configs.base import TrainConfig
from repro.distributed.compression import compressed_psum
from repro.models.registry import get_model
from repro.training.compressed_dp import (init_ef_state,
                                          make_compressed_dp_train_step)
from repro.training import optimizer as opt
data = np.load(sys.argv[1])
mesh = make_mesh((4,), ("data",), axis_types=True)

def body(g, r):
    m, nr = compressed_psum(g[0], r[0], "data")
    return m[None], nr[None]

mean, res = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")))(
    jnp.asarray(data["g"]), jnp.asarray(data["r"]))
tc = TrainConfig(learning_rate=1e-2, schedule="constant")
batch = {"tokens": jnp.asarray(data["tokens"]),
         "labels": jnp.asarray(data["labels"])}
model = get_model(get_smoke("qwen2-1.5b").replace(dtype="float32"))
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      model.init(jax.random.key(0)))
state = {"params": params, "step": jnp.zeros((), jnp.int32),
         "opt": opt.init_slots(jax.tree.leaves(params), tc)}
step = make_compressed_dp_train_step(model, tc, mesh, compress_axis="data")
carry = (state, init_ef_state(params))
losses = []
with mesh:
    for _ in range(%d):
        carry, m = step(carry, batch)
        losses.append(float(m["loss"]))
# the config's bf16
model = get_model(get_smoke("qwen2-1.5b"))
params = model.init(jax.random.key(0))
state = {"params": params, "step": jnp.zeros((), jnp.int32),
         "opt": opt.init_slots(jax.tree.leaves(params), tc)}
step = make_compressed_dp_train_step(model, tc, mesh, compress_axis="data")
carry = (state, init_ef_state(params))
losses_bf16 = []
with mesh:
    for _ in range(%d):
        carry, m = step(carry, batch)
        losses_bf16.append(float(m["loss"]))
np.savez(sys.argv[2], mean=np.asarray(mean), res=np.asarray(res),
         losses=np.asarray(losses), losses_bf16=np.asarray(losses_bf16))
""" % (STEPS, STEPS)


def test_quantize_ef_is_the_reference_bits():
    import jax.numpy as jnp
    import torch
    from repro.distributed.compression import quantize_ef as jquantize
    from repro_torch.distributed.compression import quantize_ef
    rng = np.random.default_rng(3)
    for shape in ((64,), (16, 12), (3, 5, 7)):
        g = rng.normal(size=shape).astype(np.float32)
        r = (rng.normal(size=shape) * 0.01).astype(np.float32)
        # exact halves of the scale, where the rounding mode decides
        g.flat[0], g.flat[1] = 127.0, 0.5
        r.flat[0] = r.flat[1] = 0.0
        q, s, nr = quantize_ef(torch.as_tensor(g), torch.as_tensor(r))
        jq, js, jr = jquantize(jnp.asarray(g), jnp.asarray(r))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))


def test_quantize_ef_error_feedback_unbiased():
    """EF: accumulated compressed updates converge to the true sum."""
    import torch
    from repro_torch.distributed.compression import quantize_ef
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64,)).astype(np.float32)
    residual = torch.zeros(64)
    total = np.zeros((64,), np.float32)
    for _ in range(50):
        q, scale, residual = quantize_ef(torch.as_tensor(g), residual)
        total += q.numpy().astype(np.float32) * scale.item()
    np.testing.assert_allclose(total / 50, g,
                               atol=float(np.max(np.abs(g))) / 120)


def _dp_rank(rank, world, data, params):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training.compressed_dp import (
        init_ef_state, make_compressed_dp_train_step)
    from repro_torch.training.train_loop import init_train_state
    mesh = make_host_mesh("cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == world
    g = torch.as_tensor(data["g"][rank])
    r = torch.as_tensor(data["r"][rank])
    mean, res = compression.compressed_psum(g, r, dist.group.WORLD)
    quantize, seen = compression.quantize_ef, []

    def recording(g, residual):
        # each quantization's residual against its own scale
        q, scale, left = quantize(g, residual)
        seen.append(float(torch.amax(torch.abs(left)) / scale))
        return q, scale, left

    compression.quantize_ef = recording
    tc = TrainConfig(learning_rate=1e-2, schedule="constant")
    batch = {k: torch.as_tensor(data[k]) for k in ("tokens", "labels")}
    out = {}
    for tag, cfg, p in (
            ("fp32", get_smoke("qwen2-1.5b").replace(dtype="float32"),
             {k: v.float() for k, v in params.items()}),
            ("bf16", get_smoke("qwen2-1.5b"), params)):
        model = get_model(cfg)
        step = make_compressed_dp_train_step(model, tc, mesh, "data")
        carry = (init_train_state(model, tc, p), init_ef_state(p))
        out[tag] = []
        for _ in range(STEPS):
            carry, m = step(carry, batch)
            out[tag].append(float(m["loss"]))
    return mean.numpy(), res.numpy(), out, max(seen)


def test_compressed_psum_and_dp_steps_match_the_reference(tmp_path):
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import params_from_jax
    rng = np.random.default_rng(1)
    cfg = jget_smoke("qwen2-1.5b")
    brng = np.random.default_rng(0)
    data = {"g": rng.normal(size=(4, 16, 4)).astype(np.float32)
            * np.array([1.0, 3.0, 0.5, 2.0], np.float32)[:, None, None],
            "r": (rng.normal(size=(4, 16, 4)) * 0.01).astype(np.float32),
            "tokens": brng.integers(0, cfg.vocab_size, (8, 32))
            .astype(np.int32),
            "labels": brng.integers(0, cfg.vocab_size, (8, 32))
            .astype(np.int32)}
    np.savez(tmp_path / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jparams = jget_model(cfg).init(jax.random.key(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
        ranks = run_ranks(_dp_rank, 4, "cpu", args=(data, params),
                          threads=1, timeout=240)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "out.npz")
    scale = float(np.max(np.abs(data["g"])))
    for rank, (mean, res, losses, worst) in enumerate(ranks):
        np.testing.assert_allclose(mean, want["mean"][rank], rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(res, want["res"][rank], rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(losses["fp32"], want["losses"],
                                   rtol=LOSS_RTOL)
        for a, b in zip(want["losses_bf16"], losses["bf16"]):
            assert abs(a - b) < 0.05 * abs(a) + 0.05, (a, b)
        assert worst <= EF_BOUND, (rank, worst)
    # the ranks step alike, and learn
    assert all(r[2] == ranks[0][2] for r in ranks)
    for tag in ("fp32", "bf16"):
        assert ranks[0][2][tag][-1] < ranks[0][2][tag][0], tag


def test_trainer_refuses_compression_outside_its_step():
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.trainer import Trainer, TrainerConfig
    model = get_model(get_smoke("qwen2-1.5b"))
    with pytest.raises(NotImplementedError, match="make_compressed_dp"):
        Trainer(model, TrainConfig(grad_compression="int8_ef"),
                TrainerConfig(), device="cpu")
