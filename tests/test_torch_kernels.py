"""The port's kernels on the CPU: each plain version against the JAX
package's Pallas kernel (interpret mode, as the JAX package's own tests
run it), and the device dispatch.  ``test_torch_kernels_cuda.py`` holds
the CUDA kernels against their plain versions on a card.  Tolerances are
the JAX package's own test tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.margin_head import margin_head as jmargin_head
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import margin_head as mh
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as pd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

MH_GRID = [(128, 64, 512, 64, 256), (200, 48, 1000, 64, 128),
           (65, 32, 257, 32, 128), (256, 128, 4096, 128, 512)]
PD_GRID = [(5, 3, 4), (64, 16, 8), (130, 9, 33), (257, 128, 16)]


def _mh_inputs(T, D, V, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, D)).astype(np.float32),
            (rng.normal(size=(D, V)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("T,D,V,bt,bv", MH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_margin_head_plain_matches_pallas(T, D, V, bt, bv, dtype):
    h, w = _mh_inputs(T, D, V, T + V)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmargin_head(jnp.asarray(h, jd), jnp.asarray(w, jd), bt=bt, bv=bv,
                        interpret=True)
    got = ops.score_head(torch.as_tensor(h).to(td), torch.as_tensor(w).to(td))
    tol = 5e-5 if dtype == "float32" else 5e-2
    for g, r, t in zip(got[:3], want[:3], (tol, tol * 10, tol)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=t, rtol=t)
    if dtype == "float32":
        np.testing.assert_array_equal(got.top1.numpy(), np.asarray(want[3]))


def test_score_head_keeps_leading_dims():
    h, w = _mh_inputs(24, 16, 9, 0)
    got = ops.score_head(torch.as_tensor(h).reshape(4, 6, 16),
                         torch.as_tensor(w))
    flat = ref.margin_head_ref(torch.as_tensor(h), torch.as_tensor(w))
    assert got.margin.shape == (4, 6) and got.top1.dtype == torch.int32
    for g, f in zip(got, flat):
        assert torch.equal(g.reshape(-1), f)


@pytest.mark.parametrize("N,M,D", PD_GRID)
def test_pairwise_plain_matches_pallas(N, M, D):
    rng = np.random.default_rng(N * 1000 + M)
    x = rng.normal(size=(N, D)).astype(np.float32)
    c = rng.normal(size=(M, D)).astype(np.float32)
    want = jops.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c),
                                force_pallas=True)
    got = ops.pairwise_sqdist(torch.as_tensor(x), torch.as_tensor(c))
    assert got.shape == (N, M) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pairwise_plain_exact_on_integer_grid():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 8, size=(77, 12)).astype(np.float32)
    c = rng.integers(0, 8, size=(9, 12)).astype(np.float32)
    got = ops.pairwise_sqdist(torch.as_tensor(x), torch.as_tensor(c))
    direct = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), direct)


def test_cuda_wrappers_refuse_cpu_tensors_without_launching():
    """No hidden fallback: every kernel wrapper takes CUDA tensors only, and
    a refused call counts no launch."""
    h, w = torch.zeros(4, 8), torch.zeros(8, 3)
    q = torch.zeros(1, 2, 8, 16)
    mods = (mh, pd, fa, ssd)
    before = [m.launches for m in mods]
    with pytest.raises(ValueError, match="CUDA"):
        mh.margin_head(h, w)
    with pytest.raises(ValueError, match="CUDA"):
        pd.pairwise_sqdist(h, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2),
                     torch.zeros(2), torch.zeros(1, 8, 3),
                     torch.zeros(1, 8, 3))
    assert [m.launches for m in mods] == before
