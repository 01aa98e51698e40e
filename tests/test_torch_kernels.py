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


# the kernel's split (csrc/margin_head.cu): V one below, at and one above
# the edges of its 128-column slices, T = 1, and V past 32 slices, so that
# the merge pass's lanes fold runs of several slices (also with narrow
# slices): (T, D, V, slice_cols, bt, bv), bt and bv the Pallas tiles
MH_SPLIT_GRID = [(16, 32, 127, 128, 8, 128), (16, 32, 128, 128, 8, 128),
                 (16, 32, 129, 128, 8, 128), (16, 32, 255, 128, 8, 256),
                 (16, 32, 256, 128, 8, 256), (16, 32, 257, 128, 8, 256),
                 (1, 64, 1000, 128, 8, 256), (8, 16, 4097, 128, 8, 512),
                 (5, 16, 300, 8, 8, 128)]


@pytest.mark.parametrize("T,D,V,slice_cols,bt,bv", MH_SPLIT_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_margin_head_split_plain_matches_pallas(T, D, V, slice_cols, bt, bv,
                                                dtype):
    """The per-slice states and the merge pass's order, in plain PyTorch,
    against the Pallas kernel and the unsplit plain version."""
    h, w = _mh_inputs(T, D, V, T + V)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmargin_head(jnp.asarray(h, jd), jnp.asarray(w, jd), bt=bt, bv=bv,
                        interpret=True)
    th, tw = torch.as_tensor(h).to(td), torch.as_tensor(w).to(td)
    got = ref.margin_head_split_ref(th, tw, slice_cols)
    plain = ref.margin_head_ref(th, tw)
    tol = 5e-5 if dtype == "float32" else 5e-2
    for g, r, p, t in zip(got[:3], want[:3], plain[:3], (tol, tol * 10, tol)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=t, rtol=t)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=t, rtol=t)
    assert got[3].dtype == torch.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert torch.equal(got[3], plain[3])


# (V, slice_cols, first, copy): each row's maximal column and an equal
# copy of it in a later slice: in neighbouring slices, either side of an
# edge, at the first and last column, and in two lanes' runs of the merge
MH_DUP_GRID = [(300, 128, 5, 200), (257, 128, 127, 256), (256, 128, 0, 255),
               (4097, 128, 40, 4096), (300, 8, 3, 290)]


@pytest.mark.parametrize("V,slice_cols,first,copy", MH_DUP_GRID)
def test_margin_head_split_keeps_first_of_equal_maxima(V, slice_cols, first,
                                                       copy):
    """Integer-valued inputs make every logit exact whatever the summation
    order, so the two maxima are equal in every version: top1 is the first
    of them and the margin exactly 0, in the split, the plain version and
    the Pallas kernel."""
    T, D = 6, 24
    rng = np.random.default_rng(V + first)
    h = rng.integers(1, 4, size=(T, D)).astype(np.float32)
    w = rng.integers(-2, 3, size=(D, V)).astype(np.float32)
    w[:, first] = w[:, copy] = 3.0   # 3 sum(h) > 2 sum(h) >= any other
    want = jmargin_head(jnp.asarray(h), jnp.asarray(w), bt=8, bv=128,
                        interpret=True)
    th, tw = torch.as_tensor(h), torch.as_tensor(w)
    for got in (ref.margin_head_split_ref(th, tw, slice_cols),
                ref.margin_head_ref(th, tw),
                tuple(torch.as_tensor(np.array(a)) for a in want)):
        assert bool((got[3] == first).all()), got[3]
        assert bool((got[0] == 0.0).all()), got[0]
    split = ref.margin_head_split_ref(th, tw, slice_cols)
    for g, r, t in zip(split[1:3], want[1:3], (5e-4, 5e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=t, rtol=t)


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


# PD_GRID, then N and M off the kernel's 128 x 128 tiles with D off its
# 16-deep k steps
PD_SPLIT_GRID = PD_GRID + [(300, 130, 33), (129, 257, 64)]


@pytest.mark.parametrize("N,M,D", PD_SPLIT_GRID)
def test_pairwise_split_plain_matches_pallas(N, M, D):
    """x.c from bf16 hi + mid + lo parts (six products).  On the
    reference's grid it is held at the reference's tolerance, atol 1e-5
    (tests/test_selection_device.py), against the Pallas kernel and the
    plain version.  At the two shapes added off the CUDA kernel's tiles the
    distances reach ~150, where one fp32 step is 1.5e-5 and the plain
    version itself misses 1e-5 against the Pallas kernel (by 2.3e-5 and
    4.6e-5): there both are held against float64, the split's max error at
    most twice the plain version's (as chip_smoke.py holds the kernel).
    Integer inputs are exact (below)."""
    rng = np.random.default_rng(N * 1000 + M)
    x = rng.normal(size=(N, D)).astype(np.float32)
    c = rng.normal(size=(M, D)).astype(np.float32)
    want = np.asarray(jops.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c),
                                           force_pallas=True))
    plain = ref.pairwise_sqdist_ref(torch.as_tensor(x), torch.as_tensor(c))
    got = ref.pairwise_sqdist_split_ref(torch.as_tensor(x), torch.as_tensor(c))
    assert got.shape == (N, M) and bool((got >= 0).all())
    if (N, M, D) in PD_GRID:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    exact = ((x64[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
    err = np.abs(got.numpy() - exact).max()
    assert err <= 2.0 * np.abs(plain.numpy() - exact).max()


@pytest.mark.parametrize("N,M,D,top", [(77, 9, 12, 8), (300, 130, 33, 100),
                                       (129, 257, 64, 100), (40, 7, 4, 256)])
def test_pairwise_split_plain_exact_on_integer_grid(N, M, D, top):
    """Integers up to 256 are exact in bf16 hi (mid = lo = 0), and their products
    and sums stay exact in fp32 below 2^24: the split agrees exactly with
    the direct sum, the plain version and the Pallas kernel."""
    rng = np.random.default_rng(N + M + D)
    x = rng.integers(-top, top + 1, size=(N, D)).astype(np.float32)
    c = rng.integers(-top, top + 1, size=(M, D)).astype(np.float32)
    got = ref.pairwise_sqdist_split_ref(torch.as_tensor(x), torch.as_tensor(c))
    direct = ((x[:, None, :].astype(np.float64) - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), direct)
    assert torch.equal(got, ref.pairwise_sqdist_ref(torch.as_tensor(x),
                                                    torch.as_tensor(c)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.pairwise_sqdist(
        jnp.asarray(x), jnp.asarray(c), force_pallas=True)))


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
