"""Each CUDA kernel against its plain PyTorch version, on a card (skipped
without one; ``chip_smoke.py`` runs the same checks).  Imports no JAX, so
it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import margin_head as mh
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as pd
from repro_torch.kernels import ref

MH_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000), (65, 32, 257),
           (256, 128, 4096)]
PD_GRID = [(65536, 512, 64), (5, 3, 4), (64, 16, 8), (130, 9, 33),
           (257, 128, 16)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks "
                    "on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,V", MH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_margin_head_kernel_matches_plain_on_card(T, D, V, dtype):
    _need_card()
    rng = np.random.default_rng(T)
    h = rng.normal(size=(T, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    td = getattr(torch, dtype)
    h, w = (torch.as_tensor(a, device="cuda").to(td) for a in (h, w))
    before = mh.launches
    got = ops.score_head(h, w)
    assert mh.launches == before + 1
    want = ref.margin_head_ref(h, w)
    tol = 5e-5 if dtype == "float32" else 5e-2
    for g, r, t in zip(got[:3], want[:3], (tol, tol * 10, tol)):
        torch.testing.assert_close(g, r, atol=t, rtol=t)
    if dtype == "float32":
        assert torch.equal(got.top1, want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D", PD_GRID)
def test_pairwise_kernel_matches_plain_on_card(N, M, D):
    _need_card()
    rng = np.random.default_rng(N + M)
    x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device="cuda")
    c = torch.as_tensor(rng.normal(size=(M, D)).astype(np.float32),
                        device="cuda")
    before = pd.launches
    got = ops.pairwise_sqdist(x, c)
    assert pd.launches == before + 1
    want = ref.pairwise_sqdist_ref(x, c)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.max()))
    xi, ci = (torch.round(3 * t) for t in (x, c))
    assert torch.equal(ops.pairwise_sqdist(xi, ci),
                       ref.pairwise_sqdist_ref(xi, ci))
