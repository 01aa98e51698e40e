"""The port's device k-center against the JAX device engine (anchor
distances through the Pallas kernel, interpret mode) and the host oracle:
the EXACT chosen-index sequence, on the integer-valued grids of the JAX
package's own k-center tests (every squared distance exact in fp32), with
anchors and duplicate rows."""
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.core.selection_device import KCenterConfig as JKCenterConfig
from repro.core.selection_device import \
    k_center_greedy_device as jk_center_greedy_device
from repro_torch.core import selection as sel
from repro_torch.core.selection_device import (KCenterConfig,
                                               k_center_greedy_device)


def _case(seed, N, d, k, n_anchors, n_dups):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 8, size=(N, d)).astype(np.float32)
    if n_dups:
        src = rng.integers(0, N, size=n_dups)
        dst = rng.integers(0, N, size=n_dups)
        X[dst] = X[src]
    A = (rng.integers(0, 8, size=(n_anchors, d)).astype(np.float32)
         if n_anchors else None)
    return X, A


GRID = [
    # (seed, N, d, k, n_anchors, n_dups)
    (0, 5, 3, 1, 0, 0),
    (1, 5, 3, 5, 0, 3),          # k == N with duplicate rows
    (3, 33, 4, 7, 5, 0),         # anchor-seeded start
    (4, 64, 8, 16, 0, 32),       # heavy duplication
    (5, 100, 16, 13, 9, 20),
    (6, 257, 8, 31, 3, 50),      # non-pow2 everything
    (7, 1025, 32, 5, 17, 100),
    (9, 300, 2, 40, 8, 150),     # low-d, mostly duplicates
]


@pytest.mark.parametrize("seed,N,d,k,n_anchors,n_dups", GRID)
def test_picks_match_jax_engine_and_host_oracle(seed, N, d, k, n_anchors,
                                                n_dups):
    X, A = _case(seed, N, d, k, n_anchors, n_dups)
    host = jsel.k_center_greedy(X, k, anchors=A)
    jdev = jk_center_greedy_device(X, k, anchors=A,
                                   cfg=JKCenterConfig(use_kernel=True))
    got = k_center_greedy_device(X, k, anchors=A, device="cpu")
    np.testing.assert_array_equal(jdev, host)
    np.testing.assert_array_equal(got, host)
    # the port's copy of the host oracle is the oracle
    np.testing.assert_array_equal(sel.k_center_greedy(X, k, anchors=A), host)


@pytest.mark.parametrize("block", [16, 64, 1024])
def test_row_tiled_anchor_distances_match_oracle(block):
    """Small blocks cut the anchor distances into row tiles; the picks must
    not depend on the tiling."""
    X, A = _case(11, 517, 8, 23, 6, 40)
    host = jsel.k_center_greedy(X, 23, anchors=A)
    got = k_center_greedy_device(X, 23, anchors=A,
                                 cfg=KCenterConfig(block=block), device="cpu")
    np.testing.assert_array_equal(got, host)


def test_accepts_device_features_and_degenerate_k():
    X, A = _case(15, 130, 8, 9, 4, 0)
    host = jsel.k_center_greedy(X, 9, anchors=A)
    np.testing.assert_array_equal(
        k_center_greedy_device(torch.as_tensor(X), 9, anchors=A,
                               device="cpu"), host)
    assert k_center_greedy_device(X, 0, device="cpu").shape == (0,)
    assert len(k_center_greedy_device(X[:3], 10, device="cpu")) == 3
