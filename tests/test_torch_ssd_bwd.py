"""The SSD scan's gradient split as the ``ssd_scan_bwd`` kernel splits it
(``ref.ssd_scan_bwd_passes_ref``: the chunk summaries of dy, the reverse
walk over the chunks, then dx, dB, dC and the dt and A terms), against
``jax.vjp`` of the reference's ``repro.models.mamba2.ssd_chunked`` and
``torch.autograd.grad`` through the port's ``ssd_chunked``, on the same
numpy inputs and cotangents (dy and the final state's gradient), in fp32
on the CPU.  The kernel itself is held against this split on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerance: each gradient within atol 1e-5 x its largest magnitude + rtol
1e-4.  The three compute the same fp32 function (in fp32 the reference's
roundings of W, the end decays and B to xh's dtype round nothing) with
sums in other orders and over other splits: the reverse walk against
autograd through the forward's walk, dA and dB summed over every position
of every chunk (up to 800 terms here), dl reverse-summed within a chunk.
The errors seen are below 5e-6 of each gradient's largest magnitude (dA
the largest).

The grid: ragged T (50 over chunks of 16, 130 and 200 over 64), several
whole chunks (96 over 32), one chunk (C = T = 100), N 8 to 128, hd 8 to 32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM
from repro_torch.kernels import ref
from repro_torch.models import mamba2 as M

# (B, T, H, hd, N, chunk)
CASES = [(2, 50, 3, 16, 8, 16), (1, 96, 2, 8, 16, 32),
         (2, 100, 5, 16, 32, 128), (2, 130, 4, 32, 64, 64),
         (1, 200, 3, 16, 128, 64)]
NAMES = ("dxh", "ddt", "dA", "dBm", "dCm")


def _inputs(case, seed):
    B, T, H, hd, N = case[:5]
    rng = np.random.default_rng(seed)
    f = np.float32
    return ([rng.normal(size=(B, T, H, hd)).astype(f),
             (np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01).astype(f),
             (np.abs(rng.normal(size=(H,))) * 0.5 + 0.1).astype(f),
             rng.normal(size=(B, T, N)).astype(f),
             rng.normal(size=(B, T, N)).astype(f)],
            rng.normal(size=(B, T, H, hd)).astype(f),
            rng.normal(size=(B, H, hd, N)).astype(f))


def _split(ins, dy, dh, chunk):
    t = [torch.as_tensor(a) for a in ins]
    _, _, h_in = ref.ssd_scan_passes_ref(*t, chunk=chunk)
    return ref.ssd_scan_bwd_passes_ref(
        *t, h_in, torch.as_tensor(dy),
        None if dh is None else torch.as_tensor(dh), chunk=chunk)


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_split_backward_matches_jax_vjp_of_ssd_chunked(case):
    ins, dy, dh = _inputs(case, sum(case))
    chunk = case[5]
    _, vjp = jax.vjp(lambda *a: JM.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    _close([t.numpy() for t in _split(ins, dy, dh, chunk)], want)


@pytest.mark.parametrize("case", CASES)
def test_split_backward_matches_autograd_through_port_ssd_chunked(case):
    ins, dy, dh = _inputs(case, sum(case) + 1)
    chunk = case[5]
    t = [torch.as_tensor(a).requires_grad_(True) for a in ins]
    y, h = M.ssd_chunked(*t, chunk)
    want = torch.autograd.grad(
        (y * torch.as_tensor(dy)).sum() + (h * torch.as_tensor(dh)).sum(), t)
    _close([g.numpy() for g in _split(ins, dy, dh, chunk)],
           [w.numpy() for w in want])


def test_no_final_state_gradient_equals_zeros():
    """A ``dh_final`` of None (what the model's training gives: it drops
    the final state) is the same as zeros, bit for bit, and as the
    reference's vjp with a zero cotangent for the state."""
    case = CASES[3]
    ins, dy, _ = _inputs(case, 5)
    none = _split(ins, dy, None, case[5])
    zeros = _split(ins, dy, np.zeros((2, 4, 32, 64), np.float32), case[5])
    for name, a, b in zip(NAMES, none, zeros):
        assert torch.equal(a, b), name
    _, vjp = jax.vjp(lambda *a: JM.ssd_chunked(*a, case[5]),
                     *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.zeros((2, 4, 32, 64), jnp.float32)))
    _close([t.numpy() for t in none], want)
