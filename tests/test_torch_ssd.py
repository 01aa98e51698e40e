"""The port's SSD scan and mamba2 block against the JAX package on the same
numpy inputs: the plain chunked scan (the CUDA kernel's CPU path) against
the Pallas kernel in interpret mode and the reference's ``ssd_chunked``, at
the JAX package's tolerance (2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import mamba2 as JM
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as M
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax

TOL = 2e-3
# tests/test_kernels.py's grid
SSD_GRID = [(2, 128, 4, 16, 32, 64), (1, 96, 2, 8, 16, 32),
            (2, 64, 8, 32, 64, 64), (1, 256, 4, 64, 128, 128)]


def _inputs(B, T, H, hd, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32),
            (np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01)
            .astype(np.float32),
            (np.abs(rng.normal(size=(H,))) * 0.5 + 0.1).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32))


@pytest.mark.parametrize("B,T,H,hd,N,C", SSD_GRID)
def test_plain_ssd_matches_pallas_and_oracle(B, T, H, hd, N, C):
    ins = _inputs(B, T, H, hd, N, T + N)
    jins = [jnp.asarray(a) for a in ins]
    yk, hk = jssd_scan(*jins, chunk=C, interpret=True)
    yr, hr = jax.jit(JM.ssd_chunked, static_argnums=5)(*jins, C)
    y, h = ref.ssd_scan_ref(*(torch.as_tensor(a) for a in ins), chunk=C)
    assert y.shape == (B, T, H, hd) and h.shape == (B, H, hd, N)
    for want_y, want_h in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("B,T,H,hd,N,C", SSD_GRID)
def test_passes_ref_matches_pallas_and_oracle(B, T, H, hd, N, C):
    """The plain three-pass split (what the CUDA kernel computes: chunk
    summaries, the inter-chunk walk, the output from each chunk's incoming
    state) against the Pallas kernel and the port's one-pass plain scan;
    each chunk's incoming state is the final state of the scan over the
    steps before it."""
    ins = _inputs(B, T, H, hd, N, T + N)
    jins = [jnp.asarray(a) for a in ins]
    yk, hk = jssd_scan(*jins, chunk=C, interpret=True)
    tins = [torch.as_tensor(a) for a in ins]
    y, h, h_in = ref.ssd_scan_passes_ref(*tins, chunk=C)
    yr, hr = ref.ssd_scan_ref(*tins, chunk=C)
    nc = -(-T // C)
    assert h_in.shape == (B, nc, H, hd, N) and not h_in[:, 0].any()
    for want_y, want_h in ((np.asarray(yk), np.asarray(hk)),
                           (yr.numpy(), hr.numpy())):
        np.testing.assert_allclose(y.numpy(), want_y, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(h.numpy(), want_h, atol=TOL, rtol=TOL)
    if nc > 1:
        T_last = (nc - 1) * C
        _, h_prefix = jssd_scan(*(a[:, :T_last] for a in jins[:2]), jins[2],
                                *(a[:, :T_last] for a in jins[3:]), chunk=C,
                                interpret=True)
        np.testing.assert_allclose(h_in[:, -1].numpy(), np.asarray(h_prefix),
                                   atol=TOL, rtol=TOL)


def test_ssd_with_initial_state_and_bf16_inputs_matches_jax():
    ins = _inputs(2, 40, 3, 8, 16, 7)
    h0 = np.random.default_rng(8).normal(size=(2, 3, 8, 16)).astype(
        np.float32)
    yr, hr = JM.ssd_chunked(*(jnp.asarray(a) for a in ins), 16,
                            jnp.asarray(h0))
    y, h = M.ssd_chunked(*(torch.as_tensor(a) for a in ins), 16,
                         torch.as_tensor(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=TOL, rtol=TOL)
    # bf16 xh (the zamba2 serving dtype): y comes back in bf16, a relative
    # step of up to 2^-7, on top of 2e-3
    xb = ins[0].astype(jnp.bfloat16)
    yr, hr = JM.ssd_chunked(jnp.asarray(xb), *(jnp.asarray(a)
                                                for a in ins[1:]), 16)
    y, h = ops.ssd(torch.as_tensor(ins[0]).bfloat16(),
                   *(torch.as_tensor(a) for a in ins[1:]), chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               atol=TOL, rtol=TOL + 2 ** -7)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=TOL, rtol=TOL)


def test_ssd_decode_matches_jax():
    rng = np.random.default_rng(4)
    xh = rng.normal(size=(2, 3, 8)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(2, 3))) + 0.1).astype(np.float32)
    A = (np.abs(rng.normal(size=(3,))) + 0.1).astype(np.float32)
    Bm, Cm = (rng.normal(size=(2, 16)).astype(np.float32) for _ in range(2))
    h = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    ins = (xh, dt, A, Bm, Cm, h)
    yr, hr = JM.ssd_decode(*(jnp.asarray(a) for a in ins))
    y, hn = M.ssd_decode(*(torch.as_tensor(a) for a in ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(hn.numpy(), np.asarray(hr), atol=1e-5)


def _block_params():
    """One zamba2-smoke mamba block, made with numpy at the reference's
    shapes (non-trivial A_log / dt_bias / D_skip / norm scales)."""
    cfg = get_smoke("zamba2-2.7b")
    rng = np.random.default_rng(6)
    p = {}
    for path, spec in P.iter_specs(M.block_specs(cfg, 1)):
        a = rng.normal(size=spec.shape[1:]) * (spec.scale or 0.3
                                                if spec.init != "normal"
                                                else spec.shape[1] ** -0.5)
        p[path] = (a + (1.0 if path == "D_skip" else 0.0)).astype(np.float32)
    return P.nest(p)


def test_mamba_block_matches_jax():
    jcfg, cfg = jget_smoke("zamba2-2.7b"), get_smoke("zamba2-2.7b")
    p = _block_params()
    x = np.random.default_rng(9).normal(size=(2, 37, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    want = jax.jit(lambda p, x: JM.mamba_block(jcfg, p, x))(jp,
                                                           jnp.asarray(x))
    tp = P.nest(params_from_jax(p, device="cpu"))
    got, state = M.mamba_block_with_state(cfg, tp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert torch.equal(M.mamba_block(cfg, tp, torch.as_tensor(x)), got)
    # one decode step from the block's final states equals the block run
    # over the sequence plus that token
    x2 = np.random.default_rng(10).normal(size=(2, 1, 64)).astype(np.float32)
    step, _ = M.mamba_block_decode(cfg, tp, torch.as_tensor(x2), state)
    full = M.mamba_block(cfg, tp, torch.as_tensor(np.concatenate([x, x2], 1)))
    np.testing.assert_allclose(step.numpy(), full[:, -1:].numpy(), atol=TOL,
                               rtol=TOL)
    jstate = {"ssm": jnp.asarray(state["ssm"].numpy()),
              "conv": jnp.asarray(state["conv"].numpy())}
    jstep, _ = jax.jit(lambda p, x, s: JM.mamba_block_decode(jcfg, p, x, s))(
        jp, jnp.asarray(x2), jstate)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=TOL,
                               rtol=TOL)
