"""Each CUDA kernel against its plain PyTorch version, on a card (skipped
without one; ``chip_smoke.py`` runs the same checks).  Imports no JAX, so
it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import margin_head as mh
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as pd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

# the campaigns' shape, the JAX package's grid, the LM head at 8 and 64
# requests, then the kernel's slice edges (V = 32000 +- 1, off the
# 128-column slices and the 4-column vector loads) and one request
MH_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000), (65, 32, 257),
           (256, 128, 4096), (8, 2560, 32000), (64, 2560, 32000),
           (8, 2560, 31999), (8, 2560, 32001), (1, 2560, 32000),
           # the dense LMs' heads: qwen2-1.5b (1,187 slices) at 8 requests
           # and at the pool pass's microbatch of 64, gemma3-4b (2,048)
           (8, 1536, 151936), (64, 1536, 151936), (8, 2560, 262144)]
# then N and M off the kernel's 128 x 128 tiles, D off its 16-deep k steps,
# and D over its 64-wide chunks (130: also off its 16-byte pieces)
PD_GRID = [(65536, 512, 64), (5, 3, 4), (64, 16, 8), (130, 9, 33),
           (257, 128, 16), (65537, 2049, 64), (300, 130, 33),
           (300, 1100, 100), (257, 140, 130)]
# the JAX package's grid for its kernel (tests/test_selection_device.py)
PD_REF_GRID = [(5, 3, 4), (64, 16, 8), (130, 9, 33), (257, 128, 16)]


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
@pytest.mark.parametrize("T,D,V,first,copy", [(8, 2560, 32000, 7, 20000),
                                              (8, 2560, 32000, 127, 128),
                                              (3, 64, 300, 0, 299)])
@pytest.mark.parametrize("kind", ["integer", "normal"])
def test_margin_head_kernel_keeps_first_of_equal_maxima_on_card(
        T, D, V, first, copy, kind):
    """Each row's maximal column copied into another slice: the kernel sums
    every column in one order, so the copies tie exactly, top1 is the
    first and the margin 0.  On integer inputs every logit is exact, and
    the plain version ties the same way.  The logits stay in the tens: the
    plain version's entropy, lse - sum(p x), loses about |x| times lse's
    rounding, so logits in the thousands would test its rounding instead
    of the kernel."""
    _need_card()
    rng = np.random.default_rng(V + first)
    if kind == "integer":
        # 4 nonzero hidden values (1-3) a row: logits exact, |x| <= 36
        h = np.zeros((T, D), np.float32)
        for row in h:
            row[rng.choice(D, 4, replace=False)] = rng.integers(1, 4, 4)
        w = rng.integers(-2, 3, size=(D, V)).astype(np.float32)
        w[:, first] = w[:, copy] = 3.0   # 3 sum(h) > 2 sum(h) >= any other
    else:
        h = (np.abs(rng.normal(size=(T, D))) * 0.01).astype(np.float32)
        w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
        w[:, first] = w[:, copy] = 1.0
    h, w = (torch.as_tensor(a, device="cuda") for a in (h, w))
    got = mh.margin_head(h, w)
    want = ref.margin_head_ref(h, w)
    assert bool((got[3] == first).all()) and bool((got[0] == 0).all())
    for g, r, t in zip(got[:3], want[:3], (5e-5, 5e-4, 5e-5)):
        torch.testing.assert_close(g, r, atol=t, rtol=t)
    if kind == "integer":
        assert torch.equal(got[3], want[3]) and bool((want[0] == 0).all())


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
    # against float64: no more than twice the plain fp32 version's error
    x64, c64 = x.double(), c.double()
    exact = torch.cdist(x64, c64) ** 2
    assert float((got.double() - exact).abs().max()) <= \
        2.0 * float((want.double() - exact).abs().max())
    xi, ci = (torch.round(3 * t) for t in (x, c))
    assert torch.equal(ops.pairwise_sqdist(xi, ci),
                       ref.pairwise_sqdist_ref(xi, ci))


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D", PD_REF_GRID)
def test_pairwise_kernel_reference_tolerance_on_card(N, M, D):
    """The JAX package's test of its kernel, on the card: the reference's
    grid and inputs, atol 1e-5 against the plain version."""
    _need_card()
    rng = np.random.default_rng(N * 1000 + M)
    x = rng.normal(size=(N, D)).astype(np.float32)
    c = rng.normal(size=(M, D)).astype(np.float32)
    got = pd.pairwise_sqdist(torch.as_tensor(x, device="cuda"),
                             torch.as_tensor(c, device="cuda"))
    want = ref.pairwise_sqdist_ref(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    assert got.shape == (N, M) and bool((got >= 0).all())


# the JAX package's grids (tests/test_kernels.py), then zamba2-2.7b's
# serving shapes at batch 1 (the kernel's work per (b, h) does not change
# with the batch), then the tile edges of the kernels: Tq and Tk off the
# 128-row query and 64-key tiles, GQA group 4, windows that cross a tile
# border (with and without causal), hd 8 padded to the mma's k = 16
FA_GRID = [(2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 96, 96, 16, True, 0),
           (2, 8, 2, 64, 64, 32, True, 24), (1, 2, 1, 50, 130, 16, False, 0),
           (1, 6, 3, 33, 77, 8, True, 0), (1, 2, 1, 70, 70, 16, False, 24),
           (1, 32, 32, 2048, 2048, 80, True, 0),
           (1, 4, 1, 129, 129, 80, True, 0), (2, 8, 2, 200, 333, 16, True, 0),
           (2, 8, 2, 200, 333, 16, False, 0), (1, 8, 2, 256, 256, 80, True, 0),
           (1, 4, 2, 300, 300, 32, True, 100),
           (1, 2, 1, 190, 190, 80, False, 70), (2, 4, 2, 150, 150, 8, True, 0),
           # the dense LMs' head dims: qwen2-1.5b's GQA 12:2 at hd 128
           # (prefill, pool pass), gemma3-4b's 8:4 at hd 256 on a local
           # (window 1,024) and a global layer, and the tile edges of the
           # 64-row blocks and the 32-key tiles at hd 256
           (1, 12, 2, 2048, 2048, 128, True, 0),
           (2, 12, 2, 256, 256, 128, True, 0),
           (1, 8, 4, 2048, 2048, 256, True, 1024),
           (1, 8, 4, 2048, 2048, 256, True, 0),
           (1, 4, 1, 129, 200, 128, True, 0),
           (2, 6, 2, 190, 333, 128, False, 0),
           (1, 4, 2, 300, 300, 256, True, 100),
           (1, 2, 1, 190, 190, 256, False, 70),
           (1, 8, 4, 100, 100, 256, True, 0)]
# likewise, then T off the chunk, one chunk (C = T = 100), H off the
# kernel's group of 8 heads
SSD_GRID = [(2, 128, 4, 16, 32, 64), (1, 96, 2, 8, 16, 32),
            (2, 64, 8, 32, 64, 64), (1, 256, 4, 64, 128, 128),
            (1, 2048, 80, 64, 64, 128), (2, 50, 3, 16, 8, 16),
            (2, 300, 4, 32, 64, 128), (2, 100, 5, 16, 32, 128),
            (1, 256, 12, 64, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window", FA_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_on_card(B, H, Hk, Tq, Tk, hd,
                                                       causal, window, dtype):
    _need_card()
    rng = np.random.default_rng(Tq + Tk)
    td = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device="cuda").to(td)
               for s in ((B, H, Tq, hd), (B, Hk, Tk, hd), (B, Hk, Tk, hd)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    # the JAX package's tolerances: fp32 5e-4, bf16 3e-2
    tol = 5e-4 if dtype == "float32" else 3e-2
    assert got.shape == want.shape and got.dtype == td
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,N,C", SSD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain_on_card(B, T, H, hd, N, C, dtype):
    _need_card()
    rng = np.random.default_rng(T + H)
    dev = "cuda"
    xh = torch.as_tensor(rng.normal(size=(B, T, H, hd)).astype(np.float32),
                         device=dev).to(getattr(torch, dtype))
    dt = torch.as_tensor((np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01)
                         .astype(np.float32), device=dev)
    A = torch.as_tensor((np.abs(rng.normal(size=(H,))) * 0.5 + 0.1)
                        .astype(np.float32), device=dev)
    Bm, Cm = (torch.as_tensor(rng.normal(size=(B, T, N)).astype(np.float32),
                              device=dev) for _ in range(2))
    before = ssd.launches
    y, h = ops.ssd(xh, dt, A, Bm, Cm, chunk=C)
    assert ssd.launches == before + 1
    yr, hr = ref.ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=C)
    # fp32: the JAX package's 2e-3.  bf16 xh: both round y from fp32 to
    # bf16, and fp32 sums in another order can round it one bf16 step
    # apart (at most 2^-7 relative), so y is held at rtol 2e-3 + 2^-7; the
    # state stays fp32 and keeps 2e-3
    assert y.dtype == xh.dtype and h.dtype == torch.float32
    rtol = 2e-3 if dtype == "float32" else 2e-3 + 2 ** -7
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3, rtol=rtol)
    torch.testing.assert_close(h, hr, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,N,C", [(2, 300, 12, 32, 64, 128),
                                          (1, 2048, 80, 64, 64, 128)])
def test_ssd_scan_chunk_states_match_plain_passes_on_card(B, T, H, hd, N, C):
    """Each chunk's incoming state, which the kernel's inter-chunk pass
    leaves in its scratch, against the plain three-pass split."""
    _need_card()
    rng = np.random.default_rng(T + H)
    dev = "cuda"
    xh = torch.as_tensor(rng.normal(size=(B, T, H, hd)).astype(np.float32),
                         device=dev).bfloat16()
    dt = torch.as_tensor((np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01)
                         .astype(np.float32), device=dev)
    A = torch.as_tensor((np.abs(rng.normal(size=(H,))) * 0.5 + 0.1)
                        .astype(np.float32), device=dev)
    Bm, Cm = (torch.as_tensor(rng.normal(size=(B, T, N)).astype(np.float32),
                              device=dev) for _ in range(2))
    y, h, h_in = ssd.ssd_scan_with_states(xh, dt, A, Bm, Cm, chunk=C)
    yr, hr, h_in_r = ref.ssd_scan_passes_ref(xh, dt, A, Bm, Cm, chunk=C)
    assert h_in.shape == h_in_r.shape == (B, -(-T // C), H, hd, N)
    torch.testing.assert_close(h_in, h_in_r, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(h, hr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3,
                               rtol=2e-3 + 2 ** -7)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take_on_card():
    _need_card()
    q = torch.zeros(1, 2, 8, 24, device="cuda")
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(1, 8, 2, 8, device="cuda", dtype=torch.float16)
    rest = (torch.zeros(1, 8, 2, device="cuda"), torch.zeros(2, device="cuda"),
            torch.zeros(1, 8, 4, device="cuda"),
            torch.zeros(1, 8, 4, device="cuda"))
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, *rest)
    # the kernel copies 16-byte pieces of each row of x
    with pytest.raises(ValueError, match="hd"):
        ssd.ssd_scan(torch.zeros(1, 8, 2, 12, device="cuda"), *rest)
