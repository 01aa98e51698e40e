"""Each CUDA kernel against its plain PyTorch version, on a card (skipped
without one; ``chip_smoke.py`` runs the same checks).  Imports no JAX, so
it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import margin_head as mh
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as pd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import ssd_scan_bwd as ssdb

# the campaigns' shape, the JAX package's grid, the LM head at 8 and 64
# requests, then the kernel's slice edges (V = 32000 +- 1, off the
# 128-column slices and the 4-column vector loads) and one request
MH_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000), (65, 32, 257),
           (256, 128, 4096), (8, 2560, 32000), (64, 2560, 32000),
           (8, 2560, 31999), (8, 2560, 32001), (1, 2560, 32000),
           # the dense LMs' heads: qwen2-1.5b (1,187 slices) at 8 requests
           # and at the pool pass's microbatch of 64, gemma3-4b (2,048)
           (8, 1536, 151936), (64, 1536, 151936), (8, 2560, 262144),
           # mamba2-1.3b at 8 requests and the pool pass's 64, dbrx-132b
           # and internvl2-26b at 8
           (8, 2048, 50280), (64, 2048, 50280), (8, 6144, 100352),
           (8, 6144, 92672)]
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
           (1, 8, 4, 100, 100, 256, True, 0),
           # dbrx-132b's and internvl2-26b's GQA 48:8 at hd 128, over
           # internvl2's 1,024 patch tokens and 2,048 of text
           (1, 48, 8, 3072, 3072, 128, True, 0),
           # whisper-tiny's hd 64: the encoder's non-causal T 1,500 (off
           # every tile), the cross-attention's 2,048 prompt rows over
           # 1,500 frames, the decoder's causal self-attention, and a
           # ragged small one
           (2, 6, 6, 1500, 1500, 64, False, 0),
           (1, 6, 6, 2048, 1500, 64, False, 0),
           (1, 6, 6, 2048, 2048, 64, True, 0),
           (2, 6, 6, 100, 37, 64, False, 0)]
# the backward kernel: qwen2-1.5b's training attention (GQA 12:2 at hd 128,
# causal) and a windowed GQA one, whisper-tiny's non-causal ragged hd 64
# (Tq != Tk both ways), and the other head dims' tiles (hd 256, 80 and 8,
# in fp32 on the FMA kernel's 16- and 32-row tiles; the mma.sync kernel's
# 32 with a window and no causal mask, and 16 off its 64-row tiles); then
# the wgmma route's tile edges at hd 64 and 128 (T 127, 128 and 129 about
# its 128-row blocks and 64-row tiles, whisper's encoder T 1,500 and its
# cross-attention's 448 x 1,500, Tq != Tk at hd 128, causal H / Hk = 6);
# hd 80 is on the wgmma route too (two panels, zero past hd), and hd 256
# (kernels of its own, 64-row blocks): gemma3-4b's 8:4 with a causal
# window off the tiles, T 130 past two blocks above
FA_BWD_GRID = [(1, 12, 2, 512, 512, 128, True, 0),
               (2, 12, 2, 300, 300, 128, True, 100),
               (2, 6, 6, 200, 150, 64, False, 0),
               (2, 6, 6, 150, 200, 64, False, 0),
               (1, 4, 2, 130, 130, 256, True, 0),
               (1, 4, 4, 100, 100, 80, True, 0),
               (1, 4, 2, 70, 70, 8, True, 0),
               (1, 2, 1, 190, 190, 32, False, 70),
               (2, 4, 2, 77, 99, 16, True, 0),
               (1, 6, 6, 127, 127, 64, True, 0),
               (1, 6, 6, 128, 128, 128, True, 0),
               (1, 12, 2, 129, 129, 128, True, 0),
               (2, 6, 6, 129, 129, 64, False, 0),
               (1, 6, 6, 1500, 1500, 64, False, 0),
               (1, 6, 6, 448, 1500, 64, False, 0),
               (1, 6, 2, 200, 330, 128, False, 0),
               (1, 12, 2, 300, 200, 128, False, 0),
               (1, 12, 2, 129, 129, 64, True, 0),
               (1, 8, 4, 200, 200, 256, True, 70)]
# the training paths' shapes: qwen2-1.5b's, whisper-tiny's encoder,
# zamba2-2.7b's shared attention (hd 80), gemma3-4b's local and global
# layers (hd 256)
FA_BWD_TRAIN = [(8, 12, 2, 2048, 2048, 128, True, 0),
                (8, 6, 6, 1500, 1500, 64, False, 0),
                (8, 32, 32, 2048, 2048, 80, True, 0),
                (8, 8, 4, 2048, 2048, 256, True, 1024),
                (8, 8, 4, 2048, 2048, 256, True, 0)]
# likewise, then T off the chunk, one chunk (C = T = 100), H off the
# kernel's group of 8 heads
SSD_GRID = [(2, 128, 4, 16, 32, 64), (1, 96, 2, 8, 16, 32),
            (2, 64, 8, 32, 64, 64), (1, 256, 4, 64, 128, 128),
            (1, 2048, 80, 64, 64, 128), (2, 50, 3, 16, 8, 16),
            (2, 300, 4, 32, 64, 128), (2, 100, 5, 16, 32, 128),
            (1, 256, 12, 64, 64, 64),
            # mamba2-1.3b's state N 128 at C 128, hd 64, its 64 heads
            (2, 512, 64, 64, 128, 128)]


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


# the forward's wgmma route (bf16 at hd 64, 80 and 128: 128-row blocks of
# two 64-row warpgroups, 128-key tiles on multiples of 128): T 127, 128
# and 129 about them, whisper's encoder and cross-attention, a window
# across a key tile with and without causal, the shifted frame at hd 128
# and 80, and qwen2-1.5b's serving and pool-pass shapes: (B, H, Hk, Tq,
# Tk, hd, causal, window, q_offset, kv_start)
FA_WGMMA_GRID = [(1, 6, 6, 127, 127, 64, True, 0, 0, 0),
                 (1, 6, 6, 128, 128, 128, True, 0, 0, 0),
                 (1, 4, 1, 129, 129, 80, True, 0, 0, 0),
                 (2, 6, 6, 1500, 1500, 64, False, 0, 0, 0),
                 (1, 6, 6, 448, 1500, 64, False, 0, 0, 0),
                 (1, 4, 2, 300, 300, 128, True, 100, 0, 0),
                 (1, 4, 2, 190, 190, 128, False, 70, 0, 0),
                 (1, 2, 1, 190, 190, 80, False, 70, 0, 0),
                 (1, 4, 2, 200, 330, 128, True, 0, 64, 40),
                 (1, 4, 4, 150, 250, 80, True, 0, 100, 30),
                 (2, 12, 2, 2048, 2048, 128, True, 0, 0, 0),
                 (64, 12, 2, 256, 256, 128, True, 0, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window,q_offset,kv_start",
                         FA_WGMMA_GRID)
def test_flash_attention_wgmma_route_matches_plain_on_card(
        B, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start):
    """The wgmma route against the plain version (bf16 3e-2), its
    log-sum-exp against the plain one (atol 1e-3), one launch a call, and
    two calls bit-equal."""
    _need_card()
    assert hd in fa.WGMMA_HEAD_DIMS
    rng = np.random.default_rng(Tq * 3 + Tk + hd)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device="cuda").to(torch.bfloat16)
               for s in ((B, H, Tq, hd), (B, Hk, Tk, hd), (B, Hk, Tk, hd)))
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                kv_start=kv_start)
    before = fa.launches
    got, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
    again = fa.flash_attention(q, k, v, **mask)
    assert fa.launches == before + 2
    want = ref.flash_attention_ref(q, k, v, **mask)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    plain = ref.flash_attention_lse_ref(q, k, **mask)
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, plain, atol=1e-3, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window", FA_BWD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_kernel_matches_plain_autograd_on_card(
        B, H, Hk, Tq, Tk, hd, causal, window, dtype):
    """``ops.attention`` with grad on the card (the forward kernel with its
    log-sum-exp, then the backward kernel) against ``torch.autograd.grad``
    through the plain version, at the forward's tolerances: fp32 5e-4,
    bf16 3e-2 (atol = rtol; the two round to bf16 at different places:
    the plain version its P and the gradients between its ops, the
    tensor-core kernel P and dS as product operands)."""
    _need_card()
    rng = np.random.default_rng(Tq * 3 + Tk)
    td = getattr(torch, dtype)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda").to(td)
                   for s in ((B, H, Tq, hd), (B, Hk, Tk, hd),
                             (B, Hk, Tk, hd), (B, H, Tq, hd)))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before, fwd = fab.launches, fa.launches
    out = ops.attention(*(t.transpose(1, 2) for t in ins), causal=causal,
                        window=window).transpose(1, 2)
    got = torch.autograd.grad(out, ins, do)
    assert (fab.launches, fa.launches) == (before + 1, fwd + 1)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*ref_ins, causal=causal, window=window),
        ref_ins, do)
    tol = 5e-4 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == td
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def _bwd_inputs(B, H, Hk, Tq, Tk, hd, causal, window):
    """bf16 q, k, v, dO from a seed, and the forward kernel's out, lse."""
    rng = np.random.default_rng(Tq * 5 + Tk)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda").bfloat16()
                   for s in ((B, H, Tq, hd), (B, Hk, Tk, hd),
                             (B, Hk, Tk, hd), (B, H, Tq, hd)))
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return q, k, v, out, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window",
                         [c for c in FA_BWD_GRID
                          if c[5] in fab.WGMMA_HEAD_DIMS])
def test_flash_attention_backward_wgmma_matches_tiled_plain_on_card(
        B, H, Hk, Tq, Tk, hd, causal, window):
    """The wgmma route (bf16 at hd 64, 80, 128 and 256) against its
    arithmetic step by step (``ref.flash_attention_bwd_tiled_ref``: qs, P
    and dS rounded to bf16 where the kernel rounds them, fp32 sums over its
    tiles) on the same forward output and lse: atol = rtol = 1e-2, about
    two bf16 steps (an fp32 sum in another order, or exp2 against exp, can
    move one rounding by a step)."""
    _need_card()
    q, k, v, out, do, lse = _bwd_inputs(B, H, Hk, Tq, Tk, hd, causal, window)
    got = fab.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                  window=window)
    want = ref.flash_attention_bwd_tiled_ref(q, k, v, out, do, lse,
                                             causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window",
                         FA_BWD_TRAIN + [c for c in FA_BWD_GRID
                                         if c[5] == 256])
def test_flash_attention_backward_is_deterministic_on_card(
        B, H, Hk, Tq, Tk, hd, causal, window):
    """Two backward calls on the same inputs give the same bits (no float
    atomics; every sum in a fixed order), at the training shapes and the
    grid's hd-256 cases."""
    _need_card()
    q, k, v, out, do, lse = _bwd_inputs(B, H, Hk, Tq, Tk, hd, causal, window)
    first, second = (fab.flash_attention_bwd(q, k, v, out, do, lse,
                                             causal=causal, window=window)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# the mask's shifted frame (q_offset, kv_start) on every route of the pair:
# a rank's block of a sequence split (hd 128 and 64 on wgmma, an offset off
# the 64-row tiles), halo frames (window = q_offset = kv_start; hd 256 and
# 80), the mma.sync head dims and hd 8, non-causal keys below kv_start:
# (B, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start)
FA_OFFSET_GRID = [(2, 4, 2, 128, 512, 128, True, 0, 384, 0),
                  (1, 6, 6, 200, 600, 64, True, 0, 250, 0),
                  (2, 8, 4, 192, 256, 256, True, 64, 64, 64),
                  (1, 4, 4, 100, 170, 80, True, 50, 70, 70),
                  (1, 4, 2, 100, 200, 16, True, 0, 77, 13),
                  (1, 4, 4, 150, 230, 32, False, 0, 0, 70),
                  (1, 6, 2, 64, 200, 8, True, 0, 136, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_OFFSET_GRID,
                         ids=["-".join(map(str, c)) for c in FA_OFFSET_GRID])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_pair_at_an_offset_matches_plain_on_card(case, dtype):
    """The forward kernel, and ``ops.attention``'s kernel pair with grad, at
    ``q_offset`` and ``kv_start`` against the plain version and autograd
    through it, at the forward's tolerances (fp32 5e-4, bf16 3e-2); on the
    wgmma route also the backward against its tiled plain version (1e-2);
    keys below ``kv_start`` get zero gradients; and the query blocks of a
    4-way split at their offsets give the whole sequence's forward."""
    _need_card()
    B, H, Hk, Tq, Tk, hd, causal, window, q_offset, kv_start = case
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                kv_start=kv_start)
    rng = np.random.default_rng(Tq + Tk + hd)
    td = getattr(torch, dtype)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda").to(td)
                   for s in ((B, H, Tq, hd), (B, Hk, Tk, hd),
                             (B, Hk, Tk, hd), (B, H, Tq, hd)))
    tol = 5e-4 if dtype == "float32" else 3e-2
    got = fa.flash_attention(q, k, v, **mask)
    want = ref.flash_attention_ref(q, k, v, **mask)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before, fwd = fab.launches, fa.launches
    out = ops.attention(*(t.transpose(1, 2) for t in ins),
                        **mask).transpose(1, 2)
    grads = torch.autograd.grad(out, ins, do)
    assert (fab.launches, fa.launches) == (before + 1, fwd + 1)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(ref.flash_attention_ref(*ref_ins, **mask),
                                ref_ins, do)
    for g, w in zip(grads, plain):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    assert not grads[1][:, :, :kv_start].any()
    assert not grads[2][:, :, :kv_start].any()
    if td == torch.bfloat16 and hd in fab.WGMMA_HEAD_DIMS:
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
        got = fab.flash_attention_bwd(q, k, v, o, do, lse, **mask)
        tiled = ref.flash_attention_bwd_tiled_ref(q, k, v, o, do, lse,
                                                  **mask)
        for g, w in zip(got, tiled):
            torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                       rtol=1e-2)
    if Tq % 4 == 0:
        n = Tq // 4
        parts = [fa.flash_attention(q[:, :, i * n:(i + 1) * n], k, v,
                                    **dict(mask, q_offset=q_offset + i * n))
                 for i in range(4)]
        torch.testing.assert_close(torch.cat(parts, dim=2).float(),
                                   fa.flash_attention(q, k, v, **mask).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
def test_forward_log_sum_exp_on_card():
    """The forward's per-row log-sum-exp against the plain one."""
    _need_card()
    rng = np.random.default_rng(0)
    B, H, Hk, Tq, Tk, hd = 2, 6, 6, 300, 1500, 64
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device="cuda")
               for s in ((B, H, Tq, hd), (B, Hk, Tk, hd), (B, Hk, Tk, hd)))
    for dtype in (torch.float32, torch.bfloat16):
        out, lse = fa.flash_attention(*(t.to(dtype) for t in (q, k, v)),
                                      causal=False, return_lse=True)
        qs = (q.to(dtype) * hd ** -0.5).float()
        want = torch.logsumexp(qs @ k.to(dtype).float().transpose(-1, -2),
                               dim=-1)
        assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


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


# the backward kernel: the forward's grid (ragged T, one chunk, N 8 to 128,
# H off the group of 8 heads); the edges of the bf16 wgmma route (hd 64, C
# 128, N 64 and 128 in 64-column blocks): T off the chunk and H off the
# head group at N 128, fewer heads than a group at N 64; then mamba2-1.3b's
# and zamba2-2.7b's training shapes (B 8 x T 2,048 at C 128; N 128 over 64
# heads, N 64 over 80)
SSD_BWD_GRID = [c for c in SSD_GRID if c[0] * c[1] * c[2] < 2 ** 17] + [
    (2, 300, 12, 64, 128, 128), (1, 330, 5, 64, 64, 128),
    (8, 2048, 64, 64, 128, 128), (8, 2048, 80, 64, 64, 128)]


def _ssd_bwd_inputs(B, T, H, hd, N, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device="cuda")
    ins = (t(rng.normal(size=(B, T, H, hd))).to(dtype),
           t(np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01),
           t(np.abs(rng.normal(size=(H,))) * 0.5 + 0.1),
           t(rng.normal(size=(B, T, N))), t(rng.normal(size=(B, T, N))))
    return ins, t(rng.normal(size=(B, T, H, hd))).to(dtype), \
        t(rng.normal(size=(B, H, hd, N)))


def _within(got, want, atol_of_max, rtol):
    """|got - want| <= atol_of_max * max|want| + rtol |want|, each
    gradient."""
    for name, g, w in zip(("dxh", "ddt", "dA", "dBm", "dCm"), got, want):
        g, w = g.float(), w.float()
        assert g.shape == w.shape, name
        bound = atol_of_max * w.abs().max() + rtol * w.abs()
        assert bool(((g - w).abs() <= bound).all()), (
            name, float((g - w).abs().max()), float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,N,C", SSD_BWD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("final", [True, False])
def test_ssd_scan_backward_kernel_matches_both_plain_versions_on_card(
        B, T, H, hd, N, C, dtype, final):
    """The kernel against the split plain version on the same per-chunk
    states (``ref.ssd_scan_bwd_passes_ref``), tightly: atol 1e-4 x the
    gradient's largest magnitude + rtol 1e-4, since both are fp32 and the
    kernel's products take fp32 operands as bf16 hi + lo (about 2^-16
    relative each); bf16 dxh at rtol 2^-7, one bf16 step, as both round it
    once.  Against ``torch.autograd.grad`` through ``ref.ssd_scan_ref`` at
    the forward's bf16 tolerance, scaled by each gradient's largest
    magnitude: atol 2e-3 x max + rtol 2e-3 + 2^-7 (the plain scan rounds
    W, the end decays and B to xh's dtype inside its products; dA and dB
    sum 2^14 to 2^17 terms at the training shapes).  Two calls give the
    same bits."""
    _need_card()
    td = getattr(torch, dtype)
    ins, dy, dh = _ssd_bwd_inputs(B, T, H, hd, N, td, T + H + N)
    dh = dh if final else None
    _, _, states = ssd.ssd_scan_with_states(*ins, chunk=C)
    got = ssdb.ssd_scan_bwd(*ins, states, dy, dh, chunk=C)
    again = ssdb.ssd_scan_bwd(*ins, states, dy, dh, chunk=C)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[0].dtype == td and all(g.dtype == torch.float32
                                      for g in got[1:])
    split = ref.ssd_scan_bwd_passes_ref(*ins, states, dy, dh, chunk=C)
    _within(got[1:], split[1:], 1e-4, 1e-4)
    _within(got[:1], split[:1], 1e-4, 1e-4 if dtype == "float32" else 2 ** -7)
    del split
    plain_in = [t.clone().requires_grad_(True) for t in ins]
    y, h = ref.ssd_scan_ref(*plain_in, chunk=C)
    loss = (y.float() * dy.float()).sum()
    if dh is not None:
        loss = loss + (h * dh).sum()
    plain = torch.autograd.grad(loss, plain_in)
    _within(got, plain, 2e-3, 2e-3 + 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ssd_with_grad_runs_both_kernels_and_matches_cpu_on_card(dtype):
    """``ops.ssd`` with grad on the card: the forward kernel, then the
    backward kernel (one launch each), no plain scan; its gradients
    against CPU autograd through the plain scan on the same inputs, at the
    forward's tolerance scaled by each gradient's largest magnitude."""
    _need_card()
    td = getattr(torch, dtype)
    B, T, H, hd, N, C = 2, 300, 12, 32, 64, 128
    ins, dy, _ = _ssd_bwd_inputs(B, T, H, hd, N, td, 7)
    req = [t.clone().requires_grad_(True) for t in ins]
    before = (ssd.launches, ssdb.launches)
    y, _ = ops.ssd(*req, chunk=C)
    got = torch.autograd.grad(y, req, dy)
    assert (ssd.launches, ssdb.launches) == (before[0] + 1, before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_(True) for t in ins]
    yc, _ = ops.ssd(*cpu, chunk=C)
    want = torch.autograd.grad(yc, cpu, dy.cpu())
    _within([g.cpu() for g in got], want, 2e-3, 2e-3 + 2 ** -7)


@pytest.mark.cuda
def test_ssd_scan_backward_wrapper_refuses_what_it_does_not_take_on_card():
    _need_card()
    B, T, H, hd, N = 1, 64, 2, 8, 16
    ins, dy, dh = _ssd_bwd_inputs(B, T, H, hd, N, torch.float32, 0)
    _, _, states = ssd.ssd_scan_with_states(*ins, chunk=32)
    with pytest.raises(TypeError):
        ssdb.ssd_scan_bwd(ins[0].half(), *ins[1:], states, dy, chunk=32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssdb.ssd_scan_bwd(*(t.cpu() for t in ins), states, dy, chunk=32)
    with pytest.raises(ValueError, match="hd"):
        x12 = torch.zeros(B, T, H, 12, device="cuda")
        ssdb.ssd_scan_bwd(x12, *ins[1:], states, x12, chunk=32)
    with pytest.raises(ValueError, match="N % 4"):
        b6 = torch.zeros(B, T, 6, device="cuda")
        ssdb.ssd_scan_bwd(ins[0], ins[1], ins[2], b6, b6, states, dy,
                          chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssdb.ssd_scan_bwd(ins[0].transpose(1, 2).contiguous().transpose(
            1, 2), *ins[1:], states, dy, chunk=32)
    with pytest.raises(ValueError, match="h_in"):
        ssdb.ssd_scan_bwd(*ins, states[:, :1], dy, chunk=32)
    with pytest.raises(ValueError, match="dh_final"):
        ssdb.ssd_scan_bwd(*ins, states, dy, dh[:, :1], chunk=32)
