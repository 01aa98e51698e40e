"""The port's attention against the JAX package on the same numpy inputs:
the plain flash attention (the CUDA kernel's CPU path) against the Pallas
kernel in interpret mode and the reference's oracle, the model-layout
dispatch, RoPE and decode attention.  Tolerances are the JAX package's:
fp32 5e-4, bf16 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

# tests/test_kernels.py's grid
FA_GRID = [(2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 96, 96, 16, True, 0),
           (2, 8, 2, 64, 64, 32, True, 24), (1, 2, 1, 50, 130, 16, False, 0),
           (1, 6, 3, 33, 77, 8, True, 0)]


def _qkv(B, H, Hk, Tq, Tk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Tq, hd)).astype(np.float32),
            rng.normal(size=(B, Hk, Tk, hd)).astype(np.float32),
            rng.normal(size=(B, Hk, Tk, hd)).astype(np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window", FA_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_matches_pallas_and_oracle(
        B, H, Hk, Tq, Tk, hd, causal, window, dtype):
    q, k, v = _qkv(B, H, Hk, Tq, Tk, hd, Tq * 7 + Tk)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=causal, window=window, bq=32, bk=32,
                    interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    got = ref.flash_attention_ref(*(torch.as_tensor(a).to(td)
                                    for a in (q, k, v)),
                                  causal=causal, window=window)
    assert got.shape == (B, H, Tq, hd) and got.dtype == td
    tol = 5e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


# the head dims of the CUDA kernel's wgmma route (whisper-tiny's 64,
# zamba2's 80, the dense LMs' 128) at small sizes: Tq off and Tk past its
# 128-row blocks and 128-key tiles, causal and not, and a window without
# causal (the TPU kernel's rule) at hd 80
WGMMA_GRID = [(1, 4, 2, 129, 200, hd, True, 0) for hd in (64, 80, 128)] + [
    (1, 2, 1, 190, 130, hd, False, 0) for hd in (64, 80, 128)] + [
    (1, 2, 1, 190, 190, 80, False, 70)]


@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window", WGMMA_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_matches_pallas_at_wgmma_head_dims(
        B, H, Hk, Tq, Tk, hd, causal, window, dtype):
    """The plain version (the kernel's CPU path and the card's yardstick)
    against the Pallas kernel in interpret mode, and against the
    reference's oracle where it applies the same mask (it drops a window
    without causal)."""
    q, k, v = _qkv(B, H, Hk, Tq, Tk, hd, Tq * 5 + Tk + hd)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=causal, window=window, bq=64, bk=64,
                    interpret=True)
    got = ref.flash_attention_ref(*(torch.as_tensor(a).to(td)
                                    for a in (q, k, v)),
                                  causal=causal, window=window)
    assert got.shape == (B, H, Tq, hd) and got.dtype == td
    tol = 5e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    if causal or not window:
        oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window)
        np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol,
                                   rtol=tol)
    # the log-sum-exp the kernel writes beside its output, against the
    # softmax's normalizer: exp(s - lse) sums to 1 over the visible keys
    lse = ref.flash_attention_lse_ref(torch.as_tensor(q).to(td),
                                      torch.as_tensor(k).to(td),
                                      causal=causal, window=window)
    qs = (torch.as_tensor(q).to(td) * hd ** -0.5).double()
    s = qs @ torch.as_tensor(k).to(td).double().repeat_interleave(
        H // Hk, dim=1).transpose(-1, -2)
    i, j = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    vis = torch.as_tensor(((i >= j) | (not causal))
                          & ((i - j < window) | (window == 0)))
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


def test_window_without_causal_follows_the_tpu_kernel():
    """The Pallas kernel applies ``window`` with or without ``causal``; the
    reference's jnp oracle applies it only under ``causal``.  The port's
    plain version (and kernel) follow the TPU kernel."""
    q, k, v = _qkv(1, 2, 1, 70, 70, 16, 11)
    pallas = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                    window=24, bq=32, bk=32, interpret=True)
    got = ref.flash_attention_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                                  causal=False, window=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=5e-4,
                               rtol=5e-4)
    oracle = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=False, window=24)
    assert np.abs(np.asarray(oracle) - np.asarray(pallas)).max() > 0.1
    bw = L.blockwise_attention(*(torch.as_tensor(a).transpose(1, 2)
                                 for a in (q, k, v)), causal=False,
                               window=24, kv_chunk=32)
    np.testing.assert_allclose(bw.transpose(1, 2).numpy(),
                               np.asarray(oracle), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("causal,window,kv_chunk,q_offset",
                         [(True, 0, 32, 0), (True, 16, 16, 0),
                          (False, 0, 64, 0), (True, 0, 16, 5)])
def test_blockwise_attention_matches_jax(causal, window, kv_chunk, q_offset):
    rng = np.random.default_rng(kv_chunk + window)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 45, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 45, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_chunk=kv_chunk,
              q_offset=q_offset, kv_start=3)
    want = JL.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = L.blockwise_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_ops_attention_takes_the_model_layout_and_chunking():
    """On the CPU ``ops.attention`` is the plain version over the model
    layout, chunked as the model asks: it equals the reference's
    ``blockwise_attention`` at the same ``kv_chunk``."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    want = JL.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=True, kv_chunk=16)
    got = ops.attention(*(torch.as_tensor(a) for a in (q, k, v)),
                        causal=True, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_pick_kv_chunk_matches_jax():
    for args in [(8, 2048, 32), (2, 40, 4), (1, 100_000, 64), (64, 512, 8)]:
        assert L.pick_kv_chunk(*args) == JL.pick_kv_chunk(*args)


@pytest.mark.parametrize("shape", [(2, 9, 4, 16), (1, 5, 2, 80)])
def test_apply_rope_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    pos = np.arange(3, 3 + shape[1])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(window)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    want = JL.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               kv_len=9, window=window)
    got = L.decode_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                             kv_len=9, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
