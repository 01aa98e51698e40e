"""The attention backward kernel's arithmetic, step by step
(``ref.flash_attention_bwd_tiled_ref``: qs rounded, P and dS rounded as
product operands, fp32 sums over the kernel's tiles in its order, dQ in
its own pass), against ``jax.grad`` of the reference's
``blockwise_attention`` on the same numpy inputs, on the CPU.

Tolerances, each with its reason:
- fp32 operands (nothing rounded): atol = rtol = 1e-5, as the attention
  gradients of ``test_torch_train.py`` (the same softmax; fp32 sums in
  another order);
- bf16 operands (the kernel's route at hd 64, 80, 128 and 256): the
  inputs rounded to bf16 on both sides, then the tiled version rounds qs,
  P and dS to bf16 and its gradients to bf16 at the end, while JAX keeps
  fp32 throughout: atol = rtol = 3e-2, the forward's bf16 tolerance.

The shapes: qwen2-1.5b's causal GQA 12:2 at hd 128 with T off the
kernel's 128-row blocks and more 64-row query tiles than its ring has
stages (3); a causal window; whisper-tiny's non-causal hd 64 with
Tq != Tk both ways; T one past a block; gemma3-4b's 8:4 at hd 256 with a
causal window off the tiles, and T one past two of its 64-row blocks.  (The
reference applies a window only under a causal mask, as every model calls
it.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ref

# (B, H, Hk, Tq, Tk, hd, causal, window)
CASES = [(1, 12, 2, 200, 200, 128, True, 0),
         (1, 4, 2, 190, 190, 64, True, 70),
         (2, 6, 6, 150, 200, 64, False, 0),
         (2, 6, 6, 300, 130, 64, False, 0),
         (1, 6, 6, 129, 129, 128, True, 0),
         # hd 80 (zamba2's), padded to two 64-column panels on the card
         (1, 4, 4, 200, 200, 80, True, 0),
         (2, 4, 2, 150, 130, 80, False, 0),
         # hd 256 (gemma3-4b's 8:4): a causal window off the 64-row tiles,
         # and T one past two 64-row blocks
         (1, 8, 4, 200, 200, 256, True, 70),
         (1, 4, 2, 129, 129, 256, True, 0)]


def _mask(Tq, Tk, causal, window):
    qp = np.arange(Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    vis = np.ones((Tq, Tk), bool)
    if causal:
        vis &= qp >= kp
    if window > 0:
        vis &= (qp - kp) < window
    return torch.as_tensor(vis)


@pytest.mark.parametrize("B,H,Hk,Tq,Tk,hd,causal,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_backward_matches_jax_grad_of_blockwise_attention(
        B, H, Hk, Tq, Tk, hd, causal, window, dtype):
    rng = np.random.default_rng(Tq * 7 + Tk + hd)
    td = getattr(torch, dtype)
    # model layout, as the reference takes them; rounded to the dtype
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                   .to(td).float().numpy()
                   for s in ((B, Tq, H, hd), (B, Tk, Hk, hd),
                             (B, Tk, Hk, hd), (B, Tq, H, hd)))

    def jloss(q, k, v):
        out = JL.blockwise_attention(q, k, v, causal=causal, window=window,
                                     kv_chunk=64)
        return jnp.sum(out * do)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    # head-major, as the kernel takes them; the forward's out and lse
    qh, kh, vh, doh = (torch.as_tensor(a).transpose(1, 2) for a in
                       (q, k, v, do))
    scale = hd ** -0.5
    G = H // Hk
    s = ((qh * scale).to(td).float()
         @ kh.repeat_interleave(G, dim=1).transpose(-1, -2))
    s = s.masked_fill(~_mask(Tq, Tk, causal, window), -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.softmax(s, dim=-1) @ vh.repeat_interleave(G, dim=1)
    got = ref.flash_attention_bwd_tiled_ref(
        qh.to(td), kh.to(td), vh.to(td), out.to(td), doh.to(td), lse,
        causal=causal, window=window)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        assert g.dtype == td
        np.testing.assert_allclose(g.float().transpose(1, 2).numpy(),
                                   np.asarray(w), atol=tol, rtol=tol)
