"""The ``vlm`` family (internvl2-26b: the stub ViT frontend's patch
embeddings prepended to the text) through the port against the JAX
package: one param tree (made with numpy at the reference's shapes and
dtypes) given to both, the port's copy through ``models.convert``, the
same numpy tokens and fp32 patch embeddings.

Held: ``forward`` and ``prefill`` with the patches (fp32 1e-4; bf16 atol =
rtol = 0.1, the bf16 K/V cache within one more bf16 step, 2^-7 relative),
the serving engine's ``score`` (1e-4) and its paged ``score_pool`` with
per-row patches (each page's statistics equal ``score`` on that page's
rows exactly), and greedy ``generate`` (tokens equal) against the JAX
model's repeated full forwards and its decode loop run from the cache's
true length, the patches included.  The reference's engine decodes from
the prompt's length alone and its launcher sizes the cache without the
patches; both are pinned here (``ROADMAP.md`` §C)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine
from test_torch_dense import _f32, cast_tree, make_jax_tree

ARCH = "internvl2-26b"
B, SEQ, GEN = 2, 24, 4
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _inputs(cfg, seed, n=B, t=SEQ):
    """Token ids and fp32 patch embeddings, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (n, t)).astype(np.int32),
            rng.normal(size=(n, cfg.frontend_tokens, cfg.d_model))
            .astype(np.float32))


@pytest.fixture(scope="module")
def jitted():
    jm = jget_model(jget_smoke(ARCH))
    return jm, jax.jit(jm.prefill), jax.jit(jm.decode_step), \
        jax.jit(jm.forward), jax.jit(jm.logits)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request, jitted):
    dtype = request.param
    jparams = cast_tree(make_jax_tree(ARCH), dtype)
    return (dtype, jitted, jax.tree.map(jnp.asarray, jparams),
            get_model(get_smoke(ARCH)),
            params_from_jax(jparams, device="cpu"))


def test_forward_and_prefill_with_patches_match_jax(both):
    dtype, (_, jprefill, _, jforward, _), jp, m, p = both
    cfg = get_smoke(ARCH)
    tol = TOL[dtype]
    tok, pe = _inputs(cfg, 2)
    jbatch = {"tokens": jnp.asarray(tok), "patch_embeds": jnp.asarray(pe)}
    batch = {"tokens": torch.as_tensor(tok),
             "patch_embeds": torch.as_tensor(pe)}
    got = m.forward(p, batch)
    total = cfg.frontend_tokens + SEQ
    assert got.shape == (B, total, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(jforward(jp, jbatch)),
                               atol=tol, rtol=tol)
    # the patches matter, and the text alone is the dense forward
    text = m.forward(p, {"tokens": torch.as_tensor(tok)})
    assert float((text[:, -1] - got[:, -1]).abs().max()) > 1e-2
    jh, jc = jprefill(jp, jbatch)
    h, c = m.prefill(p, batch)
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    for leaf in ("k", "v"):
        assert tuple(c[leaf].shape) == jc[leaf].shape
        assert c[leaf].shape[2] == total
        np.testing.assert_allclose(_f32(c[leaf]), _f32(jc[leaf]), atol=tol,
                                   rtol=tol + 2 ** -7)


def jax_decode_from(jitted, jp, tok, pe, steps, max_seq):
    """The JAX model's greedy loop over its jitted prefill and decode
    steps, from the cache's true length P + T."""
    _, jprefill, jdecode, _, jlogits = jitted
    jm = jitted[0]
    hidden, cache = jprefill(jp, {"tokens": jnp.asarray(tok),
                                  "patch_embeds": jnp.asarray(pe)})
    pos = hidden.shape[1]
    logits = jlogits(jp, hidden[:, -1:, :])
    full = {k: jnp.zeros(v.shape, v.dtype).at[:, :, :pos].set(cache[k])
            for k, v in jm.init_cache(tok.shape[0], max_seq).items()}
    toks = []
    t = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    for i in range(steps):
        toks.append(t)
        logits, full = jdecode(jp, full, t, jnp.int32(pos + i))
        t = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    return np.asarray(jnp.concatenate(toks, axis=1))


def jax_full_forwards(jm, jp, tok, pe, steps):
    """Greedy tokens from a full JAX forward over patches, prompt and the
    tokens so far, once a token."""
    seq, out = tok, []
    for _ in range(steps):
        h = jm.forward(jp, {"tokens": jnp.asarray(seq),
                            "patch_embeds": jnp.asarray(pe)})
        t = np.asarray(jnp.argmax(jm.logits(jp, h[:, -1:, :])[:, -1, :],
                                  axis=-1)).astype(np.int32)[:, None]
        out.append(t)
        seq = np.concatenate([seq, t], axis=1)
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def fp32():
    jparams = cast_tree(make_jax_tree(ARCH), "float32")
    return jax.tree.map(jnp.asarray, jparams), \
        params_from_jax(jparams, device="cpu")


def test_generate_equals_jax_full_forwards_and_decode_loop(fp32, jitted):
    jp, p = fp32
    cfg = get_smoke(ARCH)
    tok, pe = _inputs(cfg, 5)
    max_seq = cfg.frontend_tokens + SEQ + GEN + 8
    e = ServeEngine(get_model(cfg), p, max_seq=max_seq, batch_size=B,
                    device="cpu")
    got = e.generate({"tokens": tok, "patch_embeds": pe}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    want = jax_full_forwards(jitted[0], jp, tok, pe, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), jax_decode_from(jitted, jp, tok, pe, GEN, max_seq))
    # one decode step after the prefill, against the JAX model's step at
    # P + T (1e-4) and its full forward over the prompt and the first token
    # (1e-2: the cache holds K/V in bf16, one bf16 step, 2^-7, apart from
    # the forward's fp32); the reference's engine steps at T, over the
    # patches' cache rows, and misses the forward by more than 0.1
    jm, jprefill, jdecode, jforward, jlogits = jitted
    jbatch = {"tokens": jnp.asarray(tok), "patch_embeds": jnp.asarray(pe)}
    first = want[:, :1]
    h = jforward(jp, {"tokens": jnp.asarray(np.concatenate([tok, first], 1)),
                      "patch_embeds": jnp.asarray(pe)})
    full = np.asarray(jlogits(jp, h[:, -1:, :]))
    _, cache, pos = e.prefill({"tokens": tok, "patch_embeds": pe})
    assert pos == cfg.frontend_tokens + SEQ
    logits, _ = e.decode(cache, torch.as_tensor(first), pos)
    _, jc = jprefill(jp, jbatch)
    jfull = {k: jnp.zeros(v.shape, v.dtype).at[:, :, :pos].set(jc[k])
             for k, v in jm.init_cache(B, max_seq).items()}
    step, _ = jdecode(jp, jfull, jnp.asarray(first), jnp.int32(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(step), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), full, atol=1e-2, rtol=1e-2)
    je = JServeEngine(jm, jp, max_seq=max_seq, batch_size=B)
    _, jcache, jpos = je.prefill(jbatch)
    assert jpos == SEQ
    jstep, _ = je._decode(jp, jcache, jnp.asarray(first), jnp.int32(jpos))
    assert np.abs(np.asarray(jstep) - full).max() > 0.1


def test_score_and_paged_score_pool_with_patches(fp32):
    jp, p = fp32
    cfg = get_smoke(ARCH)
    je = JServeEngine(jget_model(jget_smoke(ARCH)), jp,
                      max_seq=cfg.frontend_tokens + SEQ + 8, batch_size=8)
    e = ServeEngine(get_model(cfg), p, max_seq=cfg.frontend_tokens + SEQ + 8,
                    batch_size=8, device="cpu")
    tok, pe = _inputs(cfg, 6, n=24)
    pool = {"tokens": tok, "patch_embeds": pe}
    staged = []
    step = e._score

    def spy(params, batch):
        staged.append({k: (v.dtype, tuple(v.shape)) for k, v in batch.items()})
        return step(params, batch)
    e._score = spy
    pooled = e.score_pool(pool, page_rows=8)
    e._score = step
    # a ring per key: int32 token pages beside fp32 patch pages
    assert staged == [{"tokens": (torch.int32, (8, SEQ)),
                       "patch_embeds": (torch.float32,
                                        (8, cfg.frontend_tokens,
                                         cfg.d_model))}] * 3
    for lo in range(0, 24, 8):
        page = {k: v[lo:lo + 8] for k, v in pool.items()}
        got = e.score(page)
        for g, s in zip(got, pooled):
            assert torch.equal(g, s[lo:lo + 8])
        want = je.score({k: jnp.asarray(v) for k, v in page.items()})
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)
        np.testing.assert_array_equal(got.top1.numpy(),
                                      np.asarray(want.top1))


def test_cache_holds_64_patch_tokens_where_the_reference_launcher_fails(
        fp32):
    """``frontend_tokens=64``: sized as the reference's launcher sizes it
    (prompt + gen + 8) the cache cannot take the prefill, in either
    package; sized with the patches, the port generates the JAX model's
    full-forward tokens."""
    jp, p = fp32
    cfg = dataclasses.replace(get_smoke(ARCH), frontend_tokens=64)
    jm = jget_model(dataclasses.replace(jget_smoke(ARCH),
                                        frontend_tokens=64))
    tok, pe = _inputs(cfg, 7, t=12)
    batch = {"tokens": tok, "patch_embeds": pe}
    short = 12 + GEN + 8
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JServeEngine(jm, jp, max_seq=short, batch_size=B).generate(
            {k: jnp.asarray(v) for k, v in batch.items()}, GEN)
    with pytest.raises(ValueError, match="max_seq"):
        ServeEngine(get_model(cfg), p, max_seq=short, batch_size=B,
                    device="cpu").generate(batch, GEN)
    e = ServeEngine(get_model(cfg), p, max_seq=64 + short, batch_size=B,
                    device="cpu")
    got = e.generate(batch, GEN)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_full_forwards(jm, jp, tok, pe, GEN))


def test_full_config_spec_tree_equals_jax():
    jspecs = jget_model(jget_config(ARCH)).specs
    jleaves = {jax.tree_util.keystr(path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   jspecs, is_leaf=lambda x: hasattr(x, "logical"))[0]}
    ours = {P._keystr(path): s for path, s in
            P.iter_specs(get_model(get_config(ARCH)).specs)}
    assert sorted(ours) == sorted(jleaves)
    for k, s in ours.items():
        j = jleaves[k]
        assert (s.shape, s.init, s.scale) == (j.shape, j.init, j.scale), k
        assert str(s.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert sum(int(np.prod(s.shape)) for s in ours.values()) == \
        jget_model(jget_config(ARCH)).param_count()
    assert get_config(ARCH).frontend_tokens == 1024


def test_launcher_serves_internvl2_smoke_with_patches_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12", "--gen",
                             "3"])
    assert tuple(out.shape) == (2, 3)
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--prompt-len", "12", "--score-pool", "8",
                               "--sweep-page", "4", "--sweep-async"])
    assert tuple(stats.margin.shape) == (8,)
