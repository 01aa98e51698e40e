"""The ``audio`` family (whisper-tiny: an encoder over the stub frontend's
frame embeddings, a decoder with cross-attention) through the port against
the JAX package: one param tree (made with numpy at the reference's shapes
and dtypes) given to both, the port's copy through ``models.convert``, the
same numpy tokens and fp32 frames.

Held at ``test_torch_vlm.py``'s tolerances for the same entry points:
``forward`` and ``prefill`` (fp32 1e-4; bf16 atol = rtol = 0.1, the bf16
caches within one more bf16 step, 2^-7 relative), one ``decode_step``
(1e-4), greedy ``generate`` (tokens equal) against the JAX engine's, the
serving engine's ``score`` (1e-4, top1 equal) and its paged
``score_pool`` with per-row frames (each page equal to ``score`` on its
rows exactly).  The reference's ``PoolScoringEngine`` cannot score an
audio pool (``ROADMAP.md`` §C.5); the port refuses it and names
``score_pool``.  In fp32 both packages run the config with
``dtype="float32"`` (the encoder casts its frames to the config's dtype).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.core.scoring import PoolScoringEngine as JPoolScoringEngine
from repro.core.scoring import ScoringConfig as JScoringConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine
from test_torch_dense import _f32, cast_tree, make_jax_tree

ARCH = "whisper-tiny"
B, SEQ, GEN = 2, 12, 4
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _cfgs(dtype):
    return (dataclasses.replace(jget_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke(ARCH), dtype=dtype))


def _inputs(cfg, seed, n=B, t=SEQ):
    """Token ids and fp32 frame embeddings, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (n, t)).astype(np.int32),
            rng.normal(size=(n, cfg.encoder_tokens, cfg.d_model))
            .astype(np.float32))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    jparams = cast_tree(make_jax_tree(ARCH), dtype)
    jm = jget_model(jcfg)
    return (dtype, jm, jax.jit(jm.prefill), jax.jit(jm.forward),
            jax.tree.map(jnp.asarray, jparams), get_model(cfg),
            params_from_jax(jparams, device="cpu"))


def test_forward_and_prefill_with_frames_match_jax(both):
    dtype, jm, jprefill, jforward, jp, m, p = both
    cfg = m.cfg
    tol = TOL[dtype]
    tok, fr = _inputs(cfg, 2)
    jbatch = {"tokens": jnp.asarray(tok), "audio_frames": jnp.asarray(fr)}
    batch = {"tokens": torch.as_tensor(tok),
             "audio_frames": torch.as_tensor(fr)}
    got = m.forward(p, batch)
    assert got.shape == (B, SEQ, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(jforward(jp, jbatch)),
                               atol=tol, rtol=tol)
    # the frames matter
    other = m.forward(p, {"tokens": batch["tokens"],
                          "audio_frames": torch.as_tensor(
                              _inputs(cfg, 3)[1])})
    assert float((other[:, -1] - got[:, -1]).abs().max()) > 1e-2
    jh, jc = jprefill(jp, jbatch)
    h, c = m.prefill(p, batch)
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    assert sorted(c) == sorted(jc) == ["k", "v", "xk", "xv"]
    for leaf in c:
        assert tuple(c[leaf].shape) == jc[leaf].shape
        np.testing.assert_allclose(_f32(c[leaf]), _f32(jc[leaf]), atol=tol,
                                   rtol=tol + 2 ** -7)
    assert c["xk"].shape[2] == cfg.encoder_tokens


@pytest.fixture(scope="module")
def fp32():
    jcfg, cfg = _cfgs("float32")
    jparams = cast_tree(make_jax_tree(ARCH), "float32")
    return (jget_model(jcfg), jax.tree.map(jnp.asarray, jparams),
            get_model(cfg), params_from_jax(jparams, device="cpu"))


def test_decode_step_and_generate_match_jax(fp32):
    jm, jp, m, p = fp32
    tok, fr = _inputs(m.cfg, 5)
    max_seq = SEQ + GEN + 8
    je = JServeEngine(jm, jp, max_seq=max_seq, batch_size=B)
    e = ServeEngine(m, p, max_seq=max_seq, batch_size=B, device="cpu")
    jbatch = {"tokens": jnp.asarray(tok), "audio_frames": jnp.asarray(fr)}
    batch = {"tokens": tok, "audio_frames": fr}
    got = e.generate(batch, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(je.generate(jbatch, GEN)))
    # one decode step after the prefill against the JAX engine's: the
    # self-attention cache copied in, the cross-attention cache as it is
    first = got[:, :1]
    _, cache, pos = e.prefill(batch)
    assert pos == SEQ
    assert cache["k"].shape[2] == max_seq
    assert cache["xk"].shape[2] == m.cfg.encoder_tokens
    logits, _ = e.decode(cache, first, pos)
    _, jcache, jpos = je.prefill(jbatch)
    jstep, _ = je._decode(jp, jcache, jnp.asarray(first.numpy()),
                          jnp.int32(jpos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jstep), atol=1e-4,
                               rtol=1e-4)


def test_score_and_paged_score_pool_with_frames(fp32):
    jm, jp, m, p = fp32
    je = JServeEngine(jm, jp, max_seq=SEQ + 8, batch_size=8)
    e = ServeEngine(m, p, max_seq=SEQ + 8, batch_size=8, device="cpu")
    tok, fr = _inputs(m.cfg, 6, n=24)
    pool = {"tokens": tok, "audio_frames": fr}
    staged = []
    step = e._score

    def spy(params, batch):
        staged.append({k: (v.dtype, tuple(v.shape)) for k, v in batch.items()})
        return step(params, batch)
    e._score = spy
    pooled = e.score_pool(pool, page_rows=8)
    e._score = step
    # a ring per key: int32 token pages beside fp32 frame pages
    assert staged == [{"tokens": (torch.int32, (8, SEQ)),
                       "audio_frames": (torch.float32,
                                        (8, m.cfg.encoder_tokens,
                                         m.cfg.d_model))}] * 3
    jpooled = je.score_pool({k: v for k, v in pool.items()}, page_rows=8)
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
    for g, w in zip(pooled[:3], jpooled[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_pool_scoring_engine_refuses_audio_as_the_reference_fails(fp32):
    """ROADMAP C.5: the reference's engine passes ``{"tokens": x}`` alone,
    so its encoder gets no frames and fails; the port refuses the family
    up front and names the audio pool pass, ``ServeEngine.score_pool``."""
    jm, jp, m, p = fp32
    pool = np.random.default_rng(0).integers(
        0, m.cfg.vocab_size, (8, SEQ)).astype(np.int32)
    with pytest.raises(AttributeError, match="astype"):
        JPoolScoringEngine(jm, JScoringConfig(microbatch=4)).score(jp, pool)
    with pytest.raises(NotImplementedError, match="score_pool"):
        PoolScoringEngine(m, ScoringConfig(microbatch=4), device="cpu")


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
    assert get_model(get_config(ARCH)).param_count() == \
        jget_model(jget_config(ARCH)).param_count()
    for field in ("encoder_layers", "encoder_tokens", "pos_embed", "remat",
                  "logits_chunk", "head_dim", "vocab_size", "max_seq_len"):
        assert getattr(get_config(ARCH), field) == \
            getattr(jget_config(ARCH), field), field
        assert getattr(get_smoke(ARCH), field) == \
            getattr(jget_smoke(ARCH), field), field


def test_launcher_serves_whisper_smoke_with_frames_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12", "--gen",
                             "3"])
    assert tuple(out.shape) == (2, 3)
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--prompt-len", "12", "--score-pool", "8",
                               "--sweep-page", "4", "--sweep-async"])
    assert tuple(stats.margin.shape) == (8,)
    assert "pool sweep (async) scored 8 rows" in capsys.readouterr().out
