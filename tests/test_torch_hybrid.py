"""zamba2 through the port against the JAX package: the smoke config with
one param tree (made with numpy at the reference's shapes and dtypes) given
to both, the port's copy through ``models.convert``, the same numpy
tokens, ``forward`` / ``prefill`` / ``decode_step`` and the serving
engine's ``score`` and ``generate``; the full zamba2-2.7b spec tree,
compared without allocating; and a bf16 param tree carried both ways.

Tolerances: with the params cast to fp32 both packages run in fp32 and
agree to 1e-4 (summation order only); generated tokens are equal.  With
bf16 params every activation is bf16, and the two round at other places
(torch rounds each bf16 product once, XLA may keep fp32 longer), so values
of magnitude ~4 agree to a few bf16 steps: atol = rtol = 0.1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import hybrid as JH
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import hybrid as H
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine

ARCH = "zamba2-2.7b"
B, T, GEN = 2, 40, 5
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def jax_tree():
    """zamba2-smoke's params as the JAX package holds them (bf16 weights,
    fp32 norms and SSM scalars), made with numpy at the port's spec shapes:
    normal weights at their init stddev, and non-zero norm scales and SSM
    scalars so that every leaf matters."""
    rng = np.random.default_rng(0)
    flat = {}
    for path, spec in P.iter_specs(get_model(get_smoke(ARCH)).specs):
        std = P._stddev(spec) if spec.init == "normal" else 0.2
        a = rng.normal(size=spec.shape) * std + (spec.init == "ones")
        flat[path] = np.asarray(jnp.asarray(
            a, jnp.bfloat16 if spec.dtype == torch.bfloat16
            else jnp.float32))
    return P.nest(flat)


def _cast(tree, dtype):
    """Every bf16 leaf cast to ``dtype`` (fp32 leaves stay fp32)."""
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, getattr(jnp, dtype)))
        if a.dtype.name == "bfloat16" else a, tree)


def _tokens(seed=2, n=B, t=T):
    return np.random.default_rng(seed).integers(0, 256, (n, t))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request, jax_tree):
    dtype = request.param
    jparams = _cast(jax_tree, dtype)
    jm, m = jget_model(jget_smoke(ARCH)), get_model(get_smoke(ARCH))
    return dtype, jm, jax.tree.map(jnp.asarray, jparams), m, \
        params_from_jax(jparams, device="cpu")


def test_forward_matches_jax(both):
    dtype, jm, jp, m, p = both
    tok = _tokens()
    want = jm.forward(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = m.forward(p, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, T, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_prefill_and_decode_step_match_jax(both):
    dtype, jm, jp, m, p = both
    tol = TOL[dtype]
    tok = _tokens(3)
    jh, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    h, c = m.prefill(p, {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    for part, leaf in (("attn", "k"), ("attn", "v"), ("ssm", "ssm"),
                       ("ssm", "conv")):
        got = c[part][leaf]
        assert tuple(got.shape) == jc[part][leaf].shape
        # K/V and conv caches are stored in the config's bf16 even when the
        # params are fp32: one bf16 rounding step (2^-7 relative) apart
        rtol = tol + (2 ** -7 if got.dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(_f32(got), _f32(jc[part][leaf]),
                                   atol=tol, rtol=rtol)
    # one decode step on a max_seq cache loaded from the prefill
    S = T + 8
    jfull = jax.tree.map(jnp.asarray, jm.init_cache(B, S))
    jfull = {"attn": {k: jfull["attn"][k].at[:, :, :T].set(jc["attn"][k])
                      for k in ("k", "v")}, "ssm": jc["ssm"]}
    full = m.init_cache(B, S, device="cpu")
    for k in ("k", "v"):
        full["attn"][k][:, :, :T] = c["attn"][k]
    full["ssm"] = c["ssm"]
    nxt = _tokens(4, t=1)
    jl, jnew = jm.decode_step(jp, jfull, jnp.asarray(nxt, jnp.int32),
                              jnp.int32(T))
    lg, new = m.decode_step(p, full, torch.as_tensor(nxt), T)
    assert lg.shape == (B, 1, 256)
    np.testing.assert_allclose(_f32(lg), _f32(jl), atol=tol, rtol=tol)
    for part, leaf in (("attn", "k"), ("ssm", "ssm"), ("ssm", "conv")):
        got = new[part][leaf]
        rtol = tol + (2 ** -7 if got.dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(_f32(got), _f32(jnew[part][leaf]),
                                   atol=tol, rtol=rtol)


@pytest.fixture(scope="module")
def engines_fp32(jax_tree):
    jparams = _cast(jax_tree, "float32")
    jm, m = jget_model(jget_smoke(ARCH)), get_model(get_smoke(ARCH))
    je = JServeEngine(jm, jax.tree.map(jnp.asarray, jparams),
                      max_seq=T + GEN + 8, batch_size=B)
    e = ServeEngine(m, params_from_jax(jparams, device="cpu"),
                    max_seq=T + GEN + 8, batch_size=B, device="cpu")
    return je, e


def test_generate_tokens_equal_jax_in_fp32(engines_fp32):
    je, e = engines_fp32
    tok = _tokens(5)
    want = je.generate({"tokens": jnp.asarray(tok, jnp.int32)}, GEN)
    got = e.generate({"tokens": tok}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_score_matches_jax(engines_fp32):
    je, e = engines_fp32
    tok = _tokens(6)
    want = je.score({"tokens": jnp.asarray(tok, jnp.int32)})
    got = e.score({"tokens": tok})
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(got.top1.numpy(), np.asarray(want.top1))
    # the paged pool sweep over the same rows (one page, padded to 8 rows)
    pooled = e.score_pool({"tokens": tok})
    for g, w in zip(pooled[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(pooled.top1.numpy(), np.asarray(want.top1))


def test_full_config_spec_tree_equals_jax():
    """Every path, shape, dtype, init and scale of zamba2-2.7b, without
    allocating a parameter."""
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


def test_bf16_tree_round_trips_bit_exactly(jax_tree):
    p = params_from_jax(jax_tree, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert p["mamba_blocks.A_log"].dtype == torch.float32
    back = params_to_numpy(p)

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    jax.tree.map(same, back, jax_tree)


def test_cache_and_config_registry():
    cfg = get_smoke(ARCH)
    cache = H.init_cache(cfg, 2, 16, device="cpu")
    jab, _ = JH.cache_specs(jget_smoke(ARCH), 2, 16)
    for part in ("attn", "ssm"):
        for k, t in cache[part].items():
            assert tuple(t.shape) == jab[part][k].shape
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(jab[part][k].dtype).name
    # every reference architecture is ported now (whisper-tiny in
    # test_torch_audio.py); an unknown id is refused
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("whisper-large")
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--score-pool", "8"])
    assert tuple(stats.margin.shape) == (8,)


def test_launcher_generates_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12", "--gen",
                             "3"])
    assert tuple(out.shape) == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out
