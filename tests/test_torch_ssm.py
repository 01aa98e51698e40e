"""The ``ssm`` family (mamba2-1.3b) through the port against the JAX
package: the smoke config with one param tree (made with numpy at the
reference's shapes and dtypes) given to both, the port's copy through
``models.convert``, the same numpy tokens, ``forward``, the prefill's
hidden states and per-layer ``ssm`` / ``conv`` states, ``decode_step``
and the serving engine's ``score`` and greedy ``generate``; the full
mamba2-1.3b spec tree and state cache, compared without allocating; and
the launcher on the CPU.

Tolerances, as in ``test_torch_hybrid.py``: with the params cast to fp32
both packages run in fp32 and agree to 1e-4 (summation order only), and
generated tokens are equal; with bf16 params the two round at other
places, so values agree to atol = rtol = 0.1, a bf16 conv state within
one more bf16 step (2^-7 relative).  The sequences (40 tokens) are not a
multiple of mamba2-smoke's SSD chunk of 16, so the scan's padding runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import mamba2 as JM
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2 as M
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine
from test_torch_dense import _f32, cast_tree, make_jax_tree

ARCH = "mamba2-1.3b"
B, SEQ, GEN = 2, 40, 5
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _tokens(seed=2, n=B, t=SEQ):
    return np.random.default_rng(seed).integers(0, 256, (n, t))


@pytest.fixture(scope="module")
def jitted():
    jm = jget_model(jget_smoke(ARCH))
    return jm, jax.jit(jm.prefill), jax.jit(jm.decode_step)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request, jitted):
    dtype = request.param
    jparams = cast_tree(make_jax_tree(ARCH), dtype)
    return (dtype, jitted, jax.tree.map(jnp.asarray, jparams),
            get_model(get_smoke(ARCH)),
            params_from_jax(jparams, device="cpu"))


def test_forward_matches_jax(both):
    dtype, (jm, _, _), jp, m, p = both
    tok = _tokens()
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = m.forward(p, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, SEQ, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_prefill_states_and_decode_step_match_jax(both):
    dtype, (_, jprefill, jdecode), jp, m, p = both
    tol = TOL[dtype]
    tok = _tokens(3)
    jh, jc = jprefill(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    h, c = m.prefill(p, {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    # per layer: the final SSM state (fp32) and the conv's last K-1 inputs
    assert c["ssm"].dtype == torch.float32
    for leaf in ("ssm", "conv"):
        assert tuple(c[leaf].shape) == jc[leaf].shape
        assert str(c[leaf].dtype).removeprefix("torch.") == \
            np.asarray(jc[leaf]).dtype.name
        for layer in range(c[leaf].shape[0]):
            np.testing.assert_allclose(_f32(c[leaf][layer]),
                                       _f32(jc[leaf][layer]), atol=tol,
                                       rtol=tol)
    # one decode step from the prefill's states (the engine's cache)
    nxt = _tokens(4, t=1)
    jl, jnew = jdecode(jp, jc, jnp.asarray(nxt, jnp.int32), jnp.int32(SEQ))
    lg, new = m.decode_step(p, c, torch.as_tensor(nxt), SEQ)
    assert lg.shape == (B, 1, 256)
    np.testing.assert_allclose(_f32(lg), _f32(jl), atol=tol, rtol=tol)
    for leaf in ("ssm", "conv"):
        rtol = tol + (2 ** -7 if new[leaf].dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(_f32(new[leaf]), _f32(jnew[leaf]),
                                   atol=tol, rtol=rtol)


@pytest.fixture(scope="module")
def engines_fp32():
    jparams = cast_tree(make_jax_tree(ARCH), "float32")
    jm, m = jget_model(jget_smoke(ARCH)), get_model(get_smoke(ARCH))
    je = JServeEngine(jm, jax.tree.map(jnp.asarray, jparams),
                      max_seq=SEQ + GEN + 8, batch_size=B)
    e = ServeEngine(m, params_from_jax(jparams, device="cpu"),
                    max_seq=SEQ + GEN + 8, batch_size=B, device="cpu")
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


def test_full_config_spec_tree_and_cache_equal_jax():
    """Every path, shape, dtype, init and scale of mamba2-1.3b, and its
    state cache, without allocating a parameter."""
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
    jab, _ = JM.cache_specs(jget_config(ARCH), 8, 2048)
    for k, (shape, dtype) in M.cache_specs(get_config(ARCH), 8,
                                           2048).items():
        assert shape == jab[k].shape
        assert str(dtype).removeprefix("torch.") == \
            np.dtype(jab[k].dtype).name
    cache = get_model(get_smoke(ARCH)).init_cache(2, 16, device="cpu")
    assert cache["ssm"].shape == (4, 2, 8, 16, 8)
    assert not any(bool(t.any()) for t in cache.values())


def test_launcher_serves_mamba2_smoke_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12", "--gen",
                             "3"])
    assert tuple(out.shape) == (2, 3)
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--prompt-len", "12", "--score-pool", "8",
                               "--sweep-page", "4"])
    assert tuple(stats.margin.shape) == (8,)
    assert "mamba2-smoke" in capsys.readouterr().out


def test_closed_engine_is_freed_without_a_collection():
    """A pool pass leaves a sweep runner whose adapter holds the engine's
    scoring step; ``close`` drops it, so the engine (and its params) goes
    with its last reference, the cyclic collector off."""
    import gc
    import weakref
    cfg = get_smoke(ARCH)
    e = ServeEngine(get_model(cfg), get_model(cfg).init(0, device="cpu"),
                    max_seq=16, batch_size=2, device="cpu")
    e.score_pool({"tokens": _tokens(7, n=4, t=8)}, page_rows=2)
    e.close()
    gone = weakref.ref(e)
    gc.disable()
    try:
        del e
        assert gone() is None
    finally:
        gc.enable()
