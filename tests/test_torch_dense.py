"""The dense family (qwen2-1.5b, gemma3-4b, qwen1.5-4b, phi3-medium-14b)
through the port against the JAX package: each smoke config with one param
tree (made with numpy at the reference's shapes and dtypes) given to both,
the port's copy through ``models.convert``, the same numpy tokens,
``forward`` / ``prefill`` / ``decode_step`` and the serving engine's
``score`` and ``generate``; each full config's spec tree, compared without
allocating; bf16 trees (tied and untied heads, QKV biases) carried both
ways.

Tolerances, as in ``test_torch_hybrid.py``: with the params cast to fp32
both packages run in fp32 and agree to 1e-4 (summation order only), and
generated tokens are equal; with bf16 params every activation is bf16 and
the two round at other places, so values agree to atol = rtol = 0.1, the
bf16 K/V cache within one more bf16 step (2^-7 relative).  The sequences
(40 tokens) are longer than gemma3-smoke's window of 8, so its local and
global layers attend differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as JT
from repro.models.registry import get_model as jget_model
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import ModelConfig, get_config, get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import param as P
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine

ARCHS = ("qwen2-1.5b", "gemma3-4b", "qwen1.5-4b", "phi3-medium-14b")
B, SEQ, GEN = 2, 40, 5     # GEN < 8: the caches hold SEQ + 8
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def make_jax_tree(arch: str, seed: int = 0):
    """The smoke config's params as the JAX package holds them (bf16
    weights, fp32 norms), made with numpy at the port's spec shapes:
    normal weights at their init stddev, and non-zero norm scales and QKV
    biases so that every leaf matters."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, spec in P.iter_specs(get_model(get_smoke(arch)).specs):
        std = P._stddev(spec) if spec.init == "normal" else 0.2
        a = rng.normal(size=spec.shape) * std + (spec.init == "ones")
        flat[path] = np.asarray(jnp.asarray(
            a, jnp.bfloat16 if spec.dtype == torch.bfloat16
            else jnp.float32))
    return P.nest(flat)


def cast_tree(tree, dtype):
    """Every bf16 leaf cast to ``dtype`` (fp32 leaves stay fp32)."""
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, getattr(jnp, dtype)))
        if a.dtype.name == "bfloat16" else a, tree)


def _tokens(vocab, seed=2, n=B, t=SEQ):
    return np.random.default_rng(seed).integers(0, vocab, (n, t))


@pytest.fixture(scope="module", params=ARCHS)
def jax_tree(request):
    return request.param, make_jax_tree(request.param)


class Jitted:
    """The JAX model's entry points, each compiled once per architecture
    and input dtype in this module (an eager call retraces its layer scan
    every time).  JAX's ``forward`` is its ``prefill`` without the cache
    (one ``_scan_blocks``), so the forward test reads the prefill's
    hidden states and the two share one compile."""

    def __init__(self, jm):
        self.prefill = jax.jit(jm.prefill)
        self.decode_step = jax.jit(jm.decode_step)
        self.logits = jax.jit(jm.logits)
        self.init_cache = jm.init_cache


_JITTED = {}


def jitted(arch: str) -> Jitted:
    if arch not in _JITTED:
        _JITTED[arch] = Jitted(jget_model(jget_smoke(arch)))
    return _JITTED[arch]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request, jax_tree):
    arch, tree = jax_tree
    dtype = request.param
    jparams = cast_tree(tree, dtype)
    jm, m = jitted(arch), get_model(get_smoke(arch))
    return arch, dtype, jm, jax.tree.map(jnp.asarray, jparams), m, \
        params_from_jax(jparams, device="cpu")


def test_forward_matches_jax(both):
    arch, dtype, jm, jp, m, p = both
    cfg = get_smoke(arch)
    tok = _tokens(cfg.vocab_size)
    want = jm.prefill(jp, {"tokens": jnp.asarray(tok, jnp.int32)})[0]
    got = m.forward(p, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, SEQ, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_prefill_and_decode_step_match_jax(both):
    arch, dtype, jm, jp, m, p = both
    cfg = get_smoke(arch)
    tol = TOL[dtype]
    tok = _tokens(cfg.vocab_size, 3)
    jh, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    h, c = m.prefill(p, {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=tol, rtol=tol)
    for leaf in ("k", "v"):
        assert tuple(c[leaf].shape) == jc[leaf].shape
        # the K/V cache is stored in the config's bf16 even when the
        # params are fp32: one bf16 rounding step (2^-7 relative) apart
        np.testing.assert_allclose(_f32(c[leaf]), _f32(jc[leaf]), atol=tol,
                                   rtol=tol + 2 ** -7)
    # one decode step on a max_seq cache loaded from the prefill
    S = SEQ + 8
    jfull = {k: jnp.zeros(v.shape, v.dtype).at[:, :, :SEQ].set(jc[k])
             for k, v in jm.init_cache(B, S).items()}
    full = m.init_cache(B, S, device="cpu")
    for k in ("k", "v"):
        full[k][:, :, :SEQ] = c[k]
    nxt = _tokens(cfg.vocab_size, 4, t=1)
    jl, jnew = jm.decode_step(jp, jfull, jnp.asarray(nxt, jnp.int32),
                              jnp.int32(SEQ))
    lg, new = m.decode_step(p, full, torch.as_tensor(nxt), SEQ)
    assert lg.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_f32(lg), _f32(jl), atol=tol, rtol=tol)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_f32(new[leaf]), _f32(jnew[leaf]),
                                   atol=tol, rtol=tol + 2 ** -7)


@pytest.fixture(scope="module")
def engines_fp32(jax_tree):
    arch, tree = jax_tree
    jparams = cast_tree(tree, "float32")
    jm, m = jget_model(jget_smoke(arch)), get_model(get_smoke(arch))
    jp = jax.tree.map(jnp.asarray, jparams)
    je = JServeEngine(jm, jp, max_seq=SEQ + 8, batch_size=B)
    e = ServeEngine(m, params_from_jax(jparams, device="cpu"),
                    max_seq=SEQ + 8, batch_size=B, device="cpu")
    return get_smoke(arch), jitted(arch), jp, je, e


def jax_generate(jm, jp, tokens, steps):
    """The JAX engine's greedy loop (``ServeEngine.generate``: the first
    token from the prefill's last logits, then one decode step a token)
    over the jitted entry points."""
    n, t = tokens.shape
    hidden, cache = jm.prefill(jp, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})
    logits = jm.logits(jp, hidden[:, -1:, :])
    full = {k: jnp.zeros(v.shape, v.dtype).at[:, :, :t].set(cache[k])
            for k, v in jm.init_cache(n, t + 8).items()}
    toks = []
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    for i in range(steps):
        toks.append(tok)
        logits, full = jm.decode_step(jp, full, tok, jnp.int32(t + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
    return np.asarray(jnp.concatenate(toks, axis=1))


def test_generate_tokens_equal_jax_in_fp32(engines_fp32):
    cfg, jm, jp, _, e = engines_fp32
    tok = _tokens(cfg.vocab_size, 5)
    want = jax_generate(jm, jp, tok, GEN)
    got = e.generate({"tokens": tok}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_score_matches_jax(engines_fp32):
    cfg, _, _, je, e = engines_fp32
    tok = _tokens(cfg.vocab_size, 6)
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


def test_gemma3_local_and_global_layers_attend_differently():
    """gemma3-smoke (window 8, every 6th layer global) on 40 tokens: the
    layer flags are the reference's, the windowed forward equals JAX's
    and differs from the same model with every layer global, and a
    decode step past the window equals JAX's."""
    arch = "gemma3-4b"
    cfg = get_smoke(arch)
    assert T._layer_flags(cfg) == [bool(f) for f in
                                   JT._layer_flags(jget_smoke(arch))]
    assert T._layer_flags(get_config(arch)) == [
        bool(f) for f in JT._layer_flags(jget_config(arch))]
    assert [T._window(cfg, f) for f in T._layer_flags(cfg)] == \
        [8, 8, 8, 8, 8, 0]
    jparams = cast_tree(make_jax_tree(arch), "float32")
    p = params_from_jax(jparams, device="cpu")
    tok = _tokens(cfg.vocab_size, 7)
    got = get_model(cfg).forward(p, {"tokens": torch.as_tensor(tok)})
    want = jitted(arch).prefill(jax.tree.map(jnp.asarray, jparams),
                                {"tokens": jnp.asarray(tok, jnp.int32)})[0]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)
    all_global = get_model(cfg.replace(local_global_ratio=0,
                                       sliding_window=0)).forward(
        p, {"tokens": torch.as_tensor(tok)})
    # the first 8 positions see no key past the window; later ones do
    np.testing.assert_allclose(_f32(all_global[:, :8]), _f32(got[:, :8]),
                               atol=1e-5, rtol=1e-5)
    assert float((all_global[:, 8:] - got[:, 8:]).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_spec_tree_equals_jax(arch):
    """Every path, shape, dtype, init and scale of the full config, without
    allocating a parameter."""
    jspecs = jget_model(jget_config(arch)).specs
    jleaves = {jax.tree_util.keystr(path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   jspecs, is_leaf=lambda x: hasattr(x, "logical"))[0]}
    ours = {P._keystr(path): s for path, s in
            P.iter_specs(get_model(get_config(arch)).specs)}
    assert sorted(ours) == sorted(jleaves)
    for k, s in ours.items():
        j = jleaves[k]
        assert (s.shape, s.init, s.scale) == (j.shape, j.init, j.scale), k
        assert str(s.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert sum(int(np.prod(s.shape)) for s in ours.values()) == \
        jget_model(jget_config(arch)).param_count()
    cache = T.cache_specs(get_config(arch), 8, 2048)
    jab, _ = JT.cache_specs(jget_config(arch), 8, 2048)
    for k, (shape, dtype) in cache.items():
        assert shape == jab[k].shape
        assert str(dtype).removeprefix("torch.") == \
            np.dtype(jab[k].dtype).name


def test_bf16_tree_round_trips_bit_exactly(jax_tree):
    arch, tree = jax_tree
    cfg = get_smoke(arch)
    p = params_from_jax(tree, device="cpu")
    assert p["blocks.attn.wq"].dtype == torch.bfloat16
    assert p["blocks.attn.wq"].shape[0] == cfg.num_layers
    assert ("lm_head" in p) == (not cfg.tie_embeddings)
    assert ("blocks.attn.bq" in p) == cfg.qkv_bias
    back = params_to_numpy(p)

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    jax.tree.map(same, back, tree)


def test_moe_and_vlm_families_stay_refused():
    for family in ("moe", "vlm"):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_model(ModelConfig(family=family))
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("dbrx-132b")


def test_launcher_serves_qwen2_smoke_on_cpu(capsys):
    out = launch_serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "12",
                             "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    stats = launch_serve.main(["--arch", "gemma3-4b", "--smoke", "--device",
                               "cpu", "--prompt-len", "12", "--score-pool",
                               "8", "--sweep-page", "4"])
    assert tuple(stats.margin.shape) == (8,)
    text = capsys.readouterr().out
    assert "generated (2, 3)" in text and "scored 8 rows" in text
