"""Tensor-parallel compute on the mesh against the reference's GSPMD runs.

Four gloo ranks on ("data", "model") = (2, 2) and (1, 4), in one spawn,
against the reference on four forced CPU devices, under ``tp`` and
``fsdp_tp``, for two fp32 variants of qwen2-1.5b's smoke config (its 3
query heads and 1 kv head do not split): 4 query heads with 2 kv heads
(both split over "model" at (2, 2)) and 4 with 1 (kv whole, each rank
given the kv heads its query heads read):

* the loss and every leaf's gradient (``step.grads`` of
  ``make_sharded_train_step``, gathered whole) meet the reference's
  ``jax.value_and_grad`` of its ``loss_fn`` under the same shardings, the
  prefill's logits and three decode steps' logits (fixed tokens) meet the
  reference's ``ServeEngine(mesh=, policy=)``, all within 1e-4 relative;
* per rank, ``FlopCounterMode``'s count of the loss's forward lies within
  10% of the analytic count from the config and the specs
  (``dryrun.split_forward_flops``: a product's FLOPs over the "model" size
  where its weight dim is tensor-parallel);
* no all-gather runs over "model" in the loss and its gradients (no leaf
  is gathered over a tensor-parallel dim), and the sums over "model" do;
* each rank's KV cache is (L, B / data, S / model, Hk, hd).

zamba2's smoke config under ``tp`` on (2, 2), its shared block split as
the dense block is: the loss, the prefill's logits and the greedy tokens
meet the unmeshed model's.

On one forced rank, dbrx's layer as the MoE takes it: the routed experts
as stored, the attention by the rule.

Without ranks: the flash-decode merge of a cache's blocks against
``decode_attention`` (one block to the bit), and the rule's
tensor-parallel dims on the shipped configs' specs.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"kv2": dict(num_heads=4, num_kv_heads=2),
            "kv1": dict(num_heads=4, num_kv_heads=1)}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
POLICIES = ("tp", "fsdp_tp")
B, T = 8, 16            # the training batch
SB, S, GEN = 4, 24, 3   # serving: rows, cache length, decode steps
RTOL, ATOL = 1e-4, 1e-6
CASES = list(itertools.product(MESHES, POLICIES, VARIANTS))
IDS = [".".join(c) for c in CASES]

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke, input_pspecs
from repro.configs.base import ShapeConfig, TrainConfig
from repro.distributed import sharding as shd
from repro.models.registry import get_model
from repro.serving.engine import ServeEngine
from repro.training.train_loop import loss_fn, state_pspecs
data = np.load(sys.argv[1])
meshes, policies, variants, (B, T, SB, S, GEN) = %r, %r, %r, %r
out = {}

def flat(tree, prefix=""):
    for k in sorted(tree):
        path = prefix + "." + k if prefix else k
        if isinstance(tree[k], dict):
            yield from flat(tree[k], path)
        else:
            yield path, tree[k]

for vname, kw in variants.items():
    base = get_smoke("qwen2-1.5b").replace(dtype="float32", **kw)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          get_model(base).init(jax.random.key(0)))
    batch = {k: jnp.asarray(data[vname + "." + k])
             for k in ("tokens", "labels")}
    for mname, shape in meshes.items():
        mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=True)
        for policy in policies:
            tag = mname + "." + policy + "." + vname
            cfg = base.replace(sharding=policy)
            model = get_model(cfg)
            _, ps = state_pspecs(model, TrainConfig(), mesh, policy)
            bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh,
                              policy)
            with mesh:
                fn = jax.jit(jax.value_and_grad(
                    lambda p, b: loss_fn(model, p, b, mesh=mesh)),
                    in_shardings=(shd.tree_named(mesh, ps["params"]),
                                  {k: shd.named(mesh, v)
                                   for k, v in bp.items()}))
                loss, grads = fn(params, batch)
                out[tag + ".loss"] = np.asarray(loss)
                for path, g in flat(grads):
                    out[tag + ".grad." + path] = np.asarray(g)
                eng = ServeEngine(model, params, S, SB, mesh=mesh,
                                  policy=policy)
                logits, cache, pos = eng.prefill(
                    {"tokens": jnp.asarray(data[vname + ".req"])})
                out[tag + ".prefill"] = np.asarray(logits)
                gen = jnp.asarray(data[vname + ".gen"])
                for i in range(GEN):
                    logits, cache = eng._decode(eng.params, cache,
                                                gen[:, i:i + 1],
                                                jnp.int32(pos + i))
                    out[tag + ".decode%%d" %% i] = np.asarray(logits)
np.savez(sys.argv[2], **out)
""" % ({k: list(v) for k, v in MESHES.items()}, POLICIES, VARIANTS,
       (B, T, SB, S, GEN))


def _tp_rank(rank, world, data, params):
    """Every four-rank case: the sharded loss and gradients, the forward's
    FLOPs and all-gathers, and the meshed engine's prefill, decode and
    cache, each case's results on rank 0 (the counts on every rank)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import split_forward_flops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train_loop import (batch_rows, init_train_state,
                                                 loss_fn,
                                                 make_sharded_train_step)
    meshes = {k: make_mesh(v, ("data", "model"), "cpu")
              for k, v in MESHES.items()}
    out = {}
    gathers = []
    plain_all_gather = C.all_gather

    def counting_all_gather(x, dim, axis):
        gathers.append(axis.group)
        return plain_all_gather(x, dim, axis)

    for mname, policy, vname in CASES:
        tag = f"{mname}.{policy}.{vname}"
        mesh = meshes[mname]
        cfg = get_smoke("qwen2-1.5b").replace(dtype="float32",
                                              sharding=policy,
                                              **VARIANTS[vname])
        model = get_model(cfg)
        p = {k: v.float() for k, v in params[vname].items()}
        batch = {k: torch.as_tensor(data[f"{vname}.{k}"])
                 for k in ("tokens", "labels")}
        bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh, policy)
        tc = TrainConfig(learning_rate=1e-2, schedule="constant")
        step, _, sh = make_sharded_train_step(model, tc, mesh, policy, bp)
        state = shd.shard_tree(init_train_state(model, tc, p), sh)
        rows = {k: v[shd.slices(v.shape, bp[k], mesh)]
                for k, v in batch.items()}
        model_group = mesh.get_group("model")
        gathers.clear()
        C.all_gather = counting_all_gather
        try:
            loss, grads = step.grads(state, rows)
        finally:
            C.all_gather = plain_all_gather
        out[tag + ".gathers_over_model"] = sum(g is model_group
                                               for g in gathers)
        out[tag + ".gathers"] = len(gathers)
        specs = {k: s.spec for k, s in sh["params"].items()}
        with torch.no_grad():
            whole = {k: shd.gather(g, specs[k], mesh)
                     for k, g in grads.items()}
        view = shd.MeshView(mesh, rows=batch_rows(bp), policy=policy)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            loss_fn(model, state["params"], rows, mesh=view)
        layers, head = split_forward_flops(cfg, T, view.sizes())
        out[tag + ".flops"] = (fc.get_total_flops(),
                               rows["tokens"].numel() * (layers + head))
        eng = ServeEngine(model, p, S, SB, device="cpu", mesh=mesh,
                          policy=policy)
        logits, cache, pos = eng.prefill(
            {"tokens": torch.as_tensor(data[vname + ".req"])})
        out[tag + ".cache"] = (tuple(cache["k"].shape),
                               tuple(cache["v"].shape))
        dec = []
        gen = torch.as_tensor(data[vname + ".gen"])
        for i in range(GEN):
            step_logits, cache = eng.decode(cache, gen[:, i:i + 1], pos + i)
            dec.append(step_logits.numpy())
        eng.close()
        if rank == 0:
            out[tag + ".loss"] = float(loss)
            out[tag + ".grads"] = {k: v.numpy() for k, v in whole.items()}
            out[tag + ".prefill"] = logits.numpy()
            out[tag + ".decode"] = dec
    out.update(_hybrid(rank, meshes["2x2"], data))
    return out


def _hybrid(rank, mesh, data):
    """zamba2's smoke config (its shared block's 4 heads, 4 kv heads and
    MLP split over "model") under ``tp`` on (2, 2): the sharded loss, and
    the meshed engine's prefill logits and greedy tokens; on rank 0 the
    unmeshed ones."""
    import torch
    from repro_torch.configs import get_smoke, input_pspecs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train_loop import (init_train_state, loss_fn,
                                                 make_sharded_train_step)
    cfg = get_smoke("zamba2-2.7b").replace(dtype="float32", sharding="tp")
    model = get_model(cfg)
    p = {k: v.float() for k, v in model.init(0, device="cpu").items()}
    batch = {k: torch.as_tensor(data["kv2." + k]) % cfg.vocab_size
             for k in ("tokens", "labels")}
    req = {"tokens": torch.as_tensor(data["kv2.req"]) % cfg.vocab_size}
    bp = input_pspecs(cfg, ShapeConfig("t", T, B, "train"), mesh, "tp")
    tc = TrainConfig()
    step, _, sh = make_sharded_train_step(model, tc, mesh, "tp", bp)
    state = shd.shard_tree(init_train_state(model, tc, p), sh)
    loss, _ = step.grads(state, {k: v[shd.slices(v.shape, bp[k], mesh)]
                                 for k, v in batch.items()})
    out = {"hybrid.loss": float(loss)}
    engines = [("meshed", dict(mesh=mesh, policy="tp"))]
    if rank == 0:
        with torch.no_grad():
            out["hybrid.plain.loss"] = float(loss_fn(model, p, batch))
        engines.append(("plain", {}))
    for name, kw in engines:
        eng = ServeEngine(model, p, S, SB, device="cpu", **kw)
        out[f"hybrid.{name}.prefill"] = eng.prefill(req)[0].numpy()
        out[f"hybrid.{name}.gen"] = eng.generate(req, GEN).numpy()
        eng.close()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import params_from_jax
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    data, params = {}, {}
    for vname, kw in VARIANTS.items():
        cfg = jget_smoke("qwen2-1.5b").replace(**kw)
        v = cfg.vocab_size
        data[vname + ".tokens"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[vname + ".labels"] = rng.integers(0, v, (B, T)).astype(np.int32)
        data[vname + ".req"] = rng.integers(0, v, (SB, T)).astype(np.int32)
        data[vname + ".gen"] = rng.integers(0, v, (SB, GEN)).astype(np.int32)
    np.savez(tmp / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for vname, kw in VARIANTS.items():
            jm = jget_model(jget_smoke("qwen2-1.5b").replace(
                dtype="float32", **kw))
            params[vname] = params_from_jax(jax.tree.map(
                np.asarray, jm.init(jax.random.key(0))), device="cpu")
        got = run_ranks(_tp_rank, 4, "cpu", args=(data, params), threads=1,
                        timeout=240)
    finally:
        _, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    return got, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_meet_the_reference(ranks, case):
    got, want = ranks
    np.testing.assert_allclose(got[0][case + ".loss"], want[case + ".loss"],
                               rtol=RTOL)
    grads = got[0][case + ".grads"]
    assert set(grads) == {k[len(case) + 6:] for k in want
                          if k.startswith(case + ".grad.")}
    for k, g in grads.items():
        w = want[f"{case}.grad.{k}"]
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


@pytest.mark.parametrize("case", IDS)
def test_prefill_and_decode_meet_the_reference(ranks, case):
    got, want = ranks
    np.testing.assert_allclose(got[0][case + ".prefill"],
                               want[case + ".prefill"], rtol=RTOL,
                               atol=ATOL)
    for i, logits in enumerate(got[0][case + ".decode"]):
        np.testing.assert_allclose(logits, want[f"{case}.decode{i}"],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("case", IDS)
def test_forward_flops_are_split_over_model(ranks, case):
    got, _ = ranks
    for r, out in enumerate(got):
        counted, analytic = out[case + ".flops"]
        assert abs(counted - analytic) <= 0.1 * analytic, (r, counted,
                                                           analytic)


@pytest.mark.parametrize("case", IDS)
def test_no_leaf_is_gathered_over_a_tensor_parallel_dim(ranks, case):
    got, _ = ranks
    for out in got:
        assert out[case + ".gathers_over_model"] == 0
    # fsdp_tp at (2, 2) stores d_model over "data": those dims are gathered
    assert (got[0][case + ".gathers"] > 0) == case.startswith("2x2.fsdp_tp")


@pytest.mark.parametrize("case", IDS)
def test_each_rank_holds_its_rows_and_positions_of_the_cache(ranks, case):
    from repro_torch.configs import get_smoke
    got, _ = ranks
    mname, _, vname = case.split(".")
    data, model = MESHES[mname]
    cfg = get_smoke("qwen2-1.5b").replace(**VARIANTS[vname])
    shape = (cfg.num_layers, SB // data, S // model, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    for out in got:
        assert out[case + ".cache"] == (shape, shape)


def test_hybrid_shared_block_meets_the_unmeshed_model(ranks):
    got, _ = ranks
    out = got[0]
    np.testing.assert_allclose(out["hybrid.loss"], out["hybrid.plain.loss"],
                               rtol=RTOL)
    np.testing.assert_allclose(out["hybrid.meshed.prefill"],
                               out["hybrid.plain.prefill"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(out["hybrid.meshed.gen"],
                                  out["hybrid.plain.gen"])


def _moe_layer(rank, world):
    """dbrx's smoke config on a forced one-rank mesh under ``fsdp_tp``:
    layer 0's leaves as the layer takes them (``_keep``): a block's spec
    (a ``Local``), or None for a plain tensor."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import param as Pm
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine
    model = get_model(get_smoke("dbrx-132b").replace(sharding="fsdp_tp"))
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    eng = ServeEngine(model, model.init(0, device="cpu"), S, SB,
                      device="cpu", mesh=mesh, policy="fsdp_tp", force=True)
    got = shd.layer(Pm.nest(eng.params)["blocks"], 0, eng._view,
                    tf._keep(model.cfg))
    eng.close()

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, (tuple(v.spec) if isinstance(v, shd.Local)
                                   else None)
    return dict(flat(got))


def test_moe_experts_reach_the_island_as_stored():
    """The routed experts keep every stored dim, F and D over "data" too,
    so the MoE's gather route gathers F itself (in int8 where asked) and
    its psum route computes on its block; the attention takes the rule
    (its heads over "model" a block, d_model over "data" gathered)."""
    from repro_torch.launch.mesh import run_ranks
    got, = run_ranks(_moe_layer, 1, "cpu", threads=1, timeout=120)
    heads = (None, "model", None)
    stored = ("model", "data", None)
    assert got == {"attn.norm.scale": None, "attn.wq": heads,
                   "attn.wk": heads, "attn.wv": heads,
                   "attn.wo": ("model", None, None), "mlp_norm.scale": None,
                   "mlp.router": None, "mlp.w_gate": stored,
                   "mlp.w_up": stored, "mlp.w_down": stored}


@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
def test_flash_decode_merge_is_decode_attention(blocks):
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(blocks)
    Bq, H, Hk, hd, Sc, kv_len = 3, 4, 2, 8, 24, 17
    q = torch.randn(Bq, 1, H, hd, generator=g)
    k = torch.randn(Bq, Sc, Hk, hd, generator=g)
    v = torch.randn(Bq, Sc, Hk, hd, generator=g)
    for window in (0, 5):
        want = L.decode_attention(q, k, v, kv_len=kv_len, window=window)
        n = Sc // blocks
        states = [L.decode_attention_partial(
            q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
            kv_len=kv_len, k_start=i * n, window=window)
            for i in range(blocks)]
        stacked = L.DecodeState(*(torch.stack(t) for t in zip(*states)))
        got = L.merge_decode_states(stacked, q.dtype)
        if blocks == 1:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["tp", "fsdp_tp", "fsdp", "fsdp_tp_seq"])
def test_rule_splits_heads_mlp_and_vocab_over_model(policy):
    """qwen2-1.5b on the production (16, 16) mesh: its 12 query and 2 kv
    heads stay whole (the specs' divisibility fallback), d_ff 8,960 and the
    vocabulary 151,936 are tensor-parallel over "model" under ``tp`` and
    ``fsdp_tp``; "data" and every axis under ``fsdp`` and ``fsdp_tp_seq``
    (whose rows split over "model") are storage."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import param as Pm
    from repro_torch.models.registry import get_model
    sizes = {"data": 16, "model": 16}
    specs = {k: shd.logical_to_pspec(sp.shape, sp.logical, sizes, policy)
             for k, sp in Pm.iter_specs(get_model(
                 get_config("qwen2-1.5b")).specs)}
    tp = {k: shd.tp_dims(s, policy) for k, s in specs.items()}
    split = policy in ("tp", "fsdp_tp")
    for k in ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wo",
              "blocks.attn.bq"):
        assert tp[k] == {}, (k, specs[k])
    for k, dim in (("blocks.mlp.w_gate", 2), ("blocks.mlp.w_up", 2),
                   ("blocks.mlp.w_down", 1), ("embed", 0), ("lm_head", 1)):
        assert tp[k] == ({dim: ("model",)} if split else {}), (k, specs[k])
    assert all("data" not in axes for d in tp.values()
               for axes in d.values())
