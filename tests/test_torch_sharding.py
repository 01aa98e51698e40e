"""The port's sharding rules against the reference's: ``logical_to_pspec``
over every policy, every shipped config's full parameter tree and the
meshes (1,) and (4,) of ``data``, (2, 2), (16, 16) and (2, 16, 16).  The
reference's functions read only a mesh's ``axis_names`` and ``devices``
shape, so both packages get stub meshes; no process is started."""
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import sharding as sh
from repro_torch.models import param as PM
from repro_torch.models.registry import get_model

MESHES = {"data1": ((1,), ("data",)), "data4": ((4,), ("data",)),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StubMesh:
    """What the reference's rule functions read of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(shape, np.int8)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _reference_specs(cfg_name, smoke):
    from repro.configs import get_config as jget, get_smoke as jsmoke
    from repro.models.registry import get_model as jget_model
    m = jget_model((jsmoke if smoke else jget)(cfg_name))
    shapes = {k: tuple(v.shape) for k, v in _flat(m.abstract_params()).items()}
    return shapes, {k: tuple(v) for k, v in _flat(m.logical_axes()).items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_carry_the_reference_logical_axes(arch, smoke):
    cfg = (get_smoke if smoke else get_config)(arch)
    specs = get_model(cfg).specs
    shapes, logical = _reference_specs(arch, smoke)
    mine = PM.logical_axes(specs)
    assert mine == logical
    assert {k: s.shape for k, s in PM.iter_specs(specs)} == shapes


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_pspecs_equal_the_reference(arch, mesh):
    from repro.distributed import sharding as jsh
    shape, axes = MESHES[mesh]
    stub = StubMesh(shape, axes)
    cfg = get_config(arch)
    specs = get_model(cfg).specs
    logical = PM.logical_axes(specs)
    flat = dict(PM.iter_specs(specs))
    for policy in sh.POLICIES:
        mine = sh.tree_pspecs(flat, logical, stub, policy)
        sizes = dict(zip(axes, shape))
        assert sh.tree_pspecs(flat, logical, sizes, policy) == mine
        for path, spec in flat.items():
            want = jsh.logical_to_pspec(spec.shape, logical[path], stub,
                                        policy)
            assert tuple(mine[path]) == tuple(want), (policy, path)


def test_policies_are_the_reference_policies():
    from repro.distributed import sharding as jsh
    assert sh.POLICIES == jsh.POLICIES


@pytest.mark.parametrize("policy", sorted(sh.POLICIES))
def test_every_logical_axis_maps_as_the_reference(policy):
    """Each logical axis alone and in pairs, at dims that divide every
    mesh, that divide none, and that divide only part of a joint rule."""
    from repro.distributed import sharding as jsh
    names = sorted(sh.POLICIES[policy]) + [None]
    for mesh in MESHES.values():
        stub = StubMesh(*mesh)
        for a in names:
            for b in names:
                for shape in ((512, 256), (12, 7), (32, 24)):
                    got = sh.logical_to_pspec(shape, (a, b), stub, policy)
                    want = jsh.logical_to_pspec(shape, (a, b), stub, policy)
                    assert tuple(got) == tuple(want), (mesh, a, b, shape)


def test_assign_helpers_equal_the_reference():
    from repro.distributed import sharding as jsh
    sizes = {"data": 16, "model": 16}
    for assign in (None, "pod", "data", ("pod", "data"),
                   ("model", "data", "pod"), ("pod",)):
        assert sh._assign_size(assign, sizes) == jsh._assign_size(assign,
                                                                  sizes)
        assert sh._filter_assign(assign, sizes) == jsh._filter_assign(
            assign, sizes)


def test_constrain_returns_its_input():
    import torch
    x = torch.ones(2, 3)
    assert sh.constrain(x, {"data": 2}, "fsdp_tp", "batch", None) is x


def test_tree_size_bytes_counts_every_tensor():
    import torch
    tree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5,
                                                          dtype=torch.int8)}}
    assert sh.tree_size_bytes(tree) == 3 * 4 * 4 + 5


def test_production_mesh_refuses_a_world_of_four(monkeypatch):
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(M, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="this world has 4"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")


def test_build_mesh_of_nothing_is_none():
    from repro_torch.launch.label import build_mesh, parse_mesh
    assert build_mesh("") is None
    assert parse_mesh("data=2,model=2") == ((2, 2), ("data", "model"))


def test_run_ranks_refuses_more_cuda_ranks_than_cards():
    """Before any rank starts, and through the launcher's ``--mesh``: a
    mesh is never run on the CPU in place of the cards it names."""
    import torch
    from repro_torch.launch import label
    from repro_torch.launch.mesh import run_ranks
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"this host has {n - 1}"):
        run_ranks(print, n, "cuda")
    with pytest.raises(ValueError, match=f"this host has {n - 1}"):
        label.main(["--live", "--pool", "100", "--mesh", f"data={n}"])


def test_to_placements_shards_each_named_mesh_dim():
    import types

    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.to_placements(sh.P(None, "model", "data"), mesh) == (
        Replicate(), Shard(2), Shard(1))
    assert sh.to_placements(sh.P(("data", "model"), None), mesh) == (
        Replicate(), Shard(0), Shard(0))
    assert sh.to_placements(sh.P(None, None), mesh) == (Replicate(),) * 3
