"""Multi-pod dry-run (``repro.launch.dryrun``): trace one step of every
(architecture x input shape) cell on the production meshes and count what
one device does.

The reference forces 512 XLA host devices, compiles each cell and reads
XLA's cost and memory analyses and the collectives of the optimized HLO.
The twin runs the port's own step in a fake world: a ``fake`` process
group of 256 (512) ranks in which this process is rank 0 (or
``--rank``) and every collective returns at once, the real production
mesh over it (``launch.mesh.make_production_mesh``), and every tensor a
``FakeTensor`` (shapes and dtypes, no storage), so nothing is allocated
and no data is computed.  Train cells go through
``train_loop.make_sharded_train_step`` with the grad accumulation the
reference would pick; prefill and decode cells through the model's
``prefill`` and ``decode_step`` over the mesh,
with parameters stored as the policy shards them (each layer computing on
its tensor-parallel blocks) and each rank holding its rows of the batch
and its rows and block of positions of the cache.

Per cell this emits JSON (the reference's keys), all per device (the
traced rank).  Under a sequence split the ranks differ: a Mamba2 block's
rank past the first along "model" scans twice where rank 0 scans once, so
``--rank 15`` (the last "model" rank of the (16, 16) mesh) is the
busiest.  The keys:
  flops            — ``FlopCounterMode``'s total: PyTorch runs the layer
                     loop eagerly, so every layer is counted (XLA counts a
                     scanned body once)
  bytes_accessed   — the bytes of every dispatched op's operands and
                     outputs (views excluded): each op of eager PyTorch is
                     a kernel of its own
  collective_bytes — {op: operand bytes} of the c10d collectives issued,
  collective_counts  by the reference's op names
  memory           — argument_bytes (the local state and batch),
                     output_bytes, temp_bytes (the peak of live storages
                     above the arguments); generated_code_bytes is None
  n_devices

There is no HLO: ``--keep-ops PATH`` writes one JSON line per dispatched
op (its name and its inputs' and outputs' shapes) where the reference's
``--keep-hlo`` wrote the HLO text.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape train_4k --policy fsdp_tp_seq --rank 15
  python -m repro_torch.launch.dryrun --sweep          # every cell, subprocesses
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed import sharding as shd

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# the c10d ops the port's collectives dispatch (``dist.all_gather``,
# ``all_reduce``, ``reduce_scatter``, ``all_to_all_single``, and halo
# attention's sends: a permute counted once, at its send), by the
# reference's names, each with the argument that holds its operand
_COLLECTIVE_OF = {"allgather_": ("all-gather", "input_tensors"),
                  "allreduce_": ("all-reduce", "tensors"),
                  "reduce_scatter_": ("reduce-scatter", "input_tensors"),
                  "alltoall_base_": ("all-to-all", "input"),
                  "send": ("collective-permute", "tensors")}


# ---------------------------------------------------------------------------
# per-arch train config + microbatching policy
# ---------------------------------------------------------------------------


def pick_train_config(param_count: int):
    """Optimizer-memory policy by model size (ZeRO-sharded either way)."""
    from repro_torch.configs.base import TrainConfig
    if param_count >= 100e9:
        return TrainConfig(moment_dtype="int8", factored_second_moment=True,
                           accum_dtype="bfloat16")
    if param_count >= 10e9:
        return TrainConfig(moment_dtype="bfloat16", factored_second_moment=True)
    return TrainConfig()


def pick_grad_accum(cfg, shape, mesh) -> int:
    """Smallest power-of-two microbatch count keeping the per-device
    residual-stream carries (layers x B_local x T x D x 2B, the checkpoints
    reverse-mode must store) under ~2 GB.  The batch-sharding ways come
    from the active policy (e.g. "fsdp" shards batch over the whole mesh)
    and each microbatch must stay divisible by them.  ``mesh``: a
    ``DeviceMesh`` or an ``{axis: size}`` mapping."""
    if shape.kind != "train":
        return 1
    from repro_torch.distributed.sharding import POLICIES, mesh_axis_sizes
    sizes = mesh_axis_sizes(mesh)
    assign = POLICIES[cfg.sharding]["batch"]
    names = (assign,) if isinstance(assign, str) else tuple(assign or ())
    ways = 1
    for n in names:
        if n in sizes and shape.global_batch % (ways * sizes[n]) == 0:
            ways *= sizes[n]
    b_local = max(shape.global_batch // ways, 1)
    layers = cfg.num_layers + cfg.encoder_layers
    seq_assign = POLICIES[cfg.sharding].get("seq")
    seq_ways = sizes.get(seq_assign, 1) if isinstance(seq_assign, str) else 1
    if shape.seq_len % max(seq_ways, 1):
        seq_ways = 1
    carry = b_local * (shape.seq_len // seq_ways) * cfg.d_model * 2 * layers
    budget = 2 * 1024 ** 3
    accum = 1
    while carry / accum > budget and accum < b_local and \
            (shape.global_batch // (accum * 2)) % ways == 0:
        accum *= 2
    return accum


def seq_ways(cfg, T: int, mesh) -> int:
    """The "model" ranks a ``T``-position sequence splits over on a mesh
    of ``{axis: size}`` under the config's policy
    (``transformer.seq_split``): "model"'s size where the policy splits
    the sequence and the size divides ``T``, else 1."""
    from repro_torch.models import transformer as tf
    M = mesh.get("model", 1)
    return M if tf.splits_seq(cfg.sharding, M, T) else 1


def split_forward_flops(cfg, seq_len: int, mesh) -> Tuple[float, float]:
    """Per token of a ``seq_len`` sequence, the FLOPs one device computes
    in a forward under the port's tensor-parallel design, from the config
    and the specs, as (the layers', the head's): the roofline's per-token
    products (``roofline._layer_flops`` and ``_mamba_layer_flops``'
    terms), each over the size of the axes its weight dim is
    tensor-parallel over (``sharding.tp_dims`` of its spec under the
    config's policy), the attention on the query heads' share and, as the
    traced path's plain attention computes every key chunk whole, each
    query against all its keys (the last chunk padded); a Mamba2 mixer's
    projections, intra-chunk products and states on its heads' share (B
    and C whole on every rank; all of it whole where its heads and inner
    width do not split alike, as ``mamba2.mixer_params`` computes them);
    whisper's encoder and cross-attention keys counted per decoder token;
    the head over its vocabulary's share.  Every token family but the
    MoE's.  ``mesh``: an ``{axis: size}`` mapping.

    Under a sequence split (:func:`seq_ways`: ``fsdp_tp_seq``,
    ``seq_serve``) the count is per token of a rank's block: the
    attention's keys stay the whole sequence's (gathered); a Mamba2
    mixer's chunk is at most the block, and a rank past the first scans
    its block twice (from zero for the exchange, then from its incoming
    state; rank 0 once) and sums the M - 2 decayed states before its own
    (the conv's halo moves data only); whisper's encoder runs on a rank's
    share of the frames where "model" divides them (every frame on every
    rank otherwise) and every rank projects the whole encoder output to
    the cross-attention's keys and values."""
    from repro_torch.models import param as P
    from repro_torch.models.registry import get_model
    if cfg.family not in ("dense", "vlm", "ssm", "hybrid", "audio"):
        raise NotImplementedError(f"no split count for {cfg.family!r}")
    specs = {k: shd.logical_to_pspec(sp.shape, sp.logical, mesh,
                                     cfg.sharding)
             for k, sp in P.iter_specs(get_model(cfg).specs)}

    def axes(path):
        return tuple(a for ax in shd.tp_dims(specs[path],
                                             cfg.sharding).values()
                     for a in ax)

    def ways(path):
        return math.prod(mesh[a] for a in axes(path))
    D, F, hd, T = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim, seq_len
    mult = 3 if cfg.act == "swiglu" else 2

    def attn(pre, keys):
        """A query token's projections and attention over ``keys``."""
        H = cfg.num_heads / ways(pre + "attn.wq")
        Hk = cfg.num_kv_heads / ways(pre + "attn.wk")
        return 2.0 * D * hd * (2 * H + 2 * Hk) + 4.0 * keys * H * hd

    def mlp(pre):
        return 2.0 * mult * D * F / ways(pre + "mlp.w_down")

    M = seq_ways(cfg, T, mesh)

    def mixer(pre):
        di, N = cfg.ssm_d_inner, cfg.ssm_state
        H, C = cfg.ssm_num_heads, min(cfg.ssm_chunk, T // M)
        w = ways(pre + "w_dt") \
            if axes(pre + "w_dt") == axes(pre + "w_x") else 1
        proj = 2.0 * (2 * D * di / w + 2 * D * N + D * H / w + di * D / w)
        scan = 2.0 * C * (N + H * hd_s / w) + 4.0 * H * hd_s * N / w
        if M == 1:
            return proj + scan
        return (proj + 2 * scan
                + 2.0 * max(M - 2, 0) * H * hd_s * N / w / (T // M))

    hd_s = cfg.ssm_head_dim
    if cfg.family in ("dense", "vlm"):
        layers = cfg.num_layers * (attn("blocks.", T) + mlp("blocks."))
    elif cfg.family == "ssm":
        layers = cfg.num_layers * mixer("blocks.")
    elif cfg.family == "hybrid":
        layers = (cfg.num_layers * mixer("mamba_blocks.")
                  + cfg.num_layers // cfg.shared_attn_every
                  * (attn("shared.", T) + mlp("shared.")))
    else:
        Te = cfg.encoder_tokens
        ck = min(512, Te)
        Te_keys = -(-Te // ck) * ck
        H = cfg.num_heads / ways("decoder.xattn.wq")
        Hk = cfg.num_kv_heads / ways("decoder.xattn.wk")
        # a rank's frames, and the whole output it projects, per token of
        # its block of the decoder's positions
        frames = Te * M / seq_ways(cfg, Te, mesh)
        cross = (4.0 * D * hd * H + 4.0 * Te_keys * H * hd
                 + 4.0 * D * hd * Hk * Te * M / T)
        enc = frames / T * (attn("encoder.", Te_keys) + mlp("encoder."))
        layers = (cfg.encoder_layers * enc + cfg.num_layers
                  * (attn("decoder.", T) + cross + mlp("decoder.")))
    head = 2.0 * D * cfg.vocab_size / ways(
        "embed" if cfg.tie_embeddings else "lm_head")
    return layers, head


def expected_train_flops(cfg, shape, mesh) -> float:
    """The FLOPs one device computes in a train cell's traced step:
    :func:`split_forward_flops`, the layers counted 3 + remat times (1
    where ``cfg.remat`` recomputes each layer) and the head 3 times, as the
    roofline counts a step, for one device's tokens (the global batch's
    over the axes that split the rows: ``fsdp_tp_seq``'s "model" splits
    the sequence, ``transformer.seq_split``).  A head left whole (its vocabulary not
    tensor-parallel) under ``cfg.logits_chunk`` goes through the chunked
    loss: its vocabulary padded to whole chunks and each chunk recomputed
    in the backward, 4 times.  ``mesh``: an ``{axis: size}`` mapping."""
    layers, head = split_forward_flops(cfg, shape.seq_len, mesh)
    remat = 1.0 if cfg.remat != "none" else 0.0
    rows = math.prod(mesh[a] for a in shd.row_axes(cfg.sharding)
                     if a in mesh)
    tokens = shape.global_batch * shape.seq_len / rows
    V, chunk = cfg.vocab_size, cfg.logits_chunk
    if chunk and head >= 2.0 * cfg.d_model * V:
        return tokens * (layers * (3.0 + remat)
                         + 8.0 * cfg.d_model * -(-V // chunk) * chunk)
    return tokens * (layers * (3.0 + remat) + head * 3.0)


# ---------------------------------------------------------------------------
# building one cell
# ---------------------------------------------------------------------------


def _block(shape, dtype, spec, mesh):
    """An empty tensor of this rank's block of a ``shape`` array cut by
    ``spec`` (a fake one under ``FakeTensorMode``)."""
    return torch.empty(
        tuple(s.stop - s.start for s in shd.slices(shape, spec, mesh)),
        dtype=dtype)


def _placed(shape, dtype, sharding):
    """This rank's block of a ``shape`` leaf stored as ``sharding`` says."""
    return shd.place(_block(shape, dtype, sharding.spec, sharding.mesh),
                     sharding, shape)


def build_step(arch: str, shape_name: str, multi_pod: bool,
               policy: Optional[str] = None):
    """-> (step fn, args tuple, mesh, meta dict).  Call it in a world of
    256 (``multi_pod``: 512) ranks: ``args`` are this rank's blocks as
    ``FakeTensor``s, and the step runs under their ``fake_mode``
    (``run_cell``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, input_pspecs, input_specs
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import param as P
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_loop import (batch_rows,
                                                 make_sharded_train_step)

    cfg = get_config(arch)
    if policy:  # "<policy>[+int8gather][+a2a]"
        parts = policy.split("+")
        for flag in parts[1:]:
            if flag == "int8gather":
                cfg = cfg.replace(moe_gather_dtype="int8")
            elif flag == "a2a":
                cfg = cfg.replace(moe_route="a2a")
        if parts[0]:
            cfg = cfg.replace(sharding=parts[0])
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    policy = cfg.sharding
    model = get_model(cfg)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "policy": policy,
            "params": model.param_count()}

    if shape.kind == "train":
        accum = pick_grad_accum(cfg, shape, mesh)
        meta["grad_accum"] = accum
        tc = dataclasses.replace(pick_train_config(model.param_count()),
                                 grad_accum=accum)
        batch_ps = input_pspecs(cfg, shape, mesh, policy, accum)
        step, ab_state, state_sh = make_sharded_train_step(
            model, tc, mesh, policy, batch_ps)
        with FakeTensorMode():
            state = {"params": {k: _placed(*v, state_sh["params"][k])
                                for k, v in ab_state["params"].items()},
                     "opt": [{k: _placed(*v, state_sh["opt"][i][k])
                              for k, v in slot.items()}
                             for i, slot in enumerate(ab_state["opt"])],
                     "step": 0}
            batch = {k: _block(sh, dt, batch_ps[k], mesh) for k, (sh, dt)
                     in input_specs(cfg, shape, accum).items()}
        return step, (state, batch), mesh, meta

    # serving: the parameters stored as the policy shards them, this
    # rank's rows of the batch (and of the cache)
    batch_ps = input_pspecs(cfg, shape, mesh, policy)
    fake = FakeTensorMode()
    with fake:
        params = {k: _placed(sp.shape, sp.dtype, shd.named(
                      mesh, shd.logical_to_pspec(sp.shape, sp.logical, mesh,
                                                 policy)))
                  for k, sp in P.iter_specs(model.specs)}
        batch = {k: _block(sh, dt, batch_ps[k], mesh)
                 for k, (sh, dt) in input_specs(cfg, shape).items()}
    view = shd.MeshView(mesh, rows=batch_rows(batch_ps), policy=policy)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            hidden, cache = model.prefill(params, batch, mesh=view)
            logits = model.logits(params, hidden[:, -1:, :], view)
            return logits, cache

        return prefill_step, (params, batch), mesh, meta

    # decode: one new token against a seq_len cache (this rank's block of
    # its positions, where the policy's cache_seq splits them)
    with fake:
        cache = model.init_cache(batch["tokens"].shape[0], shape.seq_len,
                                 device="cpu", mesh=view)

    def serve_step(params, cache, tokens, cache_len):
        return model.decode_step(params, cache, tokens, cache_len,
                                 mesh=view, max_seq=shape.seq_len)

    return (serve_step, (params, cache, batch["tokens"], shape.seq_len - 1),
            mesh, meta)


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------


def _tensors(tree):
    """The plain tensors of a nested dict / list / tuple (a DTensor's
    local block)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, torch.Tensor):
        local = getattr(tree, "_local_tensor", None)
        return [tree if local is None else local]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Census(TorchDispatchMode):
    """A dispatch mode that sums the bytes of every op's operands and
    outputs (views excluded), counts the collectives and their operand
    bytes, tracks the live storages' peak, and writes each op to
    ``keep_ops`` (an open file) where one is given."""

    def __init__(self, keep_ops=None):
        super().__init__()
        self.keep_ops = keep_ops
        self.bytes_accessed = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tree) -> None:
        """Count the storages of ``tree`` as live until they are freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":   # metadata queries (.device)
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        coll = _COLLECTIVE_OF.get(func._schema.name.split("::")[-1]) \
            if func.namespace == "c10d" else None
        if coll is not None:
            kind, operand = coll
            names = [a.name for a in func._schema.arguments]
            i = names.index(operand)
            self.coll_bytes[kind] += _nbytes(
                kwargs[operand] if operand in kwargs else args[i])
            self.coll_counts[kind] += 1
        if not func.is_view:
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        self.hold(outs)
        if self.keep_ops is not None:
            self.keep_ops.write(json.dumps({
                "op": str(func), "in": [list(t.shape) for t in ins],
                "out": [list(t.shape) for t in outs]}) + "\n")
        return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             keep_ops: Optional[str] = None,
             policy: Optional[str] = None, rank: int = 0) -> Dict:
    """Trace one step of a cell on a fake world of 256 (512) ranks as
    ``rank`` and return the reference's record.  Refuses to start where a
    process group is already initialized (it must never join a real
    world); tears its fake world down before it returns."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("run_cell traces on a fake world of its own; a "
                           "process group is already initialized here")
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    ops_file = open(keep_ops, "w") if keep_ops else None
    try:
        step, args, mesh, meta = build_step(arch, shape_name, multi_pod,
                                            policy)
        with _tensors(args)[0].fake_mode:
            census = _Census(ops_file)
            census.hold(args)
            arg_bytes = census.live
            flops = FlopCounterMode(display=False)
            with flops, census:
                out = step(*args)
            out_bytes = _nbytes(out)
            n_dev = math.prod(int(n) for n in mesh.shape)
    finally:
        if ops_file is not None:
            ops_file.close()
        dist.destroy_process_group()
    record = dict(meta)
    record.update({
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(census.bytes_accessed),
        "collective_bytes": census.coll_bytes,
        "collective_counts": census.coll_counts,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": out_bytes,
                   "temp_bytes": census.peak - arg_bytes,
                   "generated_code_bytes": None},
        "n_devices": n_dev,
    })
    return record


# ---------------------------------------------------------------------------
# the sweep (subprocess per cell: isolation + memory reclamation)
# ---------------------------------------------------------------------------


def sweep(meshes=("single", "multi"), archs=None, shapes=None,
          out_path="results/dryrun_torch.jsonl", timeout: int = 1800):
    from repro_torch.configs import ARCH_IDS, cells
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except Exception:
                    pass
    failures = []
    for arch in (archs or ARCH_IDS):
        for shape in cells(arch):
            if shapes and shape.name not in shapes:
                continue
            for mesh_kind in meshes:
                key = (arch, shape.name, mesh_kind)
                if key in done:
                    print(f"[skip] {key}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape.name,
                       "--mesh", mesh_kind, "--append", out_path]
                print(f"[run ] {arch} x {shape.name} x {mesh_kind}",
                      flush=True)
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=timeout)
                    if r.returncode != 0:
                        failures.append((key, r.stderr[-2000:]))
                        print(f"[FAIL] {key}\n{r.stderr[-2000:]}", flush=True)
                except subprocess.TimeoutExpired:
                    failures.append((key, "timeout"))
                    print(f"[TIME] {key}", flush=True)
    print(f"sweep done; {len(failures)} failures")
    for key, err in failures:
        print("FAILED:", key)
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--append", help="append result JSON to this file")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--keep-ops",
                    help="write each dispatched op (name, shapes) here")
    ap.add_argument("--policy", help="override the sharding policy (perf)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world to trace as")
    args = ap.parse_args()
    if args.sweep:
        failures = sweep(out_path=args.out)
        sys.exit(1 if failures else 0)
    res = run_cell(args.arch, args.shape, args.mesh == "multi",
                   keep_ops=args.keep_ops, policy=args.policy,
                   rank=args.rank)
    js = json.dumps(res)
    print(js)
    if args.append:
        with open(args.append, "a") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
