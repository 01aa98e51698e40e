"""Roofline analysis (``repro.launch.roofline``): compute / memory /
collective terms per cell, for the NVIDIA H100.

The terms are derived from the config's algebra, as the reference's are,
with the same arithmetic in the same order: the twin's FLOP, byte and wire
counts are the reference's to the last bit, and only the hardware
constants differ.  The reference derives them analytically because XLA's
cost analysis counts a scanned layer's body once; the port runs its layer
loop eagerly, so ``torch.utils.flop_counter.FlopCounterMode`` counts every
layer, and the tests hold ``forward_flops`` against it on small configs.
``launch.dryrun`` traces a cell's step on a fake world and reports the
counted FLOPs beside these.

Hardware: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
  PEAK_FLOPS = 989 TFLOP/s  bf16 on the tensor cores, no sparsity
  HBM_BW     = 3.35 TB/s    HBM3
  NET_BW     = 50 GB/s      per GPU per direction across nodes: a
               production mesh axis of 16 spans two 8-GPU NVLink domains,
               so its collectives cross nodes at one 400 Gb/s NDR
               InfiniBand NIC per GPU (DGX H100's layout).  Within a node
               NVLink gives 450 GB/s per direction, but no mesh of the
               reference fits in one node.

Terms (seconds, per device, per step):
  compute    = FLOPs_local / PEAK_FLOPS
  memory     = HBM_bytes_local / HBM_BW
  collective = wire_bytes_local / NET_BW

``Roofline.model_flops`` (the 6 N D useful floor) and ``Roofline.mfu``
(model FLOPs over step time x peak x devices) are the yardstick a
whole-step ``mfu`` of the port's training is read against.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12        # bf16 dense / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s (H100 SXM HBM3)
NET_BW = 50e9              # bytes/s/GPU, one direction: 400 Gb/s NDR IB

BYTES_W = 2                # bf16 weights/activations
BYTES_G = 4                # f32 grad reduction


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamCounts:
    total: float          # every stored parameter
    body_active: float    # matmul params exercised per token (no embed/head)
    head: float           # LM-head matmul params
    embed: float          # gather-only embedding params

    @property
    def active(self) -> float:
        return self.body_active + self.head + self.embed


def param_counts(cfg: ModelConfig) -> ParamCounts:
    """Analytic parameter accounting.  ``body_active`` is what 6*N*D-style
    MODEL_FLOPS should count alongside the head (embeddings are gathers,
    not matmuls)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def attn():
        return D * hd * (nq + 2 * nkv) + nq * hd * D

    def mlp(f=None):
        f = f or F
        return 3 * D * f if cfg.act == "swiglu" else 2 * D * f

    embed = float(V * D)
    head = float(D * V)  # tied or not, logits matmul exercises D*V weights
    stored_head = 0.0 if cfg.tie_embeddings else head
    total = embed + stored_head
    body = 0.0

    if cfg.family in ("dense", "vlm"):
        body = cfg.num_layers * (attn() + mlp())
        total += body
    elif cfg.family == "moe":
        E, k, ns = cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts
        expert = 3 * D * F
        shared = mlp(ns * F) if ns else 0
        router = D * E
        total += cfg.num_layers * (attn() + E * expert + shared + router)
        body = cfg.num_layers * (attn() + k * expert + shared + router)
    elif cfg.family == "ssm":
        body = cfg.num_layers * _mamba_params(cfg)
        total += body
    elif cfg.family == "hybrid":
        per = _mamba_params(cfg)
        shared_blk = attn() + mlp()
        total += cfg.num_layers * per + shared_blk
        napp = cfg.num_layers // cfg.shared_attn_every
        body = cfg.num_layers * per + napp * shared_blk  # executions count
    elif cfg.family == "audio":
        per = attn() + mlp()
        xattn = attn()
        body = (cfg.encoder_layers * per + cfg.num_layers * (per + xattn))
        total += body
        if cfg.pos_embed == "learned":
            total += (cfg.encoder_tokens + cfg.max_seq_len) * D
    return ParamCounts(total=float(total), body_active=float(body),
                       head=head, embed=embed)


def _mamba_params(cfg: ModelConfig) -> float:
    D, di = cfg.d_model, cfg.ssm_d_inner
    N, H, K = cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_conv_kernel
    return (2 * D * di      # w_z, w_x
            + 2 * D * N     # w_B, w_C
            + D * H         # w_dt
            + K * di        # conv
            + di * D)       # out


# ---------------------------------------------------------------------------
# forward FLOPs
# ---------------------------------------------------------------------------


def _attn_ctx_flops(cfg: ModelConfig, T_q: float, T_ctx: float,
                    window: int) -> float:
    """Score+PV FLOPs for T_q query tokens against avg context T_ctx."""
    eff = min(window, T_ctx) if window > 0 else T_ctx
    return 4.0 * T_q * eff * cfg.num_heads * cfg.resolved_head_dim


def _layer_flops(cfg: ModelConfig, T_q: float, T_ctx: float,
                 is_global: bool) -> float:
    """One transformer layer, T_q tokens, matmuls + attention."""
    D, F = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    qkvo = 2.0 * T_q * (D * hd * (nq + 2 * nkv) + nq * hd * D)
    window = 0 if is_global else cfg.sliding_window
    attn = _attn_ctx_flops(cfg, T_q, T_ctx, window)
    if cfg.family == "moe":
        E, k, ns = cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts
        mlp = 2.0 * T_q * (D * E + k * 3 * D * F + (3 * D * ns * F if ns else 0))
    else:
        mlp = 2.0 * T_q * (3 * D * F if cfg.act == "swiglu" else 2 * D * F)
    return qkvo + attn + mlp


def _mamba_layer_flops(cfg: ModelConfig, T_q: float) -> float:
    D, di = cfg.d_model, cfg.ssm_d_inner
    N, H, hd = cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    C = min(cfg.ssm_chunk, int(max(T_q, 1)))
    proj = 2.0 * T_q * (2 * D * di + 2 * D * N + D * H + di * D)
    conv = 2.0 * T_q * cfg.ssm_conv_kernel * di
    # SSD: intra-chunk scores C*N + C*H*hd per (token, chunk-peer) + states
    intra = 2.0 * T_q * C * (N + H * hd)
    states = 4.0 * T_q * H * hd * N  # build S + apply C to h
    return proj + conv + intra + states


def forward_flops(cfg: ModelConfig, T_q: float, T_ctx: float,
                  with_head_tokens: float = 0.0) -> float:
    """Full-model forward FLOPs for T_q tokens (per sequence position
    average context T_ctx; pass T_ctx=(T+1)/2 for causal full-sequence)."""
    total = 0.0
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio + 1
            n_global = cfg.num_layers // r
            n_local = cfg.num_layers - n_global
            total += n_global * _layer_flops(cfg, T_q, T_ctx, True)
            total += n_local * _layer_flops(cfg, T_q, T_ctx, False)
        else:
            total += cfg.num_layers * _layer_flops(cfg, T_q, T_ctx, True)
    elif cfg.family == "ssm":
        total += cfg.num_layers * _mamba_layer_flops(cfg, T_q)
    elif cfg.family == "hybrid":
        total += cfg.num_layers * _mamba_layer_flops(cfg, T_q)
        napp = cfg.num_layers // cfg.shared_attn_every
        total += napp * _layer_flops(cfg, T_q, T_ctx, True)
    elif cfg.family == "audio":
        Te = cfg.encoder_tokens
        total += cfg.encoder_layers * _layer_flops(cfg, Te, Te, True)
        total += cfg.num_layers * (_layer_flops(cfg, T_q, T_ctx, True)
                                   + _layer_flops(cfg, T_q, Te, True))
    total += 2.0 * with_head_tokens * cfg.d_model * cfg.vocab_size
    return total


# ---------------------------------------------------------------------------
# per-cell roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_local: float
    hbm_bytes_local: float
    wire_bytes_local: float
    model_flops: float          # 6*N(_active)*D tokens (the useful floor)
    hlo_flops_local: float      # analytic compiled-work estimate
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_local * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (step time * peak * chips) — roofline-implied MFU."""
        denom = self.step_s * PEAK_FLOPS * self.n_devices
        return self.model_flops / denom if denom else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.flops_local * self.n_devices,
            "useful_ratio": self.useful_ratio, "mfu": self.mfu,
        }


def mesh_sizes(mesh_kind: str) -> Dict[str, int]:
    return ({"pod": 2, "data": 16, "model": 16} if mesh_kind == "multi"
            else {"data": 16, "model": 16})


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_kind: str,
                 grad_accum: int = 1,
                 overrides: Optional[Dict] = None) -> Roofline:
    """Analytic roofline for one (arch x shape x mesh) cell.

    ``overrides`` lets the perf loop model candidate changes without
    re-lowering: {"remat_factor": float, "ce_materialize": bool,
    "tp_act_collectives": bool, "fsdp_gather_per_microbatch": bool,
    "grad_bytes": int, "wd": int (weight-sharding ways), ...}.
    """
    o = dict(overrides or {})
    sizes = mesh_sizes(mesh_kind)
    n_dev = math.prod(sizes.values())
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    tp = sizes.get("model", 1)

    pc = param_counts(cfg)
    B, T = shape.global_batch, shape.seq_len
    D, V = cfg.d_model, cfg.vocab_size

    params_bytes = pc.total * BYTES_W
    serving = shape.kind != "train"
    # Serving keeps weights TP-resident when a 1/tp shard fits one chip
    # (policy "tp"); otherwise (and for training) fsdp_tp shards weights
    # over data x model and the data-axis shards are re-gathered per use.
    policy = cfg.sharding
    if serving and cfg.family != "moe" and params_bytes / tp < 12e9 and \
            policy == "fsdp_tp":
        policy = "tp"
    if policy == "fsdp":       # pure ZeRO-DP: the model axis is extra DP
        dp, tp = dp * tp, 1
    wd = o.get("wd", dp * tp if policy in ("fsdp_tp", "fsdp")
               else (1 if policy == "seq_serve" else tp))
    params_local = params_bytes / wd
    n_layers = cfg.num_layers + cfg.encoder_layers
    dense_total = (pc.total - pc.embed -
                   (0.0 if cfg.tie_embeddings else pc.head))
    if cfg.family == "moe":
        expert_layer = (cfg.num_experts * 3 * D * cfg.d_ff)
        dense_layer_bytes = (dense_total / n_layers - expert_layer) * BYTES_W
        expert_layer_bytes = expert_layer * BYTES_W
    else:
        dense_layer_bytes = dense_total / max(n_layers, 1) * BYTES_W
        expert_layer_bytes = 0.0

    def wire_per_layer(micro_tokens_dp: float) -> float:
        """Per-device wire bytes for ONE layer on one microbatch pass.

        Dense/attention: weights stay model-sharded; under fsdp_tp the
        data-axis shards are all-gathered per use (ingress ~ shard x
        (dp-1)/dp); TP partial sums cost 2 activation all-reduces (ring
        ~2x payload).  MoE: min(our ZeRO-3 expert-F gather route, the
        EP-resident token all-to-all route).
        """
        if policy == "seq_serve":
            # replicated weights, seq-sharded activations: K/V gathered
            # over "model" per layer is the only layer collective
            kv = 2.0 * (B / dp) * T * cfg.num_kv_heads * \
                cfg.resolved_head_dim * BYTES_W
            return kv * (tp - 1) / tp if tp > 1 else 0.0
        gather = (dense_layer_bytes / tp * (dp - 1) / dp
                  if policy in ("fsdp_tp", "fsdp") and dp > 1 else 0.0)
        tp_ar = (2.0 * micro_tokens_dp * D * BYTES_W * 2.0
                 if tp > 1 else 0.0)
        out = gather + tp_ar
        if cfg.family == "moe":
            k = cfg.experts_per_token
            if o.get("moe_a2a", False):
                # candidate EP route (modeled, §Perf): experts resident,
                # tokens all-to-all'd to their owners — dispatch + combine
                out += 2.0 * micro_tokens_dp * k * D * BYTES_W
            else:
                # the code's route: ZeRO-3 expert-F shards gathered per use
                # (halved when moe_gather_dtype == int8), combine via psum
                gb = 1 if cfg.moe_gather_dtype == "int8" else BYTES_W
                out += (expert_layer_bytes / BYTES_W * gb / tp * (dp - 1) / dp
                        if dp > 1 else 0.0)
        return out

    if shape.kind == "train":
        tokens = B * T
        tokens_local = tokens / dp
        micro_tokens_local = tokens_local / grad_accum
        T_ctx = (T + 1) / 2
        remat_f = o.get("remat_factor", 1.0)
        body = forward_flops(cfg, tokens, T_ctx)
        head = 2.0 * tokens * D * V
        flops_global = body * (3.0 + remat_f) + head * 3.0
        model_flops = 6.0 * (pc.body_active + pc.head) * tokens
        flops_local = flops_global / n_dev

        # HBM traffic (per device):
        #  weights streamed fwd+recompute+bwd per microbatch + optimizer
        w_reads = (2.0 + remat_f) * grad_accum * params_local
        opt = o.get("opt_bytes_factor", 3.0) * pc.total * 4 / wd
        #  residual carries written fwd / read bwd + working activations
        act = 6.0 * n_layers * tokens_local * D * BYTES_W
        #  CE logits traffic (XLA materializes chunked logits in HBM;
        #  a Pallas-fused CE removes this -> override ce_fused)
        ce = 0.0 if o.get("ce_fused", False) else \
            3.0 * tokens_local * V * 4 / tp
        hbm = w_reads + opt + act + ce

        # wire: per-layer route x layers x passes x microbatches
        passes = 2.0 + remat_f   # fwd + recompute + bwd traffic
        wire_layers = wire_per_layer(micro_tokens_local) * n_layers * \
            passes * grad_accum
        grad_bytes = o.get("grad_bytes", BYTES_G)
        # grads of model-sharded weights reduce over the data axis only
        grad_rs = pc.total / tp * grad_bytes * (dp - 1) / dp
        wire = wire_layers + grad_rs
    elif shape.kind == "prefill":
        tokens = B * T
        tokens_local = tokens / dp
        T_ctx = (T + 1) / 2
        flops_global = forward_flops(cfg, tokens, T_ctx, with_head_tokens=B)
        model_flops = 2.0 * pc.body_active * tokens + 2.0 * B * D * V
        flops_local = flops_global / n_dev
        kv_bytes = _cache_bytes(cfg, B, T)
        hbm = (params_local + 4.0 * n_layers * tokens_local * D * BYTES_W
               + kv_bytes / n_dev)
        wire = wire_per_layer(tokens_local) * n_layers
    else:  # decode: one token per sequence, cache of T
        tokens = B
        flops_global = forward_flops(cfg, tokens, T, with_head_tokens=B)
        model_flops = 2.0 * pc.body_active * tokens + 2.0 * B * D * V
        flops_local = flops_global / n_dev
        cache = _cache_bytes(cfg, B, T)
        hbm = params_local + cache / n_dev  # stream weights + cache once
        wire = wire_per_layer(float(B) / dp) * n_layers
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_kind, n_devices=n_dev,
        flops_local=flops_local, hbm_bytes_local=hbm, wire_bytes_local=wire,
        model_flops=model_flops, hlo_flops_local=flops_local,
        compute_s=flops_local / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=wire / NET_BW,
    )


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    if cfg.family == "ssm":
        return B * cfg.num_layers * (
            cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            + (cfg.ssm_conv_kernel - 1) * cfg.ssm_d_inner * BYTES_W)
    kv = 2 * B * S * cfg.num_kv_heads * cfg.resolved_head_dim * BYTES_W
    if cfg.family == "hybrid":
        napp = cfg.num_layers // cfg.shared_attn_every
        ssm = B * cfg.num_layers * (
            cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            + (cfg.ssm_conv_kernel - 1) * cfg.ssm_d_inner * BYTES_W)
        return napp * kv + ssm
    if cfg.family == "audio":
        xkv = 2 * B * cfg.encoder_tokens * cfg.num_kv_heads * \
            cfg.resolved_head_dim * BYTES_W
        return cfg.num_layers * (kv + xkv)
    return cfg.num_layers * kv


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def full_table(grad_accums: Optional[Dict] = None, mesh_kind: str = "single"):
    from repro_torch.configs import ARCH_IDS, cells, get_config
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in cells(arch):
            ga = (grad_accums or {}).get((arch, shape.name), 1)
            rows.append(analyze_cell(cfg, shape, mesh_kind, ga))
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--dryrun-jsonl", default="results/dryrun_torch.jsonl")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    accums = {}
    try:
        with open(args.dryrun_jsonl) as f:
            for line in f:
                r = json.loads(line)
                if "grad_accum" in r:
                    accums[(r["arch"], r["shape"])] = r["grad_accum"]
    except FileNotFoundError:
        pass

    rows = full_table(accums, args.mesh)
    if args.json:
        print(json.dumps([r.row() for r in rows]))
        return
    hdr = (f"{'arch':22s} {'shape':12s} {'comp(ms)':>9s} {'mem(ms)':>9s} "
           f"{'coll(ms)':>9s} {'dominant':>10s} {'useful':>7s} {'MFU':>6s}")
    print(hdr)
    for r in rows:
        print(f"{r.arch:22s} {r.shape:12s} {r.compute_s*1e3:9.2f} "
              f"{r.memory_s*1e3:9.2f} {r.collective_s*1e3:9.2f} "
              f"{r.dominant:>10s} {r.useful_ratio:7.2f} {r.mfu:6.3f}")


if __name__ == "__main__":
    main()
