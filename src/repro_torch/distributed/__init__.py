"""Checkpoints, straggler detection, the sharding rules, int8
error-feedback gradient compression (``repro.distributed``), and the
differentiable collectives the sharded islands call (port-only)."""
