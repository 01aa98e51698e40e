"""Checkpoints and straggler detection (``repro.distributed``), on one
device; the sharding rules and gradient compression wait for the mesh."""
