"""Fault tolerance for the port: checkpointing + deterministic fault
injection (the reference's ``repro.ft``).

``CheckpointManager`` persists the learned synopses in the reference's
format (atomic commits, per-shard checksums, fallback to the newest intact
step); ``faults`` is the seeded fault-injection registry (a copy of the
reference's) whose named points the degraded-mode serving path is tested
against.
"""
from repro_torch.ft import faults
from repro_torch.ft.checkpoint import CheckpointManager

__all__ = ["CheckpointManager", "faults"]
