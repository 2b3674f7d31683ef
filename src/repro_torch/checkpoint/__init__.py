"""Checkpoints of the port (``repro.checkpoint``), single process."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
