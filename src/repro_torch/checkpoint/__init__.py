"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager, latest_step  # noqa: F401
