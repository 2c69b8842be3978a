"""repro_torch.ckpt — atomic, verified, async checkpoints (a port of
``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
