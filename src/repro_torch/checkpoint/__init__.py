"""npz checkpoints of a model's parameters in the reference's layout
(counterpart of ``repro.checkpoint``)."""
from .ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
