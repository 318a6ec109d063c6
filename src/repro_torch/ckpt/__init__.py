"""Checkpointing: pytree step checkpoints of training state, plus
epoch-tagged per-home BlockArray tile checkpoints for the serving layer
(the JAX package's ``repro.ckpt``; its elastic ``shardings=`` restore
waits for the training mesh hooks)."""
from .checkpoint import (latest_epoch, latest_step, restore_checkpoint,
                         restore_tiles, save_checkpoint, save_tiles)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_tiles", "restore_tiles", "latest_epoch"]
