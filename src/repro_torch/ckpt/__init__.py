"""Checkpointing: epoch-tagged per-home ``BlockArray`` tile checkpoints for
the serving layer (the JAX package's ``repro.ckpt`` tile functions; its
pytree checkpoints belong to training and come with the LLM slice)."""
from .checkpoint import latest_epoch, restore_tiles, save_tiles

__all__ = ["save_tiles", "restore_tiles", "latest_epoch"]
