"""Optimizer substrate: AdamW + schedules + gradient transforms (the JAX
package's ``optim``)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
from .compress import compress_int8, decompress_int8, ErrorFeedbackState

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "compress_int8", "decompress_int8",
           "ErrorFeedbackState"]
