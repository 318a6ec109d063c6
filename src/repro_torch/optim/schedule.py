"""LR schedules (the JAX package's ``optim/schedule.py``)."""
import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``: a 0-dim f32
    tensor (on ``step``'s device when ``step`` is a tensor), computed in
    f32 with the reference's operations in its order."""
    step = step.float() if isinstance(step, torch.Tensor) \
        else torch.tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
