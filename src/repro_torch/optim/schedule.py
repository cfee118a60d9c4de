"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio * peak_lr``: a function
    of the step (a tensor or an int) giving an f32 tensor on the step's
    device, in the reference's order of f32 operations.

    The cosine is taken in f64 and rounded to f32, i.e. correctly rounded
    (the JAX package's f32 cosine is; torch's is 1 ulp off at some steps,
    which the decay amplifies where ``1 + cos`` nears 0)."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos_t = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + cos_t))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
