"""Learning-rate schedules (counterpart of ``repro.optim.schedules``). The
paper trains with Adam and "the cycle learning rate policy" (super-convergence,
Smith & Topin [22]) — ``one_cycle`` here.

Each schedule maps a step (an int or a tensor) to a float32 0-d tensor, on
the step's device, in the reference's arithmetic: the Python-float constants
fold in double precision as there, and everything that touches the step is
float32.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        step = _step(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return f


def one_cycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div: float = 1e4):
    """Smith & Topin's 1cycle: linear ramp to max_lr, cosine anneal down."""
    up = max(int(total_steps * pct_start), 1)
    lr0 = max_lr / div_factor
    lr_end = max_lr / final_div

    def f(step):
        step = _step(step)
        ramp = lr0 + (max_lr - lr0) * step / up
        t = torch.clamp((step - up) / max(total_steps - up, 1), 0.0, 1.0)
        down = lr_end + (max_lr - lr_end) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < up, ramp, down)

    return f
