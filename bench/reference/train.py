"""Plain centralized training of one forecaster: the yardstick for the
program's Table I training step.

Adam as the configuration states it: the gradient clipped to a global norm
of ``grad_clip`` (``min(1, clip / max(norm, 1e-9))``), bias-corrected
moments, and the learning rate of Smith and Topin's one-cycle schedule
(a linear ramp from ``max_lr / 25`` over the first ``pct_start`` of the
cycle, then a cosine down to ``max_lr / 1e4``), taken at the step count
after the increment. Nothing of the program is used.
"""
from __future__ import annotations

import math

import torch

from bench.reference import model as RM


def one_cycle(step: int, max_lr: float, total: int, pct_start: float = 0.3,
              div: float = 25.0, final_div: float = 1e4) -> float:
    up = max(int(total * pct_start), 1)
    lr0, lr_end = max_lr / div, max_lr / final_div
    if step < up:
        return lr0 + (max_lr - lr0) * step / up
    t = min(max((step - up) / max(total - up, 1), 0.0), 1.0)
    return lr_end + (max_lr - lr_end) * 0.5 * (1 + math.cos(math.pi * t))


def train_steps(model: dict, opt: dict, init_vec, batches, precision="fp32",
                faults=()):
    """Adam steps from ``init_vec`` ``(D,)``, one per ``(x, y)`` of
    ``batches`` (``x`` ``(B, L)``, ``y`` ``(B, T)``). Returns ``{"loss":
    [per step], "grad1": the clipped gradient of step 1 (D,), "params": the
    vector after the last step (D,)}``."""
    w = init_vec.to(torch.float32).clone()[None]
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad1 = [], None
    for step, (x, y) in enumerate(batches, start=1):
        if "half_batch" in faults:
            x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        g, loss = RM.client_grads(model, w, x[None], y[None], precision)
        norm = float(torch.sqrt((g.double() ** 2).sum()))
        g = g * min(1.0, opt["grad_clip"] / max(norm, 1e-9))
        if grad1 is None:
            grad1 = g[0].clone()
        lr = one_cycle(step, opt["max_lr"], opt["cycle_steps"])
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        if "state_unchanged" not in faults:
            w = w - lr * (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps)
        losses.append(float(loss[0]))
    return {"loss": losses, "grad1": grad1, "params": w[0]}
