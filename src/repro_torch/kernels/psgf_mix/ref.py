"""Plain PyTorch version of the psgf_mix kernels: the paper's masked mix
(eqs. 4/6) plus the comm count, as ``repro/kernels/psgf_mix/ref.py`` writes
them. ``m * g``, ``1 - m``, ``(1 - m) * w`` and their sum are each rounded
once (separate torch ops), which is what the CUDA kernel reproduces bit for
bit. The wrapper (``ops``) runs these for CPU tensors; ``chip_smoke.py``
holds the kernel against them on the card.
"""
from __future__ import annotations

import torch


def psgf_mix_ref(w_global, w_local, mask):
    """1-D inputs (D,). Returns (mixed (D,), count 0-d float32)."""
    m = mask.to(w_global.dtype)
    mixed = m * w_global + (1.0 - m) * w_local
    return mixed, torch.sum(m, dtype=torch.float32)


def psgf_mix_batch_ref(w_global, w_clients, mask):
    """w_global (D,); w_clients/mask (K, D). Returns (mixed (K, D), count)."""
    m = mask.to(w_clients.dtype)
    mixed = m * w_global[None, :] + (1.0 - m) * w_clients
    return mixed, torch.sum(m, dtype=torch.float32)
