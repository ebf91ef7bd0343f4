"""The one rule for picking a device.

Every entry point of the port (``load_forecaster``, ``Forecaster.init_params``,
the ``ForecastServer`` constructors, the serving CLI) takes a ``device``
argument that defaults to ``"cuda"`` and resolves it here. Without a GPU that
default RAISES: the port never falls back to the CPU on its own. Callers that
mean the CPU (the tests, a laptop) say so with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or ``torch.device``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no GPU is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def normalized(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:{current device}``; other devices as they are."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
