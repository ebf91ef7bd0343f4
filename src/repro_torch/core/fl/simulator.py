"""DEPRECATED shim (counterpart of ``repro.core.fl.simulator``): the FL round
driver lives in :mod:`repro_torch.core.fl.engine`.

Keeps the legacy public names ``run_fl`` and ``evaluate_rmse`` as
re-exports; new code imports from ``repro_torch.core.fl.engine``. Both take
either data layout (materialized windows or, with
``FLConfig.streaming_windows``, the raw ``(K, T)`` slices), and ``run_fl``
every driver (``loop``, ``scan``, ``while``, ``host``).
"""
from __future__ import annotations

from repro_torch.core.fl.engine import evaluate_rmse, run_fl  # noqa: F401
