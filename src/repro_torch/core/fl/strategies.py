"""DEPRECATED shim (counterpart of ``repro.core.fl.strategies``): the FL
policies live in :mod:`repro_torch.core.fl.policies` and the shared
gate/aggregate/distribute core, ``FLConfig``, state init and the round in
:mod:`repro_torch.core.fl.engine`.

Keeps the legacy names (``FLConfig``, ``fl_round``, ``init_fl_state``,
``_local_update``, ``_topk_mask``) so old imports keep working; new code
imports from ``repro_torch.core.fl.engine``.
"""
from __future__ import annotations

from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.core.fl import engine as _engine
from repro_torch.core.fl.engine import (  # noqa: F401  (re-exported legacy API)
    ACCOUNTING_DTYPE,
    FLConfig,
    _local_update,
    init_fl_state,
)
from repro_torch.core.fl.masks import topk_mask as _topk_mask  # noqa: F401 (legacy name)


def fl_round(state, data, key, model_cfg, fl_cfg: FLConfig, meta,
             device=DEFAULT_DEVICE):
    """DEPRECATED: use :func:`repro_torch.core.fl.engine.fl_round`, which
    this calls with the element policy named by ``fl_cfg.policy``."""
    return _engine.fl_round(state, data, key, model_cfg, fl_cfg, meta,
                            device=device)
