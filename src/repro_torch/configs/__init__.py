"""Config registry (counterpart of ``repro.configs``): ``get_config(arch_id)``
for every assigned architecture.

Ported so far: ``hymba-1.5b`` (the ``hybrid`` family) and ``qwen2-1.5b``
(the ``dense`` family), served by ``repro_torch.launch.serve`` and trained by
``repro_torch.launch.train``. A known arch whose config and blocks are not
ported yet raises ``NotImplementedError``; an unknown one ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek-v2-236b",
    "internvl2-2b",
    "qwen2-1.5b",
    "phi3.5-moe-42b-a6.6b",
    "mistral-large-123b",
    "hymba-1.5b",
    "command-r-plus-104b",
    "xlstm-125m",
    "seamless-m4t-large-v2",
    "qwen2-72b",
]

# config modules of the ported archs (the reference has one per arch)
_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-1.5b": "qwen2_1_5b",
}


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet (ROADMAP Queue A item 9 (a): "
            f"the model zoo's other families); ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
