"""Config registry (counterpart of ``repro.configs``): ``get_config(arch_id)``
for every assigned architecture.

All ten are ported: the ``dense`` (qwen2-1.5b, qwen2-72b,
mistral-large-123b, command-r-plus-104b), ``hybrid`` (hymba-1.5b), ``moe``
(phi3.5-moe-42b-a6.6b, deepseek-v2-236b with MLA), ``vlm`` (internvl2-2b),
``ssm`` (xlstm-125m) and ``audio`` (seamless-m4t-large-v2, the
encoder-decoder) families, served by ``repro_torch.launch.serve`` and
trained by ``repro_torch.launch.train``. An unknown arch raises
``KeyError``.
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

# one config module per arch, as in the reference
_MODULES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "internvl2-2b": "internvl2_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mistral-large-123b": "mistral_large_123b",
    "hymba-1.5b": "hymba_1_5b",
    "command-r-plus-104b": "command_r_plus_104b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-72b": "qwen2_72b",
}


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
