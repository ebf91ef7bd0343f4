"""Config registry (counterpart of ``repro.configs``): ``get_config(arch_id)``
for every assigned architecture.

Ported: the ``dense`` (qwen2-1.5b, qwen2-72b, mistral-large-123b,
command-r-plus-104b), ``hybrid`` (hymba-1.5b), ``moe`` (phi3.5-moe-42b-a6.6b,
deepseek-v2-236b with MLA) and ``vlm`` (internvl2-2b) families, served by
``repro_torch.launch.serve`` and trained by ``repro_torch.launch.train``.
``xlstm-125m`` (the ``ssm`` family) and ``seamless-m4t-large-v2`` (``audio``,
the encoder-decoder) are not ported yet and raise ``NotImplementedError``;
an unknown arch raises ``KeyError``.
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
    "deepseek-v2-236b": "deepseek_v2_236b",
    "internvl2-2b": "internvl2_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mistral-large-123b": "mistral_large_123b",
    "hymba-1.5b": "hymba_1_5b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-72b": "qwen2_72b",
}


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet (ROADMAP Queue A item 9 (a): "
            f"the ssm and encdec families); ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
