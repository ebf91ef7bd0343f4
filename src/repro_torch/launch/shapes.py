"""The assigned input shapes, and which (arch, shape) pairs run and with
what config (counterpart of ``repro.launch.shapes``, the same tables).

  train_4k       seq_len=4096    global_batch=256  (training)
  prefill_32k    seq_len=32768   global_batch=32   (inference-prefill)
  decode_32k     seq_len=32768   global_batch=128  (inference-decode)
  long_500k      seq_len=524288  global_batch=1    (long-context-decode)

A decode shape is one ``decode_step``: one token and a KV cache of
``seq_len``. long_500k:
  * hymba / xlstm: native (window + SSM / recurrent state);
  * deepseek-v2: full attention over the compressed MLA latent cache (576
    bytes a token and layer), context-parallel over ``data``;
  * the other dense / moe / vlm configs: a sliding-window variant (window
    :data:`LONG_WINDOW`);
  * seamless-m4t: skipped (its bidirectional encoder is quadratic).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

LONG_WINDOW = 8192  # the sliding window of the dense configs at long_500k


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, the reason if not)."""
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, ("enc-dec: 500k-target decode implies a proportionally "
                       "long bidirectional (quadratic) encoder; skipped per "
                       "DESIGN.md §6")
    return True, ""


def shape_variant(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The config a shape runs: the sliding-window variant for the
    full-attention configs at long_500k, else ``cfg``."""
    if shape.name == "long_500k" and cfg.attention_window is None:
        if cfg.mla is not None:
            return cfg  # MLA: full attention over the compressed latent cache
        if cfg.family in ("dense", "vlm", "moe"):
            return dataclasses.replace(cfg, attention_window=LONG_WINDOW)
    return cfg


def reduced_shape(shape: InputShape, seq_len: int = 64, batch: int = 4) -> InputShape:
    """A smoke-test-sized version of a shape."""
    return InputShape(shape.name + "-smoke", seq_len, batch, shape.kind)
