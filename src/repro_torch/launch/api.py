"""ModelApi: one facade over the model zoo's implementations (counterpart of
``repro.launch.api``), the decoder-only families
(``repro_torch.models.decoder``) and the encoder-decoder ``audio`` family
(``repro_torch.models.encdec``), on one ``device``.

The reference's ``input_specs`` / ``shard_structs`` (abstract, sharded
inputs for its dry-run) wait for the launch modules (ROADMAP Queue A item
9 (c)).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import decoder, encdec
from repro_torch.models.config import ModelConfig


def model_module(cfg: ModelConfig):
    """The module implementing ``cfg``'s family: ``encdec`` for ``audio``,
    else ``decoder``."""
    return encdec if cfg.family == "audio" else decoder


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device = torch.device(DEFAULT_DEVICE)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def mod(self):
        return model_module(self.cfg)

    # --- params ------------------------------------------------------------
    def init_params(self, key):
        return self.mod.init_params(self.cfg, key, self.device)

    # --- steps ---------------------------------------------------------------
    def loss_fn(self, params, batch):
        return self.mod.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch, cache_len=None):
        if self.cfg.family == "audio":
            return encdec.prefill(self.cfg, params, batch["src_embeds"],
                                  batch["tokens"], cache_len=cache_len)
        return decoder.prefill(self.cfg, params, batch["tokens"],
                               batch.get("img_embeds"), cache_len=cache_len)

    def decode_step(self, params, cache, token, pos):
        return self.mod.decode_step(self.cfg, params, cache, token, pos)

    # --- cache ---------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=None, src_len: int = 1):
        """``src_len``: the encoder-decoder's source frames (ignored by the
        decoder families)."""
        if self.cfg.family == "audio":
            return encdec.init_cache(self.cfg, batch, cache_len, dtype,
                                     src_len=src_len, device=self.device)
        return decoder.init_cache(self.cfg, batch, cache_len, dtype, self.device)
