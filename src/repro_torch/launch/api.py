"""ModelApi: one facade over the model zoo's implementations (counterpart of
``repro.launch.api``), for the decoder families the port has
(``repro_torch.models.decoder``: ``dense``, ``vlm``, ``moe`` and
``hybrid``), on one ``device``.

The reference's ``input_specs`` / ``shard_structs`` (abstract, sharded
inputs for its dry-run) wait for the launch modules (ROADMAP Queue A item
9 (c)), the audio ``encdec`` branch for its family (item 9 (a)); the
``ssm`` family raises in the decoder (item 9 (a)).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import decoder
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device = torch.device(DEFAULT_DEVICE)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.cfg.family == "audio":
            raise NotImplementedError(
                "the encdec (audio) family is not ported yet (ROADMAP Queue A "
                "item 9 (a))")

    # --- params ------------------------------------------------------------
    def init_params(self, key):
        return decoder.init_params(self.cfg, key, self.device)

    # --- steps ---------------------------------------------------------------
    def loss_fn(self, params, batch):
        return decoder.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch, cache_len=None):
        return decoder.prefill(self.cfg, params, batch["tokens"],
                               batch.get("img_embeds"), cache_len=cache_len)

    def decode_step(self, params, cache, token, pos):
        return decoder.decode_step(self.cfg, params, cache, token, pos)

    # --- cache ---------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=None):
        return decoder.init_cache(self.cfg, batch, cache_len, dtype, self.device)
