"""Forecaster: one facade + name registry over the forecasting models
(counterpart of ``repro.core.forecaster``).

    fc = get_forecaster("logtst", look_back=64, horizon=2)
    params = fc.init_params(torch.Generator().manual_seed(0))   # on the card
    pred = fc.forward(params, x)                                 # (B, L) -> (B, T)

Checkpoint interop (the FL -> serving hand-off): :func:`save_forecaster`
writes params + the full config in the reference's checkpoint format and
:func:`load_forecaster` restores ``(Forecaster, params, extra)`` from the
manifest alone, so either package restores the other's checkpoints.

Weight carry-over: :func:`params_from_numpy` / :func:`params_to_numpy` move a
params tree between tensors and numpy arrays keyed like the JAX pytree — how
parity tests hand the reference's params to the port and back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.checkpoint.checkpoint import (load_checkpoint, quantize_tree,
                                               read_manifest, save_checkpoint,
                                               tensor_from_numpy,
                                               tensor_to_numpy)
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core import forecast
from repro_torch.models import spec as S


@dataclasses.dataclass(frozen=True)
class Forecaster:
    """Facade over ``ForecastConfig``; every method delegates to
    :mod:`repro_torch.core.forecast`."""

    cfg: forecast.ForecastConfig

    @property
    def name(self) -> str:
        return self.cfg.name

    def init_params(self, generator: torch.Generator, device=DEFAULT_DEVICE):
        return forecast.init_params(self.cfg, generator, device)

    def abstract_params(self):
        return S.abstract_params(forecast.model_spec(self.cfg))

    def num_params(self) -> int:
        return forecast.num_params(self.cfg)

    def forward(self, params, x):
        """x: (B, L) -> (B, T)."""
        return forecast.forward(self.cfg, params, x)

    def forward_multivariate(self, params, x):
        """x: (B, M, L) -> (B, M, T); channel-independent shared weights."""
        return forecast.forward_multivariate(self.cfg, params, x)

    def loss_fn(self, params, x, y):
        return forecast.mse_loss(self.cfg, params, x, y)


_REGISTRY: Dict[str, Callable[..., forecast.ForecastConfig]] = {
    "logtst": forecast.logtst_config,
    "patchtst": forecast.patchtst_config,
    "mlpformer": forecast.mlpformer_config,
    "idformer": forecast.idformer_config,
}


def register_forecaster(name: str, config_fn: Callable[..., forecast.ForecastConfig]):
    """Add an architecture to the registry (e.g. a custom mixer stack)."""
    _REGISTRY[name] = config_fn


def forecaster_names():
    return sorted(_REGISTRY)


def get_forecaster(name, **overrides) -> Forecaster:
    """Resolve a Forecaster by registry name, derived ``cfg.name`` (the
    ``"logtst/15"`` spelling; the ``/N`` suffix is ignored), or an existing
    ``ForecastConfig``."""
    if isinstance(name, forecast.ForecastConfig):
        cfg = dataclasses.replace(name, **overrides) if overrides else name
        return Forecaster(cfg)
    base = str(name).split("/")[0]
    if base not in _REGISTRY:
        raise KeyError(
            f"unknown forecaster {name!r}; known: {forecaster_names()}")
    if "mixers" in overrides:
        overrides = dict(overrides)
        mixers = overrides.pop("mixers")
        return Forecaster(dataclasses.replace(_REGISTRY[base](**overrides),
                                              mixers=tuple(mixers)))
    return Forecaster(_REGISTRY[base](**overrides))


# ---------------------------------------------------------------------------
# weight carry-over and checkpoint interop
# ---------------------------------------------------------------------------


def params_from_numpy(tree, device=DEFAULT_DEVICE):
    """Tree of numpy arrays (e.g. a JAX params pytree mapped through
    ``np.asarray``) -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return pt.tree_map(lambda a: tensor_from_numpy(a).to(dev), tree)


def params_to_numpy(params):
    """Tree of tensors -> the same tree of host numpy arrays (bfloat16
    leaves as 2-byte void records, see ``checkpoint.tensor_to_numpy``)."""
    return pt.tree_map(tensor_to_numpy, params)


def save_forecaster(ckpt_dir: str, forecaster: Forecaster, params, step: int = 0,
                    extra: dict | None = None) -> str:
    """Write params + the full ForecastConfig into a checkpoint step dir."""
    meta = dict(extra or {})
    meta["forecast_config"] = dataclasses.asdict(forecaster.cfg)
    return save_checkpoint(ckpt_dir, step, {"params": params}, extra=meta)


def load_forecaster(ckpt_dir: str, step: int | None = None,
                    comm_bits: int = 32, device=DEFAULT_DEVICE):
    """Restore ``(Forecaster, params, extra)`` from a checkpoint written by
    either package's ``save_forecaster``, with params on ``device`` (the
    card by default; raises without one unless ``device="cpu"``).

    ``comm_bits=16`` / ``8`` quantize the restored params through the bf16 /
    int8 + per-leaf-scale wire round-trip (``checkpoint.quantize_tree``).
    Configs saved before ``use_flash_attn`` existed restore with it off (the
    dataclass default)."""
    dev = resolve_device(device)
    step, manifest = read_manifest(ckpt_dir, step)
    cfg_dict = dict(manifest["extra"]["forecast_config"])
    cfg_dict["mixers"] = tuple(cfg_dict["mixers"])  # json round-trips as list
    fc = Forecaster(forecast.ForecastConfig(**cfg_dict))
    tree, extra = load_checkpoint(ckpt_dir, {"params": fc.abstract_params()},
                                  step=step, device=dev)
    return fc, quantize_tree(tree["params"], comm_bits,
                             where=f"load_forecaster(comm_bits={comm_bits})"), \
        extra
