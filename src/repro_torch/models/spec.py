"""Parameter specification: one source of truth for shapes, logical axes and
initializers (counterpart of ``repro.models.spec``).

A model builds a *spec tree* (nested dicts of :class:`ArraySpec`). From it:
  * :func:`init_params` — the materialized parameter tree of tensors;
  * :func:`abstract_params` — shape/dtype only (``meta`` tensors, nothing
    allocated), the template a checkpoint restores into.

Initial values come from an explicit ``torch.Generator`` and differ from
JAX's threefry draws for the same seed; parity tests hand both packages the
same numpy-made params instead (``repro_torch.core.forecaster.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.common import pytree_utils as pt


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: tuple
    axes: tuple  # logical axis names; len(axes) == len(shape); None entries ok
    init: str = "normal"  # normal | zeros | ones | scaled  (scaled = 1/sqrt(fan_in))
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ArraySpec)


def _init_one(spec: ArraySpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        scale = 0.02
    elif spec.init == "scaled":
        fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
        if len(spec.shape) >= 2:
            fan_in = int(np.prod(spec.shape[:-1]))
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init}")
    # draw on the generator's own device, then place: the same generator
    # gives the same values whatever the target device
    draw = torch.randn(spec.shape, generator=generator, device=generator.device)
    return (scale * draw).to(device=device, dtype=spec.dtype)


def init_params(spec_tree, generator: torch.Generator, device) -> dict:
    """Materialize a parameter tree, drawing leaves in JAX's (sorted-key)
    leaf order from ``generator``."""
    pairs = pt.flatten_with_paths(spec_tree, is_leaf=is_spec)
    return pt.unflatten([(path, _init_one(s, generator, torch.device(device)))
                         for path, s in pairs])


def abstract_params(spec_tree):
    """Tree of ``meta`` tensors: shapes and dtypes, no storage."""
    return pt.tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree, is_leaf=is_spec)


def spec_num_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape))
               for s in pt.leaves(spec_tree, is_leaf=is_spec))
