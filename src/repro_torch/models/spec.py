"""Parameter specification: one source of truth for shapes, logical axes and
initializers (counterpart of ``repro.models.spec``).

A model builds a *spec tree* (nested dicts of :class:`ArraySpec`). From it:
  * :func:`init_params` — the materialized parameter tree of tensors;
  * :func:`abstract_params` — shape/dtype only (``meta`` tensors, nothing
    allocated), the template a checkpoint restores into and what the dry
    run (``launch.dryrun``) accounts;
  * :func:`axes_tree` — each leaf's logical axes, which
    ``sharding.rules`` maps to a mesh.

Initial values come from an explicit ``torch.Generator`` (:func:`init_params`)
and differ from JAX's for the same seed, or from a ``repro_torch.random``
key (:func:`init_params_from_key`, the FL engine's fresh init), which draws
what the reference's ``init_params(spec, key)`` draws: one key per leaf from
``split(key, n_leaves)``, a normal draw scaled per the spec (equal to the
reference's up to ``erfinv``'s last ulps). Parity tests that need equal
params bit for bit hand both packages the same numpy-made params
(``repro_torch.core.forecaster.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import random as R
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


def _scale(spec: ArraySpec) -> float:
    if spec.init == "normal":
        return 0.02
    if spec.init == "scaled":
        fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
        if len(spec.shape) >= 2:
            fan_in = int(np.prod(spec.shape[:-1]))
        return 1.0 / math.sqrt(max(fan_in, 1))
    raise ValueError(f"unknown init {spec.init}")


def _init_one(spec: ArraySpec, draw, device: torch.device) -> torch.Tensor:
    """One leaf: zeros, ones, or ``scale * draw(shape)`` for a standard
    normal ``draw``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    return (_scale(spec) * draw(spec.shape)).to(device=device, dtype=spec.dtype)


# Draws per counter range in :func:`normal_in_ranges`. ``repro_torch.random``
# holds several int64 tensors of the draw's size at once (counters, words,
# hash rounds): 2**24 draws keep that near 1 GB, where hymba-1.5b's largest
# leaf (mlp/w_up, 32 x 1600 x 5504 = 282 M draws) would need tens of GB.
DRAW_RANGE = 1 << 24


def normal_in_ranges(key, shape, range_size: int = DRAW_RANGE) -> torch.Tensor:
    """``R.normal(key, shape)``, drawn over counter ranges of at most
    ``range_size`` draws into one float32 output: the ranges concatenate to
    the whole draw bit for bit (every draw depends on its counter alone)."""
    n = math.prod(shape)
    if n <= range_size:
        return R.normal(key, shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, range_size):
        size = min(range_size, n - start)
        out[start:start + size] = R.normal(key, (size,), start)
    return out.reshape(shape)


def init_params(spec_tree, generator: torch.Generator, device) -> dict:
    """Materialize a parameter tree, drawing leaves in JAX's (sorted-key)
    leaf order from ``generator``. Draws happen on the generator's own
    device, so the same generator gives the same values on any target."""
    pairs = pt.flatten_with_paths(spec_tree, is_leaf=is_spec)
    draw = lambda shape: torch.randn(shape, generator=generator,  # noqa: E731
                                     device=generator.device)
    return pt.unflatten([(path, _init_one(s, draw, torch.device(device)))
                         for path, s in pairs])


def init_params_from_key(spec_tree, key, device) -> dict:
    """Materialize a parameter tree from a ``repro_torch.random`` key, the
    reference's way: leaf ``i`` (JAX's leaf order) draws
    ``scale * normal(split(key, n)[i], shape)``."""
    device = torch.device(device)
    pairs = pt.flatten_with_paths(spec_tree, is_leaf=is_spec)
    keys = R.split(key.to(device), max(len(pairs), 1))
    return pt.unflatten([
        (path, _init_one(s, lambda shape, k=k: normal_in_ranges(k, shape),
                         device))
        for (path, s), k in zip(pairs, keys)])


def axes_tree(spec_tree):
    """Tree of logical-axis tuples, in the structure of the params tree."""
    return pt.tree_map(lambda s: s.axes, spec_tree, is_leaf=is_spec)


def abstract_params(spec_tree):
    """Tree of ``meta`` tensors: shapes and dtypes, no storage."""
    return pt.tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree, is_leaf=is_spec)


def stack_layers(spec_tree, num_layers: int):
    """Prepend a ``layers`` axis to every spec in the tree: per-layer params
    carry a leading ``num_layers`` dimension, as in the reference (which
    scans over it; the port loops)."""
    return pt.tree_map(
        lambda s: ArraySpec(shape=(num_layers,) + tuple(s.shape),
                            axes=("layers",) + tuple(s.axes), init=s.init,
                            dtype=s.dtype),
        spec_tree, is_leaf=is_spec)


def spec_num_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape))
               for s in pt.leaves(spec_tree, is_leaf=is_spec))
