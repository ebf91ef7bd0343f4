"""Logical-axis -> mesh-axis sharding rules (counterpart of
``repro.sharding.rules``, the same tables and decisions).

Parameters carry *logical* axes ("embed", "heads", "mlp", "experts",
"vocab", ...). A :class:`ShardingRules` table maps each logical axis to a
mesh axis, a tuple of mesh axes, or None (replicated). A logical axis whose
size its mesh axes do not divide is dropped to replicated and recorded in
``dropped``: that is how qwen2-1.5b's 12 heads stay whole on a 16-way
``model`` axis. The rules read only ``mesh.shape`` (an ordered axis ->
size mapping), as the reference's do, so they run on the port's abstract
meshes (``launch.mesh.make_production_mesh``) with no device behind them.

A spec is a plain tuple per leaf, one entry per leading dimension: a mesh
axis name, a tuple of two or more names, or None, with trailing Nones
trimmed. It equals ``tuple()`` of the reference's ``PartitionSpec``, entry
for entry (which writes a one-name tuple as the name).
:func:`shard_shape` is the per-device shape it gives.

The reference's ``NamedSharding`` (``logical_to_sharding`` there) has no
PyTorch class; its counterpart is a DTensor placement over a
``DeviceMesh``. :func:`logical_to_sharding` pairs each spec with its shard
shape, and :func:`spec_to_placements` turns a spec into one ``Shard(d)`` or
``Replicate()`` per mesh dimension, which ``launch.api`` lays out over a
``launch.mesh.device_mesh`` (a fake group for accounting, or the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.common import pytree_utils as pt

# Default rule tables. The batch axis shards over every data-like mesh axis
# (("pod", "data") on two pods, ("data",) on one): see make_rules.

TRAIN_RULES = {
    # weight axes
    "embed": "data",      # FSDP: shard the contracting dim over the data axis
    "embed_tbl": "data",  # the token embedding's feature dim
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "head_dim": None,
    "layers": None,       # the stacked layer axis is never sharded
    "ssm_state": None,
    "conv": None,
    "lora": None,
    # activation axes
    "batch": "data",
    "seq": None,
    "act_embed": None,
}

SERVE_RULES = {
    "embed": None,        # no FSDP when serving: weights live on the model axis
    "embed_tbl": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "head_dim": None,
    "layers": None,
    "ssm_state": None,
    "conv": None,
    "lora": None,
    "batch": "data",
    "seq": None,
    "act_embed": None,
}

FL_RULES = {
    # the federated layout: the client axis (rows of the (K, D) client
    # states, per-client keys and data) shards over the 1-D "clients" mesh
    # (launch.mesh.make_client_mesh); the flat parameter axis and the
    # server's state stay replicated
    "clients": "clients",
    "params": None,
}


@dataclasses.dataclass
class ShardingRules:
    table: dict
    mesh: object
    # (logical axis, dim size, mesh size) requested sharded but dropped
    dropped: set = dataclasses.field(default_factory=set)

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.table.get(logical)

    def axis_size(self, mesh_axis) -> int:
        if mesh_axis is None:
            return 1
        if isinstance(mesh_axis, tuple):
            return math.prod(self.mesh.shape[a] for a in mesh_axis)
        return self.mesh.shape[mesh_axis]


def make_rules(mesh, mode: str = "train", overrides: dict | None = None) -> ShardingRules:
    """The rule table of ``mode`` ("train", "serve" or "fl") on ``mesh``:
    the batch over every data-like axis the mesh has, rules that name a
    missing ``model`` axis (or, for "fl", a missing client axis)
    replicated, then ``overrides``."""
    if mode == "fl":
        base = dict(FL_RULES)
        for k, v in list(base.items()):
            if v is not None and v not in mesh.shape:
                base[k] = None
        if overrides:
            base.update(overrides)
        return ShardingRules(table=base, mesh=mesh)
    base = dict(TRAIN_RULES if mode == "train" else SERVE_RULES)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    base["batch"] = data_axes if data_axes else None
    if mode == "train":
        base["embed"] = "data" if "data" in mesh.shape else None
    if "model" not in mesh.shape:
        for k, v in list(base.items()):
            if v == "model":
                base[k] = None
    if overrides:
        base.update(overrides)
    return ShardingRules(table=base, mesh=mesh)


def _spec_for_axes(axes: tuple, rules: ShardingRules, dim_sizes=None) -> tuple:
    """One leaf's spec: a mesh axis appears at most once, and a dimension
    its mesh axes do not divide stays replicated (recorded in
    ``rules.dropped``)."""
    used = set()
    parts = []
    for i, logical in enumerate(axes):
        mesh_ax = rules.mesh_axes(logical)
        if mesh_ax is None:
            parts.append(None)
            continue
        flat = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if any(a in used for a in flat):
            parts.append(None)
            continue
        size = rules.axis_size(mesh_ax)
        if dim_sizes is not None and dim_sizes[i] % size != 0:
            rules.dropped.add((logical, dim_sizes[i], size))
            parts.append(None)
            continue
        used.update(flat)
        parts.append(flat[0] if len(flat) == 1 else flat)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of mesh-axis names, tuples of names,
    or None."""
    return isinstance(x, tuple) and all(
        p is None or isinstance(p, str)
        or (isinstance(p, tuple) and all(isinstance(a, str) for a in p))
        for p in x)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def logical_to_spec(axes_tree, rules: ShardingRules, shapes_tree=None):
    """Tree of logical-axis tuples -> tree of specs. ``shapes_tree`` (the
    same structure: shape tuples, or tensors) enables the divisibility
    drop."""
    if shapes_tree is None:
        return pt.tree_map(lambda ax: _spec_for_axes(ax, rules), axes_tree,
                           is_leaf=is_axes)
    return pt.tree_map(lambda ax, shp: _spec_for_axes(ax, rules, _shape_of(shp)),
                       axes_tree, shapes_tree, is_leaf=is_axes)


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The per-device shape of a ``shape`` array laid out by ``spec`` on
    ``mesh``: each sharded dimension divided by its mesh axes' sizes (the
    rules only shard dimensions those sizes divide)."""
    out = list(shape)
    for i, part in enumerate(spec):
        if part is None:
            continue
        names = part if isinstance(part, tuple) else (part,)
        size = math.prod(mesh.shape[a] for a in names)
        if out[i] % size:
            raise ValueError(f"dim {i} of {tuple(shape)} is not divisible by "
                             f"{part} ({size})")
        out[i] //= size
    return tuple(out)


def logical_to_sharding(axes_tree, rules: ShardingRules, shapes_tree):
    """Tree of ``(spec, shard shape)`` pairs: :func:`logical_to_spec` and
    :func:`shard_shape` on ``rules.mesh`` (the reference's
    ``NamedSharding`` tree, recorded rather than applied)."""
    specs = logical_to_spec(axes_tree, rules, shapes_tree)
    return pt.tree_map(
        lambda spec, shp: (spec, shard_shape(_shape_of(shp), spec, rules.mesh)),
        specs, shapes_tree, is_leaf=is_spec)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``
    with axis names, or anything with ``.shape`` / ``.mesh_dim_names``):
    one per mesh dimension, ``Shard(d)`` for the tensor dimension ``d``
    whose entry names that axis, else ``Replicate()``.

    A dimension sharded over a tuple of axes (the batch over ``("pod",
    "data")``) gets ``Shard(d)`` on each; DTensor splits it over those mesh
    dimensions in mesh order, which is the reference's layout only when the
    tuple follows the mesh's axis order, so any other order raises. An
    axis of size 1 splits nothing and stays ``Replicate()`` (DTensor would
    otherwise refuse views of a dimension it takes for split, on the
    one-card ``(1, 1)`` mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec}: mesh axes {unknown} not in {names}")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dimension {d} is sharded over "
                             f"{axes}, not in the mesh's axis order {names}")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dimensions")
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)
