"""ModelApi: one facade over the model zoo's implementations (counterpart of
``repro.launch.api``), the decoder-only families
(``repro_torch.models.decoder``) and the encoder-decoder ``audio`` family
(``repro_torch.models.encdec``), on one ``device``; and the abstract,
sharded inputs of each (config, shape) for the dry run.

Where the reference builds ``jax.ShapeDtypeStruct``s, the port builds
``meta`` tensors (shape and dtype, no storage), and a sharded input is a
:class:`ShardedStruct`: the meta tensor with its spec and per-device shape
from ``sharding.rules``. :func:`distribute_structs` lays a tree of them out
as DTensors over a ``DeviceMesh`` (``launch.mesh.device_mesh``): meta
shards for accounting, or real values on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.shapes import InputShape
from repro_torch.models import decoder, encdec
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import (ShardingRules, logical_to_sharding,
                                        spec_to_placements)


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

    def param_axes(self):
        return self.mod.param_axes(self.cfg)

    def abstract_params(self, dtype=None):
        """The params as ``meta`` tensors; float leaves in ``dtype`` if
        given (bf16 weights when serving)."""
        ap = self.mod.abstract_params(self.cfg)
        return ap if dtype is None else cast_float_structs(ap, dtype)

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

    def abstract_cache(self, batch: int, cache_len: int, dtype=None, src_len: int = 1):
        """:meth:`init_cache`'s tree as ``meta`` tensors."""
        if self.cfg.family == "audio":
            return encdec.abstract_cache(self.cfg, batch, cache_len, dtype, src_len)
        return decoder.abstract_cache(self.cfg, batch, cache_len, dtype)

    def cache_axes(self, context_parallel: bool = False):
        return self.mod.cache_axes(self.cfg, context_parallel)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cast_float_structs(tree, dtype):
    """Float leaves of a tree of meta tensors recast to ``dtype``."""
    return pt.tree_map(lambda x: _meta(x.shape, dtype) if x.is_floating_point()
                       else x, tree)


@dataclasses.dataclass(frozen=True)
class ShardedStruct:
    """An abstract input: a ``meta`` tensor, its spec (one mesh-axis entry
    per leading dimension, as ``sharding.rules`` gives it) and the shape
    each device holds (the reference's ShapeDtypeStruct with a
    NamedSharding)."""

    value: torch.Tensor
    spec: tuple
    shard_shape: tuple

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def shard_nbytes(self) -> int:
        return math.prod(self.shard_shape) * self.value.element_size()

    def placements(self, device_mesh) -> tuple:
        """The spec as DTensor placements on ``device_mesh``."""
        return spec_to_placements(self.spec, device_mesh)

    def to_dtensor(self, device_mesh, value: Optional[torch.Tensor] = None):
        """A DTensor over ``device_mesh`` laid out by the spec: without
        ``value``, a meta shard of :attr:`shard_shape` on this rank (no
        storage, no data moved); with ``value`` (the whole tensor, on the
        mesh's device), ``distribute_tensor`` of it."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        placements = self.placements(device_mesh)
        if value is not None:
            if tuple(value.shape) != tuple(self.shape):
                raise ValueError(f"value {tuple(value.shape)} is not the "
                                 f"struct's {tuple(self.shape)}")
            return distribute_tensor(value, device_mesh, placements)
        local = torch.empty(self.shard_shape, dtype=self.dtype, device="meta")
        return DTensor.from_local(local, device_mesh, placements,
                                  run_check=False, shape=self.value.shape,
                                  stride=self.value.stride())


# ---------------------------------------------------------------------------
# Abstract inputs per (cfg, shape)
# ---------------------------------------------------------------------------


def batch_axes(cfg: ModelConfig, shape: InputShape, kind: str):
    """Logical-axis trees of the input batch (mirrors :func:`input_structs`)."""
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    if cfg.family == "audio":
        ax = {"src_embeds": ("batch", None, None), "tokens": ("batch", None)}
    elif cfg.family == "vlm":
        ax = {"img_embeds": ("batch", None, None), "tokens": ("batch", None)}
    else:
        ax = {"tokens": ("batch", None)}
    if kind == "train":
        ax["labels"] = ("batch", None)
    return ax


def input_shape(cfg: ModelConfig, kind: str, batch: int, text_len: int) -> InputShape:
    """The ``kind`` (``"train"`` / ``"prefill"``) shape whose
    :func:`input_structs` hold a batch of ``text_len`` tokens a row, as
    ``launch.train`` and ``launch.serve`` build it: a ``vlm`` sequence holds
    the patches too, an ``audio`` one the source frames and the tokens in
    halves."""
    seq = text_len
    if cfg.family == "vlm":
        seq += cfg.vlm.num_patches
    elif cfg.family == "audio":
        seq *= 2
    return InputShape(kind, seq, batch, kind)


def input_structs(cfg: ModelConfig, shape: InputShape):
    """Meta tensors (unsharded) of the step inputs of ``shape.kind``: the
    batch for train / prefill (an ``audio`` model's sequence split between
    source frames and target tokens, a ``vlm`` model's between patches and
    tokens), ``{cache, token, pos}`` for decode."""
    B, S = shape.global_batch, shape.seq_len
    i32, act = torch.int32, cfg.activation_dtype
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            half = S // 2
            batch = {"src_embeds": _meta((B, half, cfg.d_model), act),
                     "tokens": _meta((B, half), i32)}
            text = half
        elif cfg.family == "vlm":
            P = cfg.vlm.num_patches
            batch = {"img_embeds": _meta((B, P, cfg.d_model), act),
                     "tokens": _meta((B, S - P), i32)}
            text = S - P
        else:
            batch = {"tokens": _meta((B, S), i32)}
            text = S
        if shape.kind == "train":
            batch["labels"] = _meta((B, text), i32)
        return batch
    if shape.kind == "decode":
        src_len = S // 2 if cfg.family == "audio" else 1
        cache = ModelApi(cfg, "meta").abstract_cache(B, S, src_len=src_len)
        return {"cache": cache, "token": _meta((B, 1), i32), "pos": _meta((), i32)}
    raise ValueError(shape.kind)


def with_shardings(structs, shardings):
    """Each meta tensor of ``structs`` as a :class:`ShardedStruct` with its
    ``(spec, shard shape)`` from the matching leaf of ``shardings``."""
    return pt.tree_map(lambda s, sh: ShardedStruct(s, *sh), structs, shardings)


def distribute_structs(tree, device_mesh, values=None):
    """Each :class:`ShardedStruct` of ``tree`` as a DTensor over
    ``device_mesh`` (:meth:`ShardedStruct.to_dtensor`): meta shards, or with
    ``values`` (a tree of whole tensors of the same structure) those values
    laid out by the specs. Leaves that are not ``ShardedStruct``s (a decode
    step's ``pos``) pass through."""
    def one(s, v=None):
        return s.to_dtensor(device_mesh, v) if isinstance(s, ShardedStruct) else s

    if values is None:
        return pt.tree_map(one, tree, is_leaf=_is_struct)
    # the values' structure leads: a params tree drops empty subtrees
    return pt.tree_map(lambda v, s: one(s, v), values, tree)


def _is_struct(x) -> bool:
    return isinstance(x, ShardedStruct)


def shard_structs(structs, axes_tree, rules: ShardingRules):
    """Each meta tensor of ``structs`` as a :class:`ShardedStruct` with the
    spec and shard shape its logical axes give on ``rules.mesh``."""
    return with_shardings(structs, logical_to_sharding(axes_tree, rules, structs))


def input_specs(cfg: ModelConfig, shape: InputShape,
                rules: Optional[ShardingRules] = None):
    """Sharded abstract inputs for the dry run (the meta tensors alone
    without ``rules``). Decode gives ``{cache, token, pos}``; when the batch
    does not divide over the batch rule's mesh axes (batch 1 at long_500k)
    the cache's sequence shards over them instead (context parallelism)
    and the token is replicated, as the reference decides
    (``api.py:153-170`` there)."""
    structs = input_structs(cfg, shape)
    if rules is None:
        return structs
    if shape.kind in ("train", "prefill"):
        return shard_structs(structs, batch_axes(cfg, shape, shape.kind), rules)
    data_par = rules.axis_size(rules.table.get("batch"))
    context_parallel = shape.global_batch % max(data_par, 1) != 0
    cache_ax = ModelApi(cfg, "meta").cache_axes(context_parallel=context_parallel)
    tok_ax = (None, None) if context_parallel else ("batch", None)
    return {"cache": shard_structs(structs["cache"], cache_ax, rules),
            "token": shard_structs(structs["token"], tok_ax, rules),
            "pos": ShardedStruct(structs["pos"], (), ())}
