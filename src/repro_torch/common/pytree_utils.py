"""Nested-dict parameter trees, flattened the way JAX flattens them.

Counterpart of ``repro.common.pytree_utils`` (and of
``repro.checkpoint.checkpoint._path_str``) for the port's trees: nested
``dict``s (lists and tuples are allowed too) whose leaves are tensors or
arrays. JAX flattens a dict in SORTED key order, so :func:`flatten_with_paths`
does too; the ``a/b/c`` path strings are the checkpoint keys both packages
write. :func:`tree_flatten_to_vector` is the FL engine's flat ``(D,)``
parameter vector, concatenated in that same leaf order: the engine's masks
index it element by element, so both packages must lay it out alike.
:func:`value_and_grad` is ``jax.value_and_grad(has_aux=True)`` for such a
tree, as the trainers use it.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree, is_leaf: Callable[[Any], bool] | None = None
                       ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's leaf order: dict keys sorted, sequences
    by index. ``path`` joins the keys with ``/`` (``"blocks/b2/attn/wq"``)."""
    out: List[Tuple[str, Any]] = []
    _flatten_into(out, tree, (), is_leaf)
    return out


def _flatten_into(out, node, prefix, is_leaf):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``out`` (every leaf of the tree,
    # gigabytes of device memory for a model's gradients) alive until the
    # garbage collector runs
    if (is_leaf is not None and is_leaf(node)) or not _is_node(node):
        out.append(("/".join(prefix), node))
        return
    items = sorted(node.items()) if isinstance(node, dict) else enumerate(node)
    for k, child in items:
        _flatten_into(out, child, prefix + (str(k),), is_leaf)


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf)]


def unflatten(pairs) -> Dict:
    """Nested dict from ``[(path, leaf)]`` pairs (or a ``{path: leaf}``
    mapping) — the inverse of :func:`flatten_with_paths` for dict trees."""
    items = pairs.items() if isinstance(pairs, dict) else pairs
    root: Dict = {}
    for path, leaf in items:
        node = root
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] | None = None):
    """``fn(leaf, *rest_leaves)`` applied leaf by leaf; dicts, lists and
    tuples keep the structure of ``tree`` (``rest`` share it)."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                      for i, v in enumerate(tree))


def tree_map_indexed(fn: Callable, tree):
    """``fn(i, leaf)`` with ``i`` the leaf's position in JAX's leaf order
    (sorted dict keys), as ``enumerate(jax.tree_util.tree_leaves(tree))``
    numbers the leaves; the structure of ``tree`` is kept."""
    return _map_indexed(fn, tree, itertools.count())


def _map_indexed(fn, node, counter):
    if not _is_node(node):
        return fn(next(counter), node)
    if isinstance(node, dict):
        done = {k: _map_indexed(fn, node[k], counter) for k in sorted(node)}
        return {k: done[k] for k in node}
    return type(node)(_map_indexed(fn, v, counter) for v in node)


def count_params(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(math.prod(x.shape) for x in leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes of a tree of tensors (each leaf's dtype)."""
    return sum(math.prod(x.shape) * x.element_size() for x in leaves(tree))


class TreeVectorMeta:
    """How a flat ``(D,)`` vector splits back into a tree: each leaf's path,
    shape and size in leaf order. Hashable and comparable, like the
    reference's (whose ``treedef`` the ``paths`` stand in for)."""

    def __init__(self, paths, shapes, sizes):
        self.paths = tuple(paths)
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self.sizes = tuple(int(s) for s in sizes)
        self.total = sum(self.sizes)

    def __hash__(self):
        return hash((self.paths, self.shapes, self.sizes))

    def __eq__(self, other):
        return (isinstance(other, TreeVectorMeta)
                and self.paths == other.paths
                and self.shapes == other.shapes
                and self.sizes == other.sizes)


def tree_flatten_to_vector(tree) -> Tuple[torch.Tensor, TreeVectorMeta]:
    """A dict tree of tensors as one 1-D vector (the paper's ``w``), leaves
    concatenated in JAX's leaf order, plus the :class:`TreeVectorMeta` that
    undoes it."""
    pairs = flatten_with_paths(tree)
    meta = TreeVectorMeta([p for p, _ in pairs],
                          [tuple(t.shape) for _, t in pairs],
                          [t.numel() for _, t in pairs])
    vec = (torch.cat([t.reshape(-1) for _, t in pairs]) if pairs
           else torch.zeros((0,)))
    return vec, meta


def tree_unflatten_from_vector(vec: torch.Tensor, meta: TreeVectorMeta):
    """The dict tree whose leaves are views of consecutive slices of the
    1-D ``vec`` (works under ``torch.func.vmap``)."""
    if vec.shape[-1] != meta.total:
        raise ValueError(f"vector of {vec.shape[-1]} elements, meta wants "
                         f"{meta.total}")
    parts = torch.split(vec, meta.sizes) if meta.sizes else ()
    return unflatten([(path, part.reshape(shape)) for path, shape, part
                      in zip(meta.paths, meta.shapes, parts)])


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_lerp(global_tree, local_tree, gate_tree):
    """Per-leaf masked mix: ``gate * global + (1 - gate) * local`` (paper
    eqs. 4/6)."""
    return tree_map(lambda g, l, m: m * g + (1.0 - m) * l,
                    global_tree, local_tree, gate_tree)


def value_and_grad(fn, params, *args):
    """``jax.value_and_grad(fn, has_aux=True)`` for a dict tree of tensors:
    ``fn(params, *args) -> (loss, aux)`` is run on detached leaves that
    require grad, and ``((loss, aux), grads)`` come back detached, ``grads``
    in the tree's shape."""
    pairs = flatten_with_paths(params)
    diff = [(path, leaf.detach().requires_grad_()) for path, leaf in pairs]
    with record_function("train.forward"):
        loss, aux = fn(unflatten(diff), *args)
    with record_function("train.backward"):
        grads = torch.autograd.grad(loss, [leaf for _, leaf in diff])
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, aux)
    return (loss.detach(), aux), unflatten([(path, g) for (path, _), g
                                            in zip(diff, grads)])
