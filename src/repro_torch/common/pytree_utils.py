"""Nested-dict parameter trees, flattened the way JAX flattens them.

Counterpart of ``repro.common.pytree_utils`` (and of
``repro.checkpoint.checkpoint._path_str``) for the port's trees: nested
``dict``s (lists and tuples are allowed too) whose leaves are tensors or
arrays. JAX flattens a dict in SORTED key order, so :func:`flatten_with_paths`
does too; the ``a/b/c`` path strings are the checkpoint keys both packages
write. The flat ``(D,)`` parameter vector of the FL engine lands with the
training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree, is_leaf: Callable[[Any], bool] | None = None
                       ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's leaf order: dict keys sorted, sequences
    by index. ``path`` joins the keys with ``/`` (``"blocks/b2/attn/wq"``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if (is_leaf is not None and is_leaf(node)) or not _is_node(node):
            out.append(("/".join(prefix), node))
            return
        items = (sorted(node.items()) if isinstance(node, dict)
                 else enumerate(node))
        for k, child in items:
            walk(child, prefix + (str(k),))

    walk(tree, ())
    return out


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


def tree_map(fn: Callable, tree, is_leaf: Callable[[Any], bool] | None = None):
    """``fn`` applied to every leaf; dicts, lists and tuples keep their
    structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
