"""Parameter-selection masks for the partial-sharing FL policies
(counterpart of ``repro.core.fl.masks``).

The paper's S_n^i (sharing) and F_n^i (forwarding) matrices are D x D
diagonal 0/1 matrices, held as boolean vectors over the flat parameter
vector (element granularity). Keys are ``repro_torch.random`` keys, so the
same key gives the same mask as the reference, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt


def _first_k_of_descending(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties to
    the LOWEST index (``lax.top_k``'s order; ``torch.topk`` promises none):
    the first ``k`` of a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def bernoulli_mask(key, dim: int, ratio: float) -> torch.Tensor:
    """iid Bernoulli(ratio) mask over the parameter vector (``key`` may be
    a batch of keys ``(..., 2)``: one mask per key)."""
    return R.uniform(key, (dim,)) < ratio


def exact_k_mask(key, dim: int, k: int) -> torch.Tensor:
    """Mask with exactly ``k`` ones: the top-``k`` of uniform scores, ties
    broken by position, so it never has more than ``k`` ones."""
    if k <= 0:
        return torch.zeros((dim,), dtype=torch.bool, device=key.device)
    idx = _first_k_of_descending(R.uniform(key, (dim,)), min(k, dim))
    mask = torch.zeros((dim,), dtype=torch.bool, device=key.device)
    return mask.index_fill(0, idx, True)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(K, D) scores -> boolean mask with exactly ``k`` True per row
    (largest scores win; ties to the lowest index)."""
    idx = _first_k_of_descending(scores, k)
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter(1, idx, True)


def client_masks(key, num_clients: int, dim: int, ratio: float) -> torch.Tensor:
    """(K, D) independent masks, one per client, from ``split(key, K)``."""
    return bernoulli_mask(R.split(key, num_clients), dim, ratio)


def select_clients(key, num_clients: int, select_ratio: float) -> torch.Tensor:
    """Boolean (K,) with exactly ``max(1, round(K * ratio))`` selected
    clients (Python's ``round``: half to even, as the reference)."""
    c = max(1, int(round(num_clients * select_ratio)))
    perm = R.permutation(key, num_clients)
    sel = torch.zeros((num_clients,), dtype=torch.bool, device=key.device)
    return sel.index_fill(0, perm[:c], True)


def leaf_gates(key, tree, ratio: float):
    """Per-leaf Bernoulli(ratio) scalar gates (0./1.): leaf ``i`` in leaf
    order draws ``uniform(fold_in(key, i), ())``. The same key always gives
    the same gates."""
    return pt.tree_map_indexed(
        lambda i, _: (R.uniform(R.fold_in(key, i), ()) < ratio).to(torch.float32),
        tree)
