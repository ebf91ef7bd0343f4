"""Initial weights of a forecaster, drawn on the device from the seed.

One ``torch.randn`` call over the whole flat vector with a generator on the
device, then each leaf scaled by its initializer (std 1/sqrt(fan-in),
0.02, or a constant 0 or 1). The flat vector is laid out in the reference's
leaf order, and the nested tree the program takes holds views of it, so
both sides start from the same numbers.
"""
from __future__ import annotations

import math

import torch

from bench.reference import model as RM


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def draw(model: dict, seed: int, stream: int, device):
    """``(flat (D,), tree)`` float32 on ``device``; ``tree`` nests the
    leaves by their paths."""
    specs = RM.leaf_specs(model)
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.randn(total, generator=generator(seed, stream, device),
                       device=device)
    scales, off = torch.empty(total, device=device), 0
    for _, shape, init in specs:
        n = math.prod(shape)
        value = {"zeros": 0.0, "ones": None}.get(init, RM.init_std(shape, init))
        if value is None:
            flat[off:off + n] = 1.0
            scales[off:off + n] = 1.0
        else:
            scales[off:off + n] = value
        off += n
    flat = flat * scales
    return flat, tree_of(flat, model)


def tree_of(flat: torch.Tensor, model: dict) -> dict:
    tree = {}
    for path, leaf in RM.unflatten(flat[None], model).items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf[0]
    return tree


def flat_of(tree: dict, model: dict) -> torch.Tensor:
    """The program's tree back to the reference's flat layout."""
    parts = []
    for path, _, _ in RM.leaf_specs(model):
        node = tree
        for key in path.split("/"):
            node = node[key]
        parts.append(node.reshape(-1))
    return torch.cat(parts)
