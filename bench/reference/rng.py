"""Threefry2x32 counter-based random numbers, laid out as ``jax.random``
lays them out (``jax_threefry_partitionable=True``).

A frozen copy of the draws the PSGF-Fed round makes (``split``, ``bits``,
``uniform``, ``randint``, ``permutation``), written with torch integer ops,
so the reference makes the same selection, gates, cohorts and minibatch
indices as the program from the same key. Copied from
``src/repro_torch/random.py`` at commit 2bc2c01 and not imported from it:
the reference shares no code with the program under test.

A key is an int64 tensor ``(..., 2)`` of two 32-bit words; every function
maps over the leading key axes.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _hash_counts(key, shape):
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, count >> 32, count & MASK32)


def split(key, num: int = 2):
    y0, y1 = _hash_counts(key, (int(num),))
    return torch.stack([y0, y1], dim=-1)


def bits(key, shape):
    y0, y1 = _hash_counts(key, tuple(shape))
    return y0 ^ y1


def uniform(key, shape):
    """float32 on [0, 1): the top 23 bits of a draw under 1.0's exponent."""
    b = bits(key, shape)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(key, shape, minval: int, maxval: int):
    span = max(int(maxval) - int(minval), 1)
    keys = split(key, 2)
    hi = bits(keys[..., 0, :], shape)
    lo = bits(keys[..., 1, :], shape)
    mult = (((2 ** 16) % span) ** 2 & MASK32) % span
    off = ((hi % span) * mult) & MASK32
    off = ((off + lo % span) & MASK32) % span
    return off + int(minval)


def permutation(key, n: int):
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        pair = split(key, 2)
        key, sub = pair[0], pair[1]
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
