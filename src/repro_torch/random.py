"""Counter-based random numbers, bit for bit those of ``jax.random``.

The JAX package ties every round of federated training to one key chain:
the round key splits into the selection, share-mask, forward-mask,
uplink-mask and LocalUpdate keys; ``fold_in`` derives the int8 wire's
rounding keys; ``split`` derives per-client and per-step keys. This module is
threefry2x32 (Salmon et al., SC'11) written with torch integer ops, laid out
as ``jax.random`` lays it out with ``jax_threefry_partitionable=True`` (the
default from jax 0.5 on), so the same key gives the same selection, gates,
cohorts, minibatch indices and stochastic rounding in both packages, and on
the card as on the CPU: every draw is integer arithmetic.

A key is an int64 tensor of shape ``(2,)`` holding two 32-bit words, or a
batch of keys ``(..., 2)``: every function maps over the leading key axes as
``jax.vmap`` over keys does. torch's ``uint32`` lacks most ops, so words live
in int64 and are masked to 32 bits after every add and shift.

Functions: :func:`PRNGKey`, :func:`split`, :func:`fold_in`, :func:`bits`
(raw 32-bit draws), :func:`uniform`, :func:`randint`, :func:`permutation`,
all bitwise; and :func:`normal`, whose uniform draws are bitwise but whose
``erfinv`` is torch's (within ~1e-5 relative of XLA's in the tails; bitwise
once rounded to bfloat16).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**64``: the seed's
    high and low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``; all int64 words below 2**32, broadcast
    together. Returns the two output words."""
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


def _hash_counts(key, shape: Tuple[int, ...], start: int = 0):
    """Threefry of the row-major counters ``start .. start+prod(shape)-1``
    under each key of ``key`` (``(..., 2)``): two word tensors of shape
    ``key.shape[:-1] + shape``. Counters are 64-bit, split high/low
    (``iota_2x32_shape``)."""
    n = math.prod(shape)
    count = torch.arange(start, start + n, dtype=torch.int64,
                         device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, count >> 32, count & MASK32)


def split(key, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``key.shape[:-1] + shape + (2,)`` new keys."""
    shape = _shape(num)
    y0, y1 = _hash_counts(key, shape)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data``: an int, or an
    integer tensor broadcast against the key batch (``fold_in(key,
    arange(n))`` is ``vmap(lambda i: fold_in(key, i))(arange(n))``)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & MASK32
    else:
        data = torch.full_like(key[..., 1], int(data) & MASK32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def bits(key, shape: Shape, start: int = 0) -> torch.Tensor:
    """Raw 32-bit draws (``jax.random.bits``, uint32), as int64 in
    ``[0, 2**32)``: the xor of the two threefry output words. ``start``
    skips that many draws of the flat, row-major sequence: the draws of
    ``bits(key, (n,))`` at ``start .. start+prod(shape)-1``, so a large
    draw can be made in counter ranges that concatenate to it bit for bit."""
    y0, y1 = _hash_counts(key, _shape(shape), start)
    return y0 ^ y1


# mantissa bits of the float types jax.random draws in 16 bits
_NMANT16 = {torch.bfloat16: 7, torch.float16: 10}


def uniform(key, shape: Shape = (), start: int = 0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on ``[0, 1)``, bitwise:
    the draw's top mantissa bits under the exponent of 1.0, minus 1
    (``start`` as in :func:`bits`). float32 takes the top 23 bits; a 16-bit
    type (bfloat16, float16) takes the low 16 bits of the draw, or the low
    8 where it has fewer than 8 mantissa bits (bfloat16), as jax does."""
    b = bits(key, shape, start)
    if dtype == torch.float32:
        f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    nmant = _NMANT16[dtype]
    rng_bits = 8 if nmant < 8 else 16
    one = torch.ones((), dtype=dtype).view(torch.int16).item()
    fb = ((b & ((1 << rng_bits) - 1)) >> (rng_bits - nmant)) | one
    return fb.to(torch.int16).view(dtype) - torch.ones((), dtype=dtype,
                                                       device=key.device)


def normal(key, shape: Shape = (), start: int = 0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) * erfinv(u)``
    with ``u`` uniform on ``(-1, 1)`` drawn as jax draws it (bitwise), each
    op rounded to ``dtype``; torch's ``erfinv`` differs from XLA's by a few
    float32 ulps, which bfloat16's rounding hides (``start`` as in
    :func:`bits`)."""
    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=key.device)
    lo = scalar(-1.0 + torch.finfo(dtype).eps / 2)     # nextafter(-1, 0)
    hi = scalar(1.0)
    u = torch.maximum(lo, uniform(key, shape, start, dtype) * (hi - lo) + lo)
    return torch.erfinv(u) * scalar(1.4142135)


def randint(key, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws per value, ``(hi % span) * (2**32 % span) + lo % span``
    modulo ``span``, in uint32 arithmetic. Returned as int64."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint: [{minval}, {maxval}) is not an int32 range")
    span = max(maxval - minval, 1)      # jax: span 1 when maxval <= minval
    keys = split(key, 2)
    hi = bits(keys[..., 0, :], shape)
    lo = bits(keys[..., 1, :], shape)
    # jax: multiplier = ((2**16 % span)**2) % span with a uint32 square
    mult = (((2 ** 16) % span) ** 2 & MASK32) % span
    off = ((hi % span) * mult) & MASK32
    off = ((off + lo % span) & MASK32) % span
    return off + minval


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` shuffled by
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort on fresh 32-bit
    keys (``_shuffle``). Returns int64 ``key.shape[:-1] + (n,)``."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        lead + (n,)).contiguous()
    for _ in range(rounds):
        pair = split(key, 2)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
