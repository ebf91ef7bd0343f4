"""DTW-distance k-medoids clustering of clients (paper §III.B.2;
counterpart of ``repro.data.clustering``).

"All the clients are clustered using K-means clustering algorithm based on
the distances measured by dynamic time warping (DTW); the FL process is
conducted independently between different clusters."

The DTW dynamic program runs by ANTI-DIAGONALS: every cell ``(i, j)`` with
``i + j = d`` depends only on diagonals ``d - 1`` (left, up) and ``d - 2``
(up-left), so one diagonal is one vectorized step over all ``K (K - 1) / 2``
client pairs at once — ``2 T - 1`` steps on the device in place of the
reference's ``T x T`` nested scan. Each cell is the reference's
``cost + min(min(left, up), up_left)`` in float32; k-medoids is a numpy copy
of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device

_INF = 1e30


def dtw_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DTW distances between rows ``a[p]`` and ``b[p]`` (``(P, T)`` each,
    float32): ``dp[i, j] = |a_i - b_j| + min(dp[i, j-1], dp[i-1, j],
    dp[i-1, j-1])`` with ``dp[0, 0] = |a_0 - b_0|``, returns ``dp[T-1, T-1]``.
    Diagonal ``d`` is held as a ``(P, T)`` tensor indexed by ``i``; cells off
    the diagonal stay at ``1e30``."""
    P, T = a.shape
    dev = a.device
    inf = torch.full((P, T), _INF, dtype=a.dtype, device=dev)
    i = torch.arange(T, device=dev)
    prev2 = inf
    prev1 = inf.clone()
    prev1[:, 0] = (a[:, 0] - b[:, 0]).abs()
    shift = lambda x: torch.cat([inf[:, :1], x[:, :-1]], dim=1)  # noqa: E731
    for d in range(1, 2 * T - 1):
        j = d - i
        valid = (j >= 0) & (j < T)
        cost = (a - b[:, j.clamp(0, T - 1)]).abs()
        left, up, up_left = prev1, shift(prev1), shift(prev2)
        cur = cost + torch.minimum(torch.minimum(left, up), up_left)
        prev2, prev1 = prev1, torch.where(valid, cur, inf)
    return prev1[:, T - 1]


def dtw_distance_matrix(series, device=DEFAULT_DEVICE) -> torch.Tensor:
    """series: (K, T) -> (K, K) symmetric DTW distances between the
    z-normalized rows (population std ``+ 1e-6``, as the reference), on
    ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(series), dtype=torch.float32, device=dev)
    mu = x.mean(dim=1, keepdim=True)
    sd = x.std(dim=1, keepdim=True, unbiased=False) + 1e-6
    z = (x - mu) / sd
    K = x.shape[0]
    ii, jj = torch.triu_indices(K, K, offset=1, device=dev)
    mat = torch.zeros((K, K), dtype=torch.float32, device=dev)
    if ii.numel():
        mat[ii, jj] = dtw_pairs(z[ii], z[jj])
    return mat + mat.T


def kmedoids(dist: np.ndarray, k: int, seed: int = 0, iters: int = 50):
    """Plain PAM-style k-medoids on a precomputed distance matrix.

    Returns (labels (K,), medoid indices (k,))."""
    dist = np.asarray(dist)
    K = dist.shape[0]
    rng = np.random.default_rng(seed)
    medoids = rng.choice(K, size=k, replace=False)
    for _ in range(iters):
        labels = np.argmin(dist[:, medoids], axis=1)
        new_medoids = medoids.copy()
        for c in range(k):
            members = np.nonzero(labels == c)[0]
            if len(members) == 0:
                continue
            within = dist[np.ix_(members, members)].sum(axis=1)
            new_medoids[c] = members[np.argmin(within)]
        if np.array_equal(new_medoids, medoids):
            break
        medoids = new_medoids
    labels = np.argmin(dist[:, medoids], axis=1)
    return labels, medoids


def cluster_clients(series: np.ndarray, k: int, seed: int = 0,
                    device=DEFAULT_DEVICE):
    """Weekly-downsampled DTW (on ``device``) + k-medoids -> ``(labels,
    medoids)``."""
    K, T = series.shape
    wk = T // 7
    weekly = series[:, : wk * 7].reshape(K, wk, 7).mean(axis=2)
    dist = dtw_distance_matrix(weekly, device=device).cpu().numpy()
    return kmedoids(dist, k, seed)
