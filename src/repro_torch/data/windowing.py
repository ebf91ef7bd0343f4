"""Sliding-window dataset construction + chronological splits.

A numpy-only copy of ``repro.data.windowing``: outputs are bitwise equal
to the reference's.

The paper's FL task: look-back 128 steps, horizon 2 (EV) / 4 (NN5); data is
cleaned by removing dead stations and aggregated to daily resolution (the
generators already emit daily series).

Two layouts feed the FL engine:

  * MATERIALIZED (:func:`client_datasets`) — ``(K, n_win, L+T)`` stride-1
    window tensors per split. Simple, but inflates every client's series
    ~``(L+T)``x, so host->device transfer and device residency become the
    ceiling on client count long before compute does.
  * STREAMING (:func:`client_series` / :func:`client_series_datasets`) — the
    raw normalized ``(K, T)`` series plus split boundaries; the engine gathers
    ``(batch, L+T)`` windows ON DEVICE inside the compiled round loop
    (``FLConfig.streaming_windows``). Window ``i`` of a raw slice is
    ``slice[i : i + L + T]`` — bit-identical values to the materialized
    tensor's row ``i``, at ~``(L+T)``x less memory.
"""
from __future__ import annotations

import numpy as np


def clean_clients(series: np.ndarray, min_active_frac: float = 0.5):
    """Paper's cleaning: drop stations that stopped providing data. Here:
    drop clients whose last-quarter activity is (near) zero or that are
    mostly inactive overall. The tail is clamped to at least one step:
    ``-T // 4`` is 0 for ``T < 4`` and ``series[:, 0:]`` would silently test
    the WHOLE history instead of the tail."""
    K, T = series.shape
    tail = series[:, -max(T // 4, 1):]
    active = (series > 0).mean(axis=1) >= min_active_frac * 0.5
    alive_tail = (tail > 0).mean(axis=1) > 0.05
    keep = active & alive_tail
    return series[keep], np.nonzero(keep)[0]


def make_windows(series: np.ndarray, look_back: int, horizon: int) -> np.ndarray:
    """(K, T) -> (K, n_win, look_back + horizon), stride 1."""
    K, T = series.shape
    n = T - look_back - horizon + 1
    assert n > 0, "series too short for the requested window"
    idx = np.arange(look_back + horizon)[None, :] + np.arange(n)[:, None]
    return series[:, idx]  # (K, n, L+T)


def table1_windows(series: np.ndarray, look_back: int, horizon: int,
                   stride: int = 7):
    """The centralized comparison's windows (``benchmarks/table1.py``'s
    ``_windows``, which the reference package does not hold): each channel
    of the ``(C, T)`` series z-normalised over its whole length, windowed at
    ``stride``, channel-independent, as ``(n, look_back)`` float32 inputs
    and ``(n, horizon)`` targets, channel by channel."""
    mu = series.mean(1, keepdims=True)
    sd = series.std(1, keepdims=True) + 1e-6
    z = (series - mu) / sd
    n = series.shape[1] - look_back - horizon + 1
    idx = np.arange(look_back + horizon)[None, :] + np.arange(0, n, stride)[:, None]
    w = z[:, idx].reshape(-1, look_back + horizon)
    return w[:, :look_back].astype(np.float32), w[:, look_back:].astype(np.float32)


def split_windows(windows: np.ndarray, train_frac=0.7, val_frac=0.1):
    """Chronological split along the window axis (no leakage)."""
    n = windows.shape[1]
    n_tr = int(n * train_frac)
    n_va = int(n * val_frac)
    return (
        windows[:, :n_tr],
        windows[:, n_tr : n_tr + n_va],
        windows[:, n_tr + n_va :],
    )


def window_split_counts(T: int, look_back: int, horizon: int,
                        train_frac=0.7, val_frac=0.1):
    """Per-split stride-1 window counts ``(n_tr, n_va, n_te)`` for a length-T
    series — the same arithmetic :func:`split_windows` applies to the
    materialized tensor, so both layouts agree on the split boundaries."""
    n = T - look_back - horizon + 1
    assert n > 0, "series too short for the requested window"
    n_tr = int(n * train_frac)
    n_va = int(n * val_frac)
    return n_tr, n_va, n - n_tr - n_va


def split_series(series: np.ndarray, look_back: int, horizon: int,
                 train_frac=0.7, val_frac=0.1):
    """Chronological split of the RAW series: three overlapping ``(K, T_*)``
    slices whose stride-1 windows are exactly the three outputs of
    ``split_windows(make_windows(series, L, T))`` — window ``i`` of a slice is
    ``slice[:, i : i + L + T]``. Each slice is ~``(L+T)``x smaller than its
    materialized counterpart (adjacent windows share all but one step)."""
    W = look_back + horizon
    n_tr, n_va, n_te = window_split_counts(series.shape[1], look_back, horizon,
                                           train_frac, val_frac)
    return (
        series[:, : n_tr + W - 1],
        series[:, n_tr : n_tr + n_va + W - 1],
        series[:, n_tr + n_va : n_tr + n_va + n_te + W - 1],
    )


def _clean_normalize(series: np.ndarray, normalize: bool):
    """Shared front of both layouts: clean -> per-client z-norm with stats
    from each client's first 80% of steps (the chronological train segment)."""
    series, kept = clean_clients(series)
    T = series.shape[1]
    stats = None
    if normalize:
        mu, sd = series_norm_stats(series)
        series = (series - mu) / sd
        stats = (mu, sd)
    return series, {"kept": kept, "norm": stats}


def series_norm_stats(series: np.ndarray, train_frac: float = 0.8):
    """Per-client normalization stats from the chronological train segment:
    ``(mu, sd)`` of shape ``(K, 1)``. Per-CLIENT statistics, so a station's
    stats are the same whether computed over the full fleet or any subset —
    ``tasks.write_routing_manifest`` relies on this to record servable
    denormalization stats for every station from the raw series."""
    n_tr_t = int(series.shape[1] * train_frac)
    mu = series[:, :n_tr_t].mean(axis=1, keepdims=True)
    sd = series[:, :n_tr_t].std(axis=1, keepdims=True) + 1e-6
    return mu, sd


def client_datasets(series: np.ndarray, look_back: int, horizon: int,
                    normalize: bool = True):
    """Full per-client pipeline: clean -> (optional) per-client z-norm on the
    train segment -> window -> chronological split.

    Returns (train, val, test) arrays of shape (K, n_*, L+T) plus norm stats.
    """
    series, info = _clean_normalize(series, normalize)
    w = make_windows(series, look_back, horizon)
    tr, va, te = split_windows(w)
    return tr, va, te, info


def client_series(series: np.ndarray, look_back: int, horizon: int,
                  normalize: bool = True):
    """Raw-series variant of :func:`client_datasets` for the streaming window
    pipeline: clean -> (optional) z-norm, but NO window materialization.

    Returns ``(series, split_idx, info)`` where ``series`` is the cleaned,
    normalized ``(K, T)`` matrix, ``split_idx = (n_tr, n_va, n_te)`` are the
    per-split window counts (window ``i`` of the train split starts at step
    ``i``; of val at ``n_tr + i``; of test at ``n_tr + n_va + i``), and
    ``info`` carries the same ``kept``/``norm`` entries as
    :func:`client_datasets`.
    """
    series, info = _clean_normalize(series, normalize)
    split_idx = window_split_counts(series.shape[1], look_back, horizon)
    return series, split_idx, info


def client_series_datasets(series: np.ndarray, look_back: int, horizon: int,
                           normalize: bool = True):
    """Streaming counterpart of :func:`client_datasets`: same cleaning and
    normalization, but returns the three RAW ``(K, T_*)`` split slices
    (:func:`split_series`) instead of materialized window tensors. The FL
    engine (``FLConfig.streaming_windows``) gathers windows from these on
    device — bit-identical values at ~``(L+T)``x less memory."""
    series, split_idx, info = client_series(series, look_back, horizon,
                                            normalize)
    tr, va, te = split_series(series, look_back, horizon)
    return tr, va, te, info
