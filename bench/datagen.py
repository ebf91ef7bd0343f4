"""Traffic generation: every series a cell trains on, made from ``--seed``.

The one generator of the benchmark. A traffic file names a ``dataset`` and
its sizes; the same seed gives the same series, and every seed gives the
same sizes, so the seed changes the values and never the work.

* ``ev_fleet``: daily kWh per charging station, the statistics of the
  paper's UK EV data (Fig. 5): a gamma station scale, a weak weekly cycle,
  a drift, gamma day-level noise, 8% idle days and one to three offline
  spans. The formula of ``repro_torch.data.synthetic.ev_synthetic``, frozen
  here at commit 2bc2c01. Every station is kept (the program's cleaning
  step would drop a station idle in most of its last quarter, which this
  generator does not make), so the fleet is exactly the size the traffic
  names. Each station is z-normalised with the mean and deviation of its
  first 80% of days, then split chronologically as the paper splits its
  windows (70% train, 10% validation, 20% test of the stride-1 windows).
* ``weather``: 10-minute weather-station-like channels (a daily cycle, a
  slow season and an AR(1) process), the formula of
  ``repro_torch.data.synthetic.weather_like``; each channel z-normalised
  over its whole length and cut into look-back + horizon windows at stride
  7, channel by channel, as ``benchmarks/table1.py`` windows Table I's data.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def ev_series(seed: int, stations: int, days: int) -> np.ndarray:
    rng = _rng(seed, 1)
    t = np.arange(days)
    out = np.zeros((stations, days), np.float32)
    for i in range(stations):
        base = rng.gamma(3.0, 12.0)
        weekly = 1.0 + 0.25 * np.sin(2 * np.pi * (t + rng.integers(7)) / 7.0)
        trend = 1.0 + 0.3 * t / days * rng.uniform(-1, 1)
        x = rng.gamma(2.0, base * weekly * trend / 2.0)
        x[rng.random(days) < 0.08] = 0.0
        for _ in range(rng.integers(1, 4)):
            s = rng.integers(0, days - 10)
            x[s:s + rng.integers(3, 15)] = 0.0
        out[i] = x
    return out


def ev_fleet(seed: int, stations: int, days: int, look_back: int,
             horizon: int, streaming: bool):
    """``(train, test)``: raw ``(K, T_split)`` slices whose stride-1 windows
    are the split's windows, or with ``streaming=False`` the windows
    themselves ``(K, n, look_back + horizon)``."""
    x = ev_series(seed, stations, days)
    n80 = int(days * 0.8)
    mu = x[:, :n80].mean(axis=1, keepdims=True)
    sd = x[:, :n80].std(axis=1, keepdims=True) + 1e-6
    x = ((x - mu) / sd).astype(np.float32)
    W = look_back + horizon
    n = days - W + 1
    n_tr, n_va = int(n * 0.7), int(n * 0.1)
    train = x[:, :n_tr + W - 1]
    test = x[:, n_tr + n_va:]
    if not streaming:
        train, test = _windows(train, W), _windows(test, W)
    return np.ascontiguousarray(train), np.ascontiguousarray(test)


def _windows(x: np.ndarray, W: int) -> np.ndarray:
    n = x.shape[1] - W + 1
    return x[:, np.arange(W)[None, :] + np.arange(n)[:, None]]


def weather_series(seed: int, channels: int, length: int) -> np.ndarray:
    rng = _rng(seed, 2)
    t = np.arange(length)
    daily = np.sin(2 * np.pi * t / 144.0)
    out = np.zeros((channels, length), np.float32)
    for c in range(channels):
        season = np.sin(2 * np.pi * t / (144.0 * 365) * rng.uniform(0.5, 2))
        e = rng.standard_normal(length) * 0.4
        phi = rng.uniform(0.8, 0.98)
        ar = np.zeros(length)
        for i in range(1, length):
            ar[i] = phi * ar[i - 1] + e[i]
        out[c] = rng.uniform(0.3, 1.0) * daily + 0.5 * season + ar
    return out


def weather_windows(seed: int, channels: int, length: int, look_back: int,
                    horizon: int, stride: int = 7):
    """``(x (C * n, look_back), y (C * n, horizon), n)``: channel ``c``'s
    window ``j`` is row ``c * n + j``."""
    s = weather_series(seed, channels, length)
    z = (s - s.mean(1, keepdims=True)) / (s.std(1, keepdims=True) + 1e-6)
    W = look_back + horizon
    starts = np.arange(0, length - W + 1, stride)
    w = z[:, starts[:, None] + np.arange(W)[None, :]].reshape(-1, W)
    return (np.ascontiguousarray(w[:, :look_back], dtype=np.float32),
            np.ascontiguousarray(w[:, look_back:], dtype=np.float32),
            len(starts))
