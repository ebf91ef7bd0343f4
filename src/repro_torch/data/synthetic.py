"""Synthetic dataset generators, statistically matched to the paper's data.

A numpy-only copy of ``repro.data.synthetic``: the same seeds give
bitwise-equal series in both packages.

The container is offline, so the UK-EV (Dundee 2017-18), NN5, ETT and Weather
datasets are replaced by generators that mimic their documented properties
(DESIGN.md §7). Paper Fig. 5's observations drive the two FL generators:

* EV charging (daily kWh, 58 stations): weak weekly seasonality, heavy noise,
  zero-inflation, random **missing spans** ("certain chargers were offline for
  maintenance etc."), per-station scale differences (the non-homogeneity the
  paper opens with).
* NN5 (daily ATM cash demand, 111 machines): "high quality ... clear seasonal
  pattern" — strong weekly profile + mild annual cycle, high SNR.
"""
from __future__ import annotations

import numpy as np


def ev_synthetic(seed: int = 0, num_clients: int = 58, num_days: int = 420):
    """(K, T) daily consumed energy in kWh per charging station."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_days)
    out = np.zeros((num_clients, num_days), np.float32)
    for i in range(num_clients):
        base = rng.gamma(3.0, 12.0)  # station scale: tens of kWh/day
        weekly = 1.0 + 0.25 * np.sin(2 * np.pi * (t + rng.integers(7)) / 7.0)
        trend = 1.0 + 0.3 * t / num_days * rng.uniform(-1, 1)
        lam = base * weekly * trend
        # day-level demand: noisy, occasionally zero (station idle)
        x = rng.gamma(2.0, lam / 2.0)
        idle = rng.random(num_days) < 0.08
        x[idle] = 0.0
        # missing/maintenance spans
        n_spans = rng.integers(1, 4)
        for _ in range(n_spans):
            s = rng.integers(0, num_days - 10)
            ln = rng.integers(3, 15)
            x[s : s + ln] = 0.0
        out[i] = x
    return out


def nn5_synthetic(seed: int = 1, num_clients: int = 111, num_days: int = 735):
    """(K, T) daily cash withdrawal volume per ATM; strong weekly pattern."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_days)
    out = np.zeros((num_clients, num_days), np.float32)
    dow = t % 7
    for i in range(num_clients):
        base = rng.gamma(4.0, 5.0)
        profile = rng.uniform(0.5, 1.5, size=7)
        profile[5] *= 1.6  # weekend peaks
        profile[6] *= 0.4  # sunday trough
        annual = 1.0 + 0.15 * np.sin(2 * np.pi * t / 365.25 + rng.uniform(0, 2 * np.pi))
        x = base * profile[dow] * annual
        x = x * (1.0 + 0.10 * rng.standard_normal(num_days))  # high SNR
        out[i] = np.maximum(x, 0.0)
    return out


def household_synthetic(seed: int = 4, num_clients: int = 32, num_days: int = 500):
    """(K, T) daily household electricity consumption in kWh.

    UCI household-power-like data aggregated to daily resolution: base load,
    weekend-at-home uplift, an annual heating/cooling cycle with per-household
    phase, occupancy noise, and vacation spans at ~10% load. Cleaner than the
    EV stations (no dead meters) but with stronger annual non-stationarity —
    the third FL workload next to ``ev``/``nn5`` (ForecastTask ``household``).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_days)
    dow = t % 7
    out = np.zeros((num_clients, num_days), np.float32)
    for i in range(num_clients):
        base = rng.gamma(5.0, 2.0)  # ~10 kWh/day typical household
        profile = np.ones(7)
        profile[5:] *= rng.uniform(1.05, 1.3)  # weekends at home
        annual = 1.0 + rng.uniform(0.2, 0.5) * np.cos(
            2 * np.pi * t / 365.25 + rng.uniform(0, 2 * np.pi))
        x = base * profile[dow] * annual
        x = x * (1.0 + 0.15 * rng.standard_normal(num_days))
        for _ in range(rng.integers(1, 4)):  # vacations
            s = rng.integers(0, num_days - 14)
            ln = rng.integers(3, 15)
            x[s : s + ln] *= 0.1
        out[i] = np.maximum(x, 0.0)
    return out


def ett_like(seed: int = 2, num_channels: int = 7, length: int = 17420):
    """Multivariate hourly series mimicking electricity-transformer temps:
    daily + weekly cycles, channel cross-correlation, slow drift."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    shared = (
        np.sin(2 * np.pi * t / 24.0)
        + 0.5 * np.sin(2 * np.pi * t / (24.0 * 7))
        + 0.1 * np.cumsum(rng.standard_normal(length)) / np.sqrt(length)
    )
    out = np.zeros((num_channels, length), np.float32)
    for c in range(num_channels):
        mix = rng.uniform(0.5, 1.0)
        own = np.sin(2 * np.pi * t / 24.0 + rng.uniform(0, 2 * np.pi)) * rng.uniform(0.2, 0.8)
        noise = 0.3 * rng.standard_normal(length)
        out[c] = mix * shared + own + noise
    return out


def weather_like(seed: int = 3, num_channels: int = 21, length: int = 20000):
    """Multivariate 10-minute weather-station-like series."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    daily = np.sin(2 * np.pi * t / 144.0)  # 144 x 10min = 1 day
    out = np.zeros((num_channels, length), np.float32)
    for c in range(num_channels):
        season = np.sin(2 * np.pi * t / (144.0 * 365) * rng.uniform(0.5, 2))
        ar = np.zeros(length)
        e = rng.standard_normal(length) * 0.4
        phi = rng.uniform(0.8, 0.98)
        for i in range(1, length):
            ar[i] = phi * ar[i - 1] + e[i]
        out[c] = rng.uniform(0.3, 1.0) * daily + 0.5 * season + ar
    return out


def synthetic_tokens(seed: int, batch: int, seq_len: int, vocab: int):
    """Zipf-ish token stream for LM training examples/smoke tests."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    return rng.choice(vocab, size=(batch, seq_len), p=p).astype(np.int32)
