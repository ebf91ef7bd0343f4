"""Forecasting tasks and the generational routing manifest (counterpart of
``repro.core.tasks``).

  * :class:`ForecastTask` — a dataset workload by name (``ev``, ``nn5``,
    ``household``) with the paper's look-back/horizon defaults and
    ``quick``/``full`` presets (``get_task("ev", quick=False)``);
  * the routing manifest that ``ForecastServer.from_manifest`` serves:
    :func:`write_routing_manifest`, :func:`update_routing_manifest`,
    :func:`read_routing_manifest`, :func:`manifest_generations`, writing and
    reading the same ``routing.json`` / ``routing.g<N>.json`` JSON as the
    reference, so either package serves the other's manifests.

Not ported yet (they land with the training slice): DTW clustering
(``ForecastTask.cluster_labels``), ``ExperimentSpec`` and ``run_experiment``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpoint import atomic_write_json
from repro_torch.core.forecaster import Forecaster, get_forecaster
from repro_torch.data.synthetic import ev_synthetic, household_synthetic, nn5_synthetic
from repro_torch.data.windowing import (client_datasets, client_series_datasets,
                                        series_norm_stats)

_GENERATORS = {
    "ev": ev_synthetic,
    "nn5": nn5_synthetic,
    "household": household_synthetic,
}


@dataclasses.dataclass(frozen=True)
class ForecastTask:
    """A named forecasting workload: generator + split geometry + clustering."""

    name: str
    dataset: str                 # key into the generator registry
    seed: int
    num_clients: int
    num_days: int
    look_back: int
    horizon: int
    clusters: int = 0            # 0 = pooled FL over all clients
    min_cluster_clients: int = 2
    cluster_seed: int = 0

    def series(self) -> np.ndarray:
        """(K, T) raw client series."""
        gen = _GENERATORS[self.dataset]
        return gen(seed=self.seed, num_clients=self.num_clients,
                   num_days=self.num_days)

    def client_data(self, series: np.ndarray, idx=None,
                    streaming: bool = False):
        """clean -> normalize -> window -> split for all clients or a subset.

        Returns ``(train, val, test, info)``: ``(K, n_win, look_back +
        horizon)`` window tensors, or with ``streaming=True`` the raw
        ``(K, T_*)`` split slices. Same cleaning, normalization and split
        boundaries either way."""
        sub = series if idx is None else series[idx]
        build = client_series_datasets if streaming else client_datasets
        return build(sub, self.look_back, self.horizon)


# The paper's settings (§III.B) at two scales: ``quick`` is the CI-sized
# variant, ``full`` the paper-sized one.
_TASKS = {
    "ev": {
        "quick": ForecastTask("ev", "ev", seed=0, num_clients=24, num_days=300,
                              look_back=64, horizon=2),
        "full": ForecastTask("ev", "ev", seed=0, num_clients=58, num_days=420,
                             look_back=128, horizon=2),
    },
    "nn5": {
        "quick": ForecastTask("nn5", "nn5", seed=1, num_clients=24,
                              num_days=400, look_back=64, horizon=4),
        "full": ForecastTask("nn5", "nn5", seed=1, num_clients=64,
                             num_days=735, look_back=128, horizon=4),
    },
    "household": {
        "quick": ForecastTask("household", "household", seed=4, num_clients=16,
                              num_days=300, look_back=64, horizon=4),
        "full": ForecastTask("household", "household", seed=4, num_clients=32,
                             num_days=500, look_back=128, horizon=4),
    },
}


def task_names():
    return sorted(_TASKS)


def get_task(name: str, quick: bool = True, **overrides) -> ForecastTask:
    """Resolve a task preset, optionally overriding any field."""
    if name not in _TASKS:
        raise KeyError(f"unknown task {name!r}; known: {task_names()}")
    base = _TASKS[name]["quick" if quick else "full"]
    return dataclasses.replace(base, **overrides) if overrides else base


def task_forecaster(task: ForecastTask, model: str = "logtst",
                    quick: bool = True, **overrides) -> Forecaster:
    """Model preset matched to a task: paper-sized by default, the small
    (d_model 32) variant when ``quick``."""
    kw = dict(look_back=task.look_back, horizon=task.horizon)
    if quick:
        kw.update(d_model=32, num_heads=4, d_ff=64)
    kw.update(overrides)
    return get_forecaster(model, **kw)


# ---------------------------------------------------------------------------
# generational routing manifest
# ---------------------------------------------------------------------------

ROUTING_MANIFEST = "routing.json"
_GENERATION_RE = re.compile(r"routing\.g(\d+)\.json$")


def _generation_path(checkpoint_dir: str, generation: int) -> str:
    return os.path.join(checkpoint_dir, f"routing.g{generation:06d}.json")


def manifest_generations(checkpoint_dir: str):
    """Sorted generation numbers with a complete ``routing.g<N>.json``
    snapshot on disk (``[]`` for a legacy root with only ``routing.json``)."""
    if not os.path.isdir(checkpoint_dir):
        return []
    gens = []
    for name in os.listdir(checkpoint_dir):
        m = _GENERATION_RE.fullmatch(name)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def read_routing_manifest(checkpoint_dir: str,
                          generation: Optional[int] = None):
    """Read the LATEST COMPLETE generation of the routing manifest (or a
    pinned ``generation``). Returns ``(generation, manifest_dict)``.

    A corrupt or missing ``routing.json`` falls back to the highest
    generation snapshot that parses; manifests written before generations
    existed read as generation 0."""
    if generation is not None:
        with open(_generation_path(checkpoint_dir, generation)) as f:
            manifest = json.load(f)
        return int(manifest.get("generation", generation)), manifest
    candidates = [os.path.join(checkpoint_dir, ROUTING_MANIFEST)]
    candidates += [_generation_path(checkpoint_dir, g)
                   for g in reversed(manifest_generations(checkpoint_dir))]
    err: Optional[Exception] = None
    for path in candidates:
        try:
            with open(path) as f:
                manifest = json.load(f)
            return int(manifest.get("generation", 0)), manifest
        except FileNotFoundError as exc:
            err = err or exc
        except json.JSONDecodeError as exc:  # torn legacy write: fall back
            err = err or exc
    raise FileNotFoundError(
        f"no complete routing manifest under {checkpoint_dir}") from err


def write_routing_manifest(checkpoint_dir: str, task: ForecastTask,
                           model: Forecaster, labels: np.ndarray,
                           rows, series: Optional[np.ndarray] = None,
                           generation: Optional[int] = None) -> str:
    """Index checkpointed runs for ``ForecastServer.from_manifest``:
    ``<checkpoint_dir>/routing.json`` maps policy label -> cluster label ->
    checkpoint subdir, plus the per-station cluster assignment::

        {"generation": 0, "task": "ev", "model": "logtst/15",
         "look_back": 64, "horizon": 2, "clusters": 2,
         "station_cluster": [0, 1, 0, ...],
         "norm": {"mu": [...], "sd": [...]},    # with ``series``
         "policies": {"psgf": {"0": "psgf_c0", "1": "psgf_c1"}}}

    ``rows`` are ``{"policy", "cluster"}`` dicts (cluster None = pooled).
    With the raw ``series`` the manifest records each station's z-norm stats
    for raw-unit serving. ``generation=None`` bumps past whatever is on disk
    (a fresh root starts at 0); the snapshot ``routing.g<N>.json`` lands
    first, then ``routing.json`` is replaced atomically."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    if generation is None:
        try:
            generation = read_routing_manifest(checkpoint_dir)[0] + 1
        except FileNotFoundError:
            generation = 0
    policies: dict = {}
    for r in rows:
        sub = r["policy"] + ("" if r["cluster"] is None else f"_c{r['cluster']}")
        policies.setdefault(r["policy"], {})[str(r["cluster"] or 0)] = sub
    manifest = {
        "generation": int(generation),
        "task": task.name,
        "model": model.name,
        "look_back": task.look_back,
        "horizon": task.horizon,
        "clusters": max(task.clusters, 1),
        "station_cluster": np.asarray(labels, np.int64).tolist(),
        "policies": policies,
    }
    if series is not None:
        mu, sd = series_norm_stats(np.asarray(series))
        manifest["norm"] = {"mu": mu.ravel().tolist(),
                            "sd": sd.ravel().tolist()}
    return _publish_manifest(checkpoint_dir, manifest)


def _publish_manifest(checkpoint_dir: str, manifest: dict) -> str:
    """Snapshot-then-swap: the per-generation file is the durable record,
    the atomic replace of ``routing.json`` is the publication."""
    atomic_write_json(_generation_path(checkpoint_dir,
                                       manifest["generation"]), manifest)
    path = os.path.join(checkpoint_dir, ROUTING_MANIFEST)
    atomic_write_json(path, manifest)
    return path


def update_routing_manifest(checkpoint_dir: str, policy: str,
                            cluster_subdirs: dict,
                            station_norm: Optional[dict] = None) -> Tuple[int, str]:
    """Publish generation N+1 of an existing manifest with only the given
    clusters' checkpoint subdirs (and optionally some stations' ``(mu, sd)``
    norm stats) replaced. Returns ``(new_generation, manifest_path)``."""
    gen, manifest = read_routing_manifest(checkpoint_dir)
    manifest = json.loads(json.dumps(manifest))  # deep copy, stays JSON-pure
    manifest["generation"] = gen + 1
    if policy not in manifest["policies"]:
        raise KeyError(f"unknown policy {policy!r}; manifest has "
                       f"{sorted(manifest['policies'])}")
    for c, sub in cluster_subdirs.items():
        manifest["policies"][policy][str(c)] = sub
    if station_norm:
        if "norm" not in manifest:
            raise ValueError("manifest has no 'norm' stats to update")
        for s, (mu, sd) in station_norm.items():
            manifest["norm"]["mu"][int(s)] = float(mu)
            manifest["norm"]["sd"][int(s)] = float(sd)
    path = _publish_manifest(checkpoint_dir, manifest)
    return gen + 1, path
