"""Forecasting tasks, experiment specs and the generational routing
manifest (counterpart of ``repro.core.tasks``): the one assembly path from
dataset to trained, servable per-cluster forecasters.

  * :class:`ForecastTask` — a dataset workload by name (``ev``, ``nn5``,
    ``household``) with the paper's look-back/horizon defaults,
    ``quick``/``full`` presets and DTW k-medoids clustering
    (``get_task("ev", quick=False, clusters=3)``);
  * :class:`ExperimentSpec` + :func:`run_experiment` — per grid entry and per
    cluster, ``run_fl`` with key ``PRNGKey(seed + cluster)``, a checkpoint
    per trained global model and the routing manifest;
  * the routing manifest that ``ForecastServer.from_manifest`` serves:
    :func:`write_routing_manifest`, :func:`update_routing_manifest`,
    :func:`read_routing_manifest`, :func:`manifest_generations`, writing and
    reading the same ``routing.json`` / ``routing.g<N>.json`` JSON as the
    reference, so either package serves the other's manifests.

CLI: ``python -m repro_torch.core.tasks --device cuda`` (``--device cpu``
without a GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch import random as R
from repro_torch.checkpoint.checkpoint import atomic_write_json
from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.core.fl.engine import FLConfig, run_fl
from repro_torch.core.forecaster import Forecaster, get_forecaster
from repro_torch.data.clustering import cluster_clients
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

    def cluster_labels(self, series: np.ndarray,
                       device=DEFAULT_DEVICE) -> np.ndarray:
        """Per-client cluster labels (DTW on ``device``); all-zeros when
        clustering is off."""
        if self.clusters <= 0:
            return np.zeros(series.shape[0], np.int64)
        labels, _ = cluster_clients(series, self.clusters,
                                    seed=self.cluster_seed, device=device)
        return labels

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


def register_task(name: str, quick: ForecastTask, full: ForecastTask):
    """Add a workload's ``quick`` and ``full`` presets under ``name``."""
    _TASKS[name] = {"quick": quick, "full": full}


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
# experiments: task x model x FL grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything :func:`run_experiment` needs (the reference's fields and
    defaults); grid entries are ``(policy_name, fl_overrides)`` pairs
    layered over the shared knobs (overrides reach every ``FLConfig``
    field, e.g. ``use_pallas_mix``). ``driver`` is any of ``run_fl``'s:
    ``"scan"`` (default), ``"loop"``, ``"while"`` (CUDA-graph chunks with
    the stop on the device) or ``"host"`` (the client state in pinned host
    memory; needs ``streaming_windows``). ``shard_clients`` passes through
    to ``run_fl``: the client axis over every local GPU of this process (a
    local mesh, one shard a GPU), the unsharded run on one device."""

    task: ForecastTask
    model: Forecaster
    grid: Tuple[Tuple[str, dict], ...] = (("psgf", {}),)
    select_ratio: float = 0.5     # paper: 50% for all methods
    local_steps: int = 4
    batch_size: int = 32
    max_rounds: int = 300
    patience: int = 10
    eval_every: int = 10
    seed: int = 0                 # run key: PRNGKey(seed + cluster)
    driver: str = "scan"
    shard_clients: bool = False
    streaming_windows: bool = False
    participation: Optional[float] = None

    def fl_config(self, policy: str, num_clients: int, overrides: dict) -> FLConfig:
        kw = dict(policy=policy, num_clients=num_clients,
                  select_ratio=self.select_ratio, local_steps=self.local_steps,
                  batch_size=self.batch_size,
                  streaming_windows=self.streaming_windows,
                  participation=self.participation)
        kw.update(overrides)
        return FLConfig(**kw)


def run_name(policy: str, overrides: dict) -> str:
    """Grid-row label, the reference's spelling (``psgf-s30-f20``)."""
    name = policy
    if policy != "online":
        name += f"-s{int(overrides.get('share_ratio', FLConfig.share_ratio) * 100)}"
    if policy == "psgf":
        name += f"-f{int(overrides.get('forward_ratio', FLConfig.forward_ratio) * 100)}"
    return name


def run_experiment(spec: ExperimentSpec, checkpoint_dir: Optional[str] = None,
                   on_row=None, verbose: bool = False,
                   series: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None,
                   device=DEFAULT_DEVICE) -> dict:
    """Drive the grid on ``device``. Per grid entry and per cluster (pooled
    when ``task.clusters == 0``): window the cluster's clients, build the
    ``FLConfig`` and call ``run_fl`` with key ``PRNGKey(seed + cluster)``.

    Returns ``{"task", "model", "cluster_sizes", "rows"}``; each row has
    ``policy``, ``cluster`` (None when pooled), ``clients``, ``rounds``,
    ``rmse``, ``comm_params``, ``comm_bytes`` and ``train_s``. With
    ``checkpoint_dir`` each trained global model is saved under
    ``<dir>/<policy>[_c<cluster>]`` and the routing manifest is written at
    ``<dir>/routing.json`` (``result["routing_manifest"]``).
    ``series``/``labels`` take precomputed data and cluster assignments."""
    task, model = spec.task, spec.model
    if series is None:
        series = task.series()
    if labels is None:
        labels = task.cluster_labels(series, device=device)
    clustered = task.clusters > 0
    groups = list(range(task.clusters)) if clustered else [None]

    rows = []
    for policy, overrides in spec.grid:
        label = run_name(policy, overrides)
        for c in groups:
            idx = None if c is None else np.nonzero(labels == c)[0]
            if idx is not None and len(idx) < task.min_cluster_clients:
                continue
            tr, va, te, info = task.client_data(
                series, idx, streaming=spec.streaming_windows)
            fl_cfg = spec.fl_config(policy, tr.shape[0], overrides)
            t0 = time.time()
            hist = run_fl(model.cfg, fl_cfg, tr, te, R.PRNGKey(spec.seed + (c or 0)),
                          max_rounds=spec.max_rounds,
                          patience=spec.patience, eval_every=spec.eval_every,
                          driver=spec.driver, shard_clients=spec.shard_clients,
                          verbose=verbose, device=device,
                          checkpoint_dir=None if checkpoint_dir is None else
                          f"{checkpoint_dir}/{label}" +
                          ("" if c is None else f"_c{c}"))
            row = {
                "policy": label,
                "cluster": c,
                "clients": int(tr.shape[0]),
                "rounds": int(hist["rounds_run"]),
                "rmse": float(hist["final_rmse"]),
                "comm_params": float(hist["final_comm"]),
                "comm_bytes": float(hist["final_comm_bytes"]),
                "train_s": round(time.time() - t0, 1),
            }
            rows.append(row)
            if on_row is not None:
                on_row(row)
    result = {
        "task": task.name,
        "model": model.name,
        "cluster_sizes": np.bincount(labels, minlength=max(task.clusters, 1)).tolist(),
        "rows": rows,
    }
    if checkpoint_dir is not None:
        result["routing_manifest"] = write_routing_manifest(
            checkpoint_dir, task, model, labels, rows, series=series)
    return result


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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train the per-cluster forecasters of a task under FL")
    ap.add_argument("--task", default="ev", choices=task_names())
    ap.add_argument("--model", default="logtst")
    ap.add_argument("--quick", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--clusters", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    task = get_task(args.task, quick=args.quick, clusters=args.clusters)
    spec = ExperimentSpec(
        task=task, model=task_forecaster(task, args.model, quick=args.quick),
        grid=(("online", {}), ("psgf", {})), max_rounds=args.rounds,
        batch_size=16, eval_every=min(10, args.rounds))
    res = run_experiment(spec, checkpoint_dir=args.ckpt_dir, device=args.device,
                         on_row=lambda r: print(
                             f"{r['policy']:14s} cluster={r['cluster']} "
                             f"rounds={r['rounds']:3d} rmse={r['rmse']:.4f} "
                             f"comm={r['comm_params']:.3e}"))
    print(f"task={res['task']} model={res['model']} "
          f"cluster_sizes={res['cluster_sizes']}")


if __name__ == "__main__":
    main()
