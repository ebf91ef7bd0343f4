"""Train→serve flywheel: drift-triggered per-cluster retraining that
publishes GENERATIONAL routing manifests for zero-drop hot-swap serving
(counterpart of ``repro.core.fl.flywheel``).

    fresh windows -> RetrainController.append_windows
    online RMSE   -> DriftDetector (trailing-quantile trigger, per cluster)
    trigger fires -> run_fl for JUST the drifted cluster (same
                     ExperimentSpec machinery and driver as training)
    new model     -> checkpoint under a generation-suffixed subdir +
                     tasks.update_routing_manifest publishes generation N+1
    serving       -> ForecastServer.reload / watch_manifest hot-swaps to the
                     new generation without dropping a request

Both triggers are here: DRIFT (``observe`` + ``step``) and TIMER
(``start_timer``: periodic retraining on a background thread).

Same triggers, retrained clusters, generations, manifests and keys as the
reference: the key of cluster ``c`` at generation ``g`` is
``fold_in(PRNGKey(seed + c), g)`` from ``repro_torch.random``, bitwise
``jax.random.fold_in``.

On the card a retrain runs on the controller's own CUDA stream, whichever
thread calls it (the caller's, the timer's): the current stream is per
thread in PyTorch, so it is set here rather than inherited. A server on the
same card serves on its own stream meanwhile (``repro_torch.launch.
serve_forecast``), also while the ``while`` driver captures its CUDA graphs
(in ``thread_local`` mode). Retrains never overlap on one device: each
takes its controller's lock (the drift path and the timer share it) and
then the lock of every device it runs on (its device, or with
``spec.shard_clients`` every device of the client mesh), which every
controller on that device shares. These keep two runs of the psgf_mix
kernel apart: its ticket counter is one per stream, a CUDA graph holds the
counter of the stream it was captured on, and torch hands out streams from
a pool, so two controllers' streams may be one.

Usage::

    ctl = RetrainController(spec, ckpt_root, series=series, server=server,
                            device="cuda")
    server.watch_manifest(interval_s=2.0)
    ctl.append_windows(new_columns)               # fresh (K, t) observations
    rep = stream_evaluate(server, spec.task, series=ctl.series)
    result = ctl.step(rep)                        # retrains drifted clusters
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device

_DEVICE_LOCKS: Dict[tuple, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_key(dev: torch.device) -> tuple:
    """``cuda`` and ``cuda:<current device>`` are one device."""
    index = dev.index
    if index is None and dev.type == "cuda":
        index = torch.cuda.current_device()
    return dev.type, -1 if index is None else index


@contextlib.contextmanager
def _device_lock(*devices: torch.device):
    """Hold the lock that every controller's retrains on each of ``devices``
    take, taken in one order so that two retrains never wait on each other
    crosswise."""
    with _DEVICE_LOCKS_GUARD:
        locks = [_DEVICE_LOCKS.setdefault(key, threading.Lock())
                 for key in sorted({_device_key(d) for d in devices})]
    with contextlib.ExitStack() as stack:
        for lock in locks:
            stack.enter_context(lock)
        yield


class DriftDetector:
    """Per-cluster trailing-quantile drift trigger over online RMSE.

    Each cluster keeps its last ``window + 1`` online-RMSE observations. A
    cluster has DRIFTED when its latest observation exceeds ``tolerance *
    quantile(baseline, q)``, the baseline being the trailing history
    WITHOUT the latest point. ``min_obs`` baseline points are required
    before the trigger can fire, NaN readings are ignored, and
    :meth:`reset` clears a cluster's history after its retrain."""

    def __init__(self, window: int = 16, quantile: float = 0.9,
                 tolerance: float = 1.25, min_obs: int = 3):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        if tolerance <= 0 or window < 2 or min_obs < 1:
            raise ValueError(
                f"need tolerance > 0, window >= 2, min_obs >= 1; got "
                f"{tolerance}, {window}, {min_obs}")
        self.window = int(window)
        self.quantile = float(quantile)
        self.tolerance = float(tolerance)
        self.min_obs = int(min_obs)
        self._history: Dict[object, deque] = {}
        self._lock = threading.Lock()

    def record(self, cluster, rmse: float):
        if not np.isfinite(rmse):
            return  # an empty/unroutable replay must not poison the baseline
        with self._lock:
            self._history.setdefault(
                cluster, deque(maxlen=self.window + 1)).append(float(rmse))

    def threshold(self, cluster) -> Optional[float]:
        """The current trigger level for ``cluster`` (None while the
        baseline is still warming up)."""
        with self._lock:
            h = self._history.get(cluster)
            if h is None or len(h) < self.min_obs + 1:
                return None
            baseline = list(h)[:-1]
        return self.tolerance * float(np.quantile(baseline, self.quantile))

    def drifted(self, cluster) -> bool:
        thr = self.threshold(cluster)
        if thr is None:
            return False
        with self._lock:
            latest = self._history[cluster][-1]
        return latest > thr

    def drifted_clusters(self):
        with self._lock:
            clusters = list(self._history)
        return [c for c in clusters if self.drifted(c)]

    def reset(self, cluster):
        with self._lock:
            self._history.pop(cluster, None)


class RetrainController:
    """The write side of the flywheel: owns the LIVE series, retrains one
    cluster at a time through the ``ExperimentSpec`` that trained generation
    0, and publishes each retrain as manifest generation N+1.

    Only the retrained clusters' state moves between generations: untouched
    clusters keep their checkpoint subdir (so ``ForecastServer.reload``
    reuses their live engines) and their stations keep their norm stats.

    ``device`` (default the card; raises without one unless ``"cpu"``) is
    where retrains run; it is resolved again by each :meth:`retrain`."""

    def __init__(self, spec, checkpoint_root: str,
                 series: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None,
                 server=None,
                 detector: Optional[DriftDetector] = None,
                 policy: Optional[str] = None,
                 reload_server: bool = True,
                 warm_start: bool = True,
                 verbose: bool = False,
                 device=DEFAULT_DEVICE):
        from repro_torch.core.tasks import read_routing_manifest, run_name

        self.device = resolve_device(device)
        self.spec = spec
        self.checkpoint_root = checkpoint_root
        self.series = np.asarray(series if series is not None
                                 else spec.task.series())
        self.labels = np.asarray(
            labels if labels is not None
            else spec.task.cluster_labels(self.series, device=self.device))
        self.server = server
        self.detector = detector or DriftDetector()
        self.reload_server = reload_server
        self.warm_start = warm_start
        self.verbose = verbose
        # one grid entry drives retraining; default: the spec's only entry
        if policy is None:
            if len(spec.grid) != 1:
                raise ValueError(
                    f"spec has {len(spec.grid)} grid entries; pass policy=")
            policy = run_name(*spec.grid[0])
        self.policy = policy
        self._grid_entry = None
        for name, overrides in spec.grid:
            if run_name(name, overrides) == policy:
                self._grid_entry = (name, overrides)
        if self._grid_entry is None:
            raise KeyError(f"policy {policy!r} not in the spec grid "
                           f"({[run_name(*g) for g in spec.grid]})")
        # sanity: the manifest must exist (generation 0 trained already)
        read_routing_manifest(checkpoint_root)
        self._lock = threading.Lock()   # serializes retrain/publish
        self._stream = None             # the retrains' stream, made on first use
        self._timer: Optional[threading.Thread] = None
        self._timer_stop: Optional[threading.Event] = None

    # ---- live data --------------------------------------------------------
    def append_windows(self, new_obs: np.ndarray):
        """Append fresh observations — ``(K, t)`` new columns, one row per
        station of the ORIGINAL fleet — to the live series; the next retrain
        of any cluster trains (and recomputes norm stats) on the grown
        series."""
        new_obs = np.asarray(new_obs)
        if new_obs.ndim != 2 or new_obs.shape[0] != self.series.shape[0]:
            raise ValueError(
                f"new observations must be (num_stations="
                f"{self.series.shape[0]}, t), got {new_obs.shape}")
        with self._lock:
            self.series = np.concatenate(
                [self.series, new_obs.astype(self.series.dtype)], axis=1)
        return self.series.shape

    # ---- drift trigger ----------------------------------------------------
    def observe(self, report: dict):
        """Feed one round of online RMSE into the drift detector and return
        the clusters whose trigger fired. ``report`` is either a
        ``stream_evaluate`` report (``{"per_cluster": {c: {"rmse": ...}}}``)
        or a plain ``{cluster: rmse}`` dict."""
        per_cluster = report.get("per_cluster", report)
        for c, v in per_cluster.items():
            rmse = v["rmse"] if isinstance(v, dict) else float(v)
            self.detector.record(c, rmse)
        return self.detector.drifted_clusters()

    # ---- retraining -------------------------------------------------------
    def _on_stream(self, dev: torch.device):
        """This controller's stream on the card (the calling thread's
        current stream is not assumed), nothing on the CPU."""
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        return torch.cuda.stream(self._stream)

    def retrain(self, clusters: Sequence) -> dict:
        """Re-run ``run_fl`` for EXACTLY the given clusters on the current
        series and publish ONE new manifest generation covering them all.

        Per cluster: rebuild its clients' datasets from the live series,
        run the spec's FL config and driver with the key
        ``fold_in(PRNGKey(seed + c), generation)``, WARM-STARTED from the
        cluster's live checkpoint unless ``warm_start=False``, checkpoint the
        new global model under ``<policy>_c<cluster>_g<generation>`` and
        stage its subdir and its stations' new norm stats. Then one
        ``update_routing_manifest`` call publishes them, the detector forgets
        those clusters and the attached server reloads. Returns
        ``{"generation", "rows": {cluster: row}}``."""
        from repro_torch.core.fl.engine import run_fl
        from repro_torch.core.forecaster import load_forecaster
        from repro_torch.core.tasks import (read_routing_manifest,
                                            update_routing_manifest)
        from repro_torch.data.windowing import series_norm_stats
        from repro_torch.launch.mesh import make_client_mesh

        if not clusters:
            raise ValueError("no clusters to retrain")
        dev = resolve_device(self.device)
        spec, task = self.spec, self.spec.task
        policy_name, overrides = self._grid_entry
        devices = (make_client_mesh(device=dev).devices
                   if spec.shard_clients else (dev,))
        with self._lock, _device_lock(*devices):
            series = self.series
            current_gen, manifest = read_routing_manifest(self.checkpoint_root)
            generation = current_gen + 1
            subdirs, norm_updates, rows = {}, {}, {}
            for c in clusters:
                idx = (None if c is None
                       else np.nonzero(self.labels == c)[0])
                if idx is not None and len(idx) < task.min_cluster_clients:
                    raise ValueError(
                        f"cluster {c} has {len(idx)} clients < "
                        f"min_cluster_clients={task.min_cluster_clients}")
                tr, va, te, info = task.client_data(
                    series, idx, streaming=spec.streaming_windows)
                fl_cfg = spec.fl_config(policy_name, tr.shape[0], overrides)
                key = R.fold_in(R.PRNGKey(spec.seed + (c or 0)), generation)
                sub = f"{self.policy}_c{c or 0}_g{generation}"
                t0 = time.time()
                with self._on_stream(dev):
                    init_params = None
                    if self.warm_start:
                        live = manifest["policies"][self.policy].get(str(c or 0))
                        if live is not None:
                            _, init_params, _ = load_forecaster(
                                os.path.join(self.checkpoint_root, live),
                                device=dev)
                    hist = run_fl(
                        spec.model.cfg, fl_cfg, tr, te, key,
                        max_rounds=spec.max_rounds, patience=spec.patience,
                        eval_every=spec.eval_every, driver=spec.driver,
                        shard_clients=spec.shard_clients, verbose=self.verbose,
                        checkpoint_dir=f"{self.checkpoint_root}/{sub}",
                        init_params=init_params, device=dev)
                    if self._stream is not None:
                        self._stream.synchronize()
                subdirs[str(c or 0)] = sub
                if idx is not None:
                    mu, sd = series_norm_stats(series[idx])
                    for s, m, d in zip(idx.tolist(), mu.ravel(), sd.ravel()):
                        norm_updates[s] = (float(m), float(d))
                rows[c] = {
                    "policy": self.policy, "cluster": c,
                    "clients": int(tr.shape[0]),
                    "rounds": int(hist["rounds_run"]),
                    "rmse": float(hist["final_rmse"]),
                    "comm_params": float(hist["final_comm"]),
                    "train_s": round(time.time() - t0, 2),
                    "generation": generation,
                }
                if "while_run" in hist:   # the while driver's set-up record
                    rows[c]["while_run"] = hist["while_run"]
            gen, _ = update_routing_manifest(
                self.checkpoint_root, self.policy, subdirs,
                station_norm=norm_updates or None)
        for c in clusters:
            self.detector.reset(c)
        if self.server is not None and self.reload_server:
            self.server.reload()
        return {"generation": gen, "rows": rows}

    def step(self, report: Optional[dict] = None) -> dict:
        """ONE drift-driven flywheel turn: record the online RMSE report,
        retrain every cluster whose trigger fired, publish the new
        generation, hot-swap the attached server. Returns ``{"drifted":
        [...], "retrained": {cluster: row}, "generation"}`` (generation
        unchanged when nothing fired)."""
        from repro_torch.core.tasks import read_routing_manifest

        drifted = self.observe(report) if report is not None else \
            self.detector.drifted_clusters()
        out = {"drifted": list(drifted), "retrained": {},
               "generation": read_routing_manifest(self.checkpoint_root)[0]}
        if drifted:
            res = self.retrain(drifted)
            out["retrained"] = res["rows"]
            out["generation"] = res["generation"]
        return out

    # ---- timer trigger ----------------------------------------------------
    def start_timer(self, interval_s: float,
                    clusters: Optional[Sequence] = None):
        """The TIMER trigger: a daemon thread retrains ``clusters`` (default:
        every cluster in the manifest's policy map) every ``interval_s``
        seconds on whatever windows have been appended by then. Idempotent;
        stop with :meth:`stop_timer`."""
        from repro_torch.core.tasks import read_routing_manifest

        if self._timer is not None:
            return self._timer
        if clusters is None:
            _, manifest = read_routing_manifest(self.checkpoint_root)
            clusters = sorted(int(k)
                              for k in manifest["policies"][self.policy])
        self._timer_stop = threading.Event()

        def _tick():
            while not self._timer_stop.wait(interval_s):
                try:
                    self.retrain(list(clusters))
                except Exception:
                    pass  # a failed refresh retries next tick

        self._timer = threading.Thread(target=_tick, daemon=True,
                                       name="flywheel-timer")
        self._timer.start()
        return self._timer

    def stop_timer(self):
        if self._timer is None:
            return
        self._timer_stop.set()
        self._timer.join()
        self._timer = None
        self._timer_stop = None
