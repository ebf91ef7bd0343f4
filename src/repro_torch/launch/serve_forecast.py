"""Forecast serving endpoint: restore federated checkpoints and serve them
(counterpart of ``repro.launch.serve_forecast``).

The deployable artifact of the paper's system is the trained global
forecaster, one per DTW cluster of charging stations. This module turns
those checkpoints (``load_forecaster`` format, written by either package)
plus the routing manifest into a batched, routed inference endpoint:

  * each cluster engine runs ``forward_multivariate`` under
    ``torch.inference_mode`` into a PREALLOCATED per-``(bucket, channels)``
    output tensor on the server's device — the counterpart of the
    reference's jitted step with donated output buffers; on the card every
    forward runs on the server's own high-priority CUDA stream through
    pinned staging buffers and waits on its own event, so serving goes on
    beside training in another thread (a flywheel retrain, its CUDA-graph
    capture included) without queueing behind it;
  * ragged request batches are padded up to a small set of SHAPE BUCKETS
    (powers of two up to ``max_batch``), so the set of shapes the device
    sees stays bounded whatever batch sizes arrive;
  * one server restores N per-cluster checkpoints
    (:meth:`ForecastServer.from_manifest`) and routes every request by its
    station's cluster label; the micro-batching worker coalesces the queue
    per (generation, cluster, shape) group;
  * ``comm_bits=16`` / ``8`` restore bf16 / int8 + per-leaf-scale quantized
    payloads (``repro_torch.checkpoint.quantize_tree``);
  * :func:`stream_evaluate` replays held-out ``ForecastTask`` windows
    through the queue and tracks per-cluster online RMSE;
  * every server carries a ``repro_torch.launch.metrics.MetricsRegistry``
    with the reference's metric families (``metrics=False`` opts out);
  * :meth:`ForecastServer.close` fails every pending future and everything
    submitted afterwards (``stop()`` is the pausable variant);
  * the routing state lives in one swappable generation snapshot:
    :meth:`ForecastServer.reload` restores a newer manifest generation's
    changed clusters, warms them off the serving path and publishes them
    with one attribute store (queued requests drain through the engines
    they were admitted under); :meth:`ForecastServer.watch_manifest` polls.

The server's ``device`` defaults to ``"cuda"`` and raises without a GPU
unless the caller passes ``device="cpu"``. With ``use_flash_attn=True``
checkpoints the attention block runs the CUDA flash-attention kernel, one
launch per bucket forward for LoGTST. ``shard_batch=True`` splits each
bucket that the batch mesh's shards divide
(``repro_torch.launch.mesh.make_batch_mesh``: every local GPU) into equal
blocks, one a shard, each on its shard's device and stream; other buckets
run whole on the first shard; on one device it is the unsharded server.
Across processes, ``from_manifest(process_shard=...)`` restores each
process's own clusters.

Manifest format: see ``repro_torch.core.tasks.write_routing_manifest``.

CLI (restore + synthetic load, reports forecasts/sec):

  PYTHONPATH=src python -m repro_torch.launch.serve_forecast --manifest ROOT \
      [--policy P] [--comm-bits 16] [--denormalize] [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve_forecast --ckpt-dir CKPT
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import atomic_write_bytes
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import (DEFAULT_DEVICE, normalized,
                                       resolve_device)
from repro_torch.core.forecast import forward_multivariate
from repro_torch.core.forecaster import Forecaster, load_forecaster
from repro_torch.launch.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry

_STOP = object()
_NO_DEFAULT = object()  # multi-cluster servers have no default route


def _safe_set(fut: Future, result=None, exc: Optional[BaseException] = None):
    """Resolve a waiter that may ALREADY be done (a caller can cancel a
    queued future); a late result for it is discarded instead of raising
    out of the worker loop."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch``."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class _Slot:
    """The static buffers of one ``(bucket, channels)`` forward on the card:
    pinned host staging for the input and the result, the device input and
    output, and the event the host waits on."""

    __slots__ = ("host_in", "host_out", "dev_in", "dev_out", "done")

    def __init__(self, bucket: int, M: int, L: int, H: int,
                 device: torch.device):
        self.host_in = torch.empty((bucket, M, L), dtype=torch.float32,
                                   pin_memory=True)
        self.host_out = torch.empty((bucket, M, H), dtype=torch.float32,
                                    pin_memory=True)
        self.dev_in = torch.empty((bucket, M, L), dtype=torch.float32,
                                  device=device)
        self.dev_out = torch.empty((bucket, M, H), dtype=torch.float32,
                                   device=device)
        self.done = torch.cuda.Event()


class _ClusterEngine:
    """One restored model's inference machinery: its params, moved to the
    server's device once, and its per-(bucket, channels) buffers. The routed
    server holds one engine per cluster; the single-model server is the
    one-engine case, so both run exactly the same step.

    On the card every step runs on the server's own ``stream`` through
    static buffers (:class:`_Slot`: pinned host staging, device input and
    output), allocated by the first step of each shape (the server's
    warm-up; a reloaded engine's, at the channel counts the server warmed),
    and the host waits on the step's own event only. So a step neither
    queues behind nor synchronizes with work that another thread has put on
    the card (training, a CUDA-graph capture in ``thread_local`` mode), and
    makes no pageable copy and no allocation of its own for a warmed
    shape.

    Over a batch mesh (``shards``: ``(device, stream)`` of each shard, the
    first the server's own) the params are on every shard's device, once a
    device, and a bucket that the shards divide runs as equal blocks, block
    ``i`` on shard ``i``'s device and stream through its own buffers; the
    host waits on every shard's event. Any other bucket runs whole on the
    first shard."""

    def __init__(self, forecaster: Forecaster, params, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None, shards=None):
        self.forecaster = forecaster
        self.device = device
        self.stream = stream
        self.shards = tuple(shards) if shards else ((device, stream),)
        on_device, self._params = {}, []
        for dev, s in self.shards:
            key = str(normalized(dev))
            if key not in on_device:
                on_device[key] = pt.tree_map(lambda t: t.to(dev), params)
            self._params.append(on_device[key])
            if s is not None:
                # the params were written on this thread's current stream
                s.wait_stream(torch.cuda.current_stream(dev))
        self.params = self._params[0]
        # (rows, channels) on the first shard, (rows, channels, shard) on
        # the others -> free buffers, taken out while a step uses them
        self._free: Dict[tuple, list] = {}

    def _take(self, shard: int, key, x_shape):
        try:
            return self._free.setdefault(key, []).pop()
        except IndexError:    # first step of this shape, or one in flight
            rows, M, L = x_shape
            H = self.forecaster.cfg.horizon
            device, stream = self.shards[shard]
            if device.type == "cuda":
                with torch.cuda.device(device), _on(stream):
                    return _Slot(rows, M, L, H, device)
            return torch.empty((rows, M, H), dtype=torch.float32)

    def _enqueue(self, shard: int, x: np.ndarray):
        """The forward of ``x`` on ``shard`` into its buffers (enqueued on
        its stream on the card, done on the CPU). Returns ``(key, buffers)``
        for :meth:`_collect`."""
        key = (x.shape[0], x.shape[1]) + ((shard,) if shard else ())
        slot = self._take(shard, key, x.shape)
        cfg, params = self.forecaster.cfg, self._params[shard]
        device, stream = self.shards[shard]
        if device.type != "cuda":
            slot.copy_(forward_multivariate(
                cfg, params, torch.from_numpy(np.asarray(x, np.float32))))
            return key, slot
        slot.host_in.numpy()[...] = x
        with torch.cuda.device(device), torch.cuda.stream(stream):
            slot.dev_in.copy_(slot.host_in, non_blocking=True)
            slot.dev_out.copy_(forward_multivariate(cfg, params, slot.dev_in))
            slot.host_out.copy_(slot.dev_out, non_blocking=True)
            slot.done.record(stream)
        return key, slot

    def _collect(self, key, slot, rows: int) -> np.ndarray:
        """The first ``rows`` rows of a forward :meth:`_enqueue` started,
        copied to the host before its buffers are put back."""
        if isinstance(slot, _Slot):
            slot.done.synchronize()
            result = slot.host_out[:rows].numpy().copy()
        else:
            result = slot[:rows].numpy().copy()
        self._free[key].append(slot)
        return result

    def run_padded(self, x: np.ndarray, rows: int) -> np.ndarray:
        """x: (bucket, M, L) already padded to a bucket size. Fills this
        shape's buffers and returns the first ``rows`` live rows COPIED to
        the host — the copy happens before the buffers are put back, where a
        concurrent caller (the worker thread and a warmup/predict from
        another thread) could take and overwrite them. Inference mode and
        the current stream are thread-local, so both are entered here, per
        call."""
        n = len(self.shards)
        with torch.inference_mode():
            if n > 1 and x.shape[0] % n == 0:
                block = x.shape[0] // n
                started = [self._enqueue(i, x[i * block:(i + 1) * block])
                           for i in range(n)]
                return np.concatenate([self._collect(key, slot, block)
                                       for key, slot in started])[:rows]
            return self._collect(*self._enqueue(0, x), rows)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _Generation:
    """One immutable ROUTING SNAPSHOT: per-cluster engines, the
    station->cluster table, the per-station norm stats and the generation
    number they were published under. The server swaps whole snapshots with
    one attribute store; queued requests carry a reference to theirs."""

    __slots__ = ("generation", "engines", "station_cluster", "station_norm",
                 "default", "sources")

    def __init__(self, generation: int, engines: Dict,
                 station_cluster=None, station_norm=None,
                 sources: Optional[Dict] = None):
        self.generation = int(generation)
        self.engines = engines
        self.station_cluster = (None if station_cluster is None
                                else [int(c) for c in station_cluster])
        # (mu, sd) per station: when set, station-routed requests are RAW
        self.station_norm = None
        if station_norm is not None:
            mu, sd = station_norm
            self.station_norm = (np.asarray(mu, np.float32).ravel(),
                                 np.asarray(sd, np.float32).ravel())
        self.default = (next(iter(engines))
                        if len(engines) == 1 else _NO_DEFAULT)
        # cluster -> checkpoint subdir each engine was restored from: reload
        # keeps the live engine of a cluster whose subdir is unchanged
        self.sources = dict(sources or {})


class ForecastServer:
    """Batched, bucketed, micro-batching inference over one forecaster or a
    ROUTED family of per-cluster forecasters.

    Single model::

        ForecastServer(forecaster, params).predict(x)

    Multi-cluster routed::

        server = ForecastServer.from_manifest(ckpt_root)
        server.submit(x, station=17)     # routed by station 17's cluster
        server.predict(x, cluster=1)     # or routed explicitly
    """

    def __init__(self, forecaster: Optional[Forecaster] = None, params=None,
                 max_batch: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 2.0,
                 *,
                 models: Optional[Dict] = None,
                 station_cluster: Optional[Sequence[int]] = None,
                 station_norm: Optional[Tuple] = None,
                 shard_batch: bool = False,
                 metrics: bool = True,
                 generation: int = 0,
                 process_shard: Optional[Tuple[int, int]] = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.batch_mesh = None
        if shard_batch:
            from repro_torch.launch import mesh as mesh_lib

            mesh = mesh_lib.make_batch_mesh(device=self.device)
            if len(mesh.devices) > 1:
                if normalized(mesh.device) != normalized(self.device):
                    raise ValueError(f"ForecastServer(device={device!r}) but "
                                     f"the batch mesh's first device is "
                                     f"{mesh.device}")
                self.batch_mesh = mesh
        if process_shard is not None:
            idx, cnt = int(process_shard[0]), int(process_shard[1])
            if not (cnt >= 1 and 0 <= idx < cnt):
                raise ValueError(
                    f"process_shard must be (index, count) with "
                    f"0 <= index < count, got {process_shard}")
            process_shard = (idx, cnt)
        self.process_shard = process_shard
        if models is None:
            if forecaster is None or params is None:
                raise ValueError("pass (forecaster, params) or models=")
            models = {None: (forecaster, params)}
        self.buckets = tuple(sorted(set(buckets or batch_buckets(max_batch))))
        self.max_batch = self.buckets[-1]
        self.max_wait_ms = max_wait_ms
        # every forward of this server runs on its own high-priority stream
        # (see _ClusterEngine), whichever thread calls it
        self._stream = (torch.cuda.Stream(self.device, priority=-1)
                        if self.device.type == "cuda" else None)
        # the batch mesh's shards: the server's device and stream first, a
        # high-priority stream of its own for each other shard
        self._shards = None
        if self.batch_mesh is not None:
            self._shards = [(self.device, self._stream)] + [
                (d, torch.cuda.Stream(d, priority=-1)
                 if d.type == "cuda" else None)
                for d in self.batch_mesh.devices[1:]]
        self._gen = _Generation(
            generation,
            {c: _ClusterEngine(fc, p, self.device, self._stream, self._shards)
             for c, (fc, p) in models.items()},
            station_cluster=station_cluster, station_norm=station_norm)
        self._manifest_source: Optional[dict] = None  # set by from_manifest
        self._warm_channels: list = []   # channel counts warmup() has run
        self._reload_lock = threading.Lock()   # serializes builds + swaps
        # two-phase swap (process-sharded serving): the built-and-warmed
        # next generation announced but not yet published
        self._staged_gen: Optional[_Generation] = None
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_stop: Optional[threading.Event] = None
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "series_served": 0, "reloads": 0}
        self.cluster_stats = {c: {"requests": 0, "series_served": 0}
                              for c in self._gen.engines}
        self._queue: "queue.Queue" = queue.Queue()
        self._worker_thread: Optional[threading.Thread] = None
        self._closed = False
        self._lifecycle = threading.Lock()  # guards _closed vs enqueue
        self.metrics: Optional[MetricsRegistry] = None
        if metrics:
            self._init_metrics()

    # --- generation snapshot (views) --------------------------------------
    @property
    def generation(self) -> int:
        return self._gen.generation

    @property
    def engines(self) -> Dict:
        return self._gen.engines

    @property
    def station_cluster(self):
        return self._gen.station_cluster

    @property
    def station_norm(self):
        return self._gen.station_norm

    def _cluster_stats(self, cluster) -> dict:
        st = self.cluster_stats.get(cluster)
        if st is None:
            st = self.cluster_stats.setdefault(
                cluster, {"requests": 0, "series_served": 0})
        return st

    def _init_metrics(self):
        """Declare the serving metric families (the reference's names)."""
        m = self.metrics = MetricsRegistry()
        self._m_requests = m.counter(
            "forecast_requests_total",
            "submit() requests accepted into the micro-batch queue",
            ("cluster",))
        self._m_rejected = m.counter(
            "forecast_rejected_total",
            "submit() requests failed before enqueue (never dispatched)",
            ("kind",))
        self._m_latency = m.histogram(
            "forecast_latency_seconds",
            "submit() -> resolved-future latency",
            ("cluster",), buckets=DEFAULT_LATENCY_BUCKETS)
        self._m_batches = m.counter(
            "forecast_batches_total",
            "micro-batches dispatched to a cluster engine",
            ("cluster", "shape"))
        self._m_padded = m.counter(
            "forecast_padded_slots_total",
            "bucket slots padded (wasted) in dispatched micro-batches",
            ("cluster", "shape"))
        self._m_fill = m.histogram(
            "forecast_batch_fill",
            "live-row fraction of each dispatched bucket",
            ("cluster", "shape"),
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._m_series = m.counter(
            "forecast_series_served_total",
            "series (station-channels) forecast per cluster",
            ("cluster",))
        self._m_errors = m.counter(
            "forecast_dispatch_errors_total",
            "micro-batch dispatches that failed their whole group",
            ("cluster",))
        m.gauge("forecast_queue_depth",
                "requests waiting in the micro-batch queue",
                fn=self._queue.qsize)
        m.gauge("forecast_clusters", "restored cluster engines",
                fn=lambda: float(len(self.engines)))
        m.gauge("forecast_generation",
                "active routing-manifest generation",
                fn=lambda: float(self._gen.generation))
        if self.process_shard is not None:
            m.gauge("forecast_process_index",
                    "this server's shard index (process-sharded serving)",
                    fn=lambda: float(self.process_shard[0]))
            m.gauge("forecast_process_count",
                    "total serving processes the cluster set is sharded over",
                    fn=lambda: float(self.process_shard[1]))
        self._m_reloads = m.counter(
            "forecast_reloads_total",
            "manifest hot-swaps by outcome (swapped/stale/waiting/error)",
            ("outcome",))

    def metrics_text(self) -> str:
        """Prometheus text exposition of the server registry; empty with
        ``metrics=False``."""
        return "" if self.metrics is None else self.metrics.expose()

    # --- restore ----------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: Optional[int] = None,
                        comm_bits: int = 32, device=DEFAULT_DEVICE,
                        **kw) -> "ForecastServer":
        """Single-model server from one ``load_forecaster`` checkpoint."""
        dev = resolve_device(device)
        fc, params, _ = load_forecaster(ckpt_dir, step=step,
                                        comm_bits=comm_bits, device=dev)
        return cls(fc, params, device=dev, **kw)

    @classmethod
    def from_manifest(cls, ckpt_root: str, policy: Optional[str] = None,
                      step: Optional[int] = None, comm_bits: int = 32,
                      denormalize: bool = False,
                      process_shard: Optional[Tuple[int, int]] = None,
                      device=DEFAULT_DEVICE,
                      **kw) -> "ForecastServer":
        """ROUTED server from a routing manifest: restores every cluster
        checkpoint of ``policy`` (the manifest's only policy by default) and
        routes requests via its ``station_cluster`` table.

        ``denormalize=True`` loads the manifest's per-station ``norm`` stats,
        so station-routed requests are served in RAW units (look-back
        normalized in, forecast rescaled out); requests routed by explicit
        ``cluster=`` stay in normalized units.

        ``process_shard=(index, count)`` restores only the clusters at sorted
        positions ``i % count == index`` (one member of a process-sharded
        fleet); :meth:`reload` then swaps generations two-phase across it."""
        from repro_torch.core.tasks import read_routing_manifest

        dev = resolve_device(device)
        generation, manifest = read_routing_manifest(ckpt_root)
        if denormalize and "norm" not in manifest:
            raise ValueError(
                "denormalize=True but the manifest has no 'norm' stats — "
                "write it with write_routing_manifest(..., series=...) to "
                "record per-station normalization")
        policy, models, sources = cls._restore_generation(
            ckpt_root, manifest, policy, step, comm_bits, dev,
            process_shard=process_shard)
        if denormalize:
            kw["station_norm"] = (manifest["norm"]["mu"],
                                  manifest["norm"]["sd"])
        server = cls(models=models,
                     station_cluster=manifest["station_cluster"],
                     generation=generation, process_shard=process_shard,
                     device=dev, **kw)
        server._gen.sources = sources
        server._manifest_source = dict(root=ckpt_root, policy=policy,
                                       step=step, comm_bits=comm_bits,
                                       denormalize=denormalize)
        return server

    @staticmethod
    def _restore_generation(ckpt_root: str, manifest: dict,
                            policy: Optional[str], step: Optional[int],
                            comm_bits: int, device: torch.device,
                            reuse: Optional[Dict] = None,
                            process_shard: Optional[Tuple[int, int]] = None):
        """Resolve the policy and restore its cluster checkpoints. With
        ``reuse`` (cluster -> (subdir, engine) of the live generation),
        clusters whose subdir is unchanged keep their engine. Returns
        ``(policy, models_or_engines, sources)``."""
        policies = manifest["policies"]
        if policy is None:
            if len(policies) != 1:
                raise ValueError(
                    f"manifest has {sorted(policies)}; pass policy=")
            policy = next(iter(policies))
        if policy not in policies:
            raise KeyError(f"unknown policy {policy!r}; "
                           f"manifest has {sorted(policies)}")
        out, sources = {}, {}
        entries = sorted(policies[policy].items(), key=lambda kv: int(kv[0]))
        for i, (label, sub) in enumerate(entries):
            if process_shard is not None and i % process_shard[1] != process_shard[0]:
                continue   # owned by another process of the serving fleet
            c = int(label)
            sources[c] = sub
            if reuse is not None and reuse.get(c, (None,))[0] == sub:
                out[c] = reuse[c][1]   # unchanged checkpoint: keep the engine
                continue
            fc, params, _ = load_forecaster(os.path.join(ckpt_root, sub),
                                            step=step, comm_bits=comm_bits,
                                            device=device)
            out[c] = (fc, params)
        return policy, out, sources

    # --- manifest hot-swap ------------------------------------------------
    @staticmethod
    def _ready_marker(root: str, generation: int, index: int) -> str:
        """``<root>/.ready.g<generation>.p<index>``: process ``index`` has
        built and warmed ``generation`` (phase one of the two-phase swap)."""
        return os.path.join(root, f".ready.g{generation:06d}.p{index}")

    def reload(self, warm_channels: Optional[Sequence[int]] = None,
               sync_timeout_s: float = 30.0) -> bool:
        """Hot-swap to the manifest's latest complete generation without
        dropping a request. Returns True if a newer generation was
        published, False if the manifest is at (or behind) the active one.

        Changed clusters are restored and their buckets warmed against the
        NEW snapshot off the serving path, at ``warm_channels`` (default:
        every channel count :meth:`warmup` has run, else 1), so requests of
        those shapes find their buffers built; unchanged clusters keep their
        engine. Then one attribute store publishes it: queued requests drain
        through the engines they were admitted under. On a process-sharded
        server the swap waits (up to ``sync_timeout_s``) for every peer's
        ready marker, keeping the built generation staged meanwhile."""
        src = self._manifest_source
        if src is None:
            raise RuntimeError(
                "reload() needs a manifest-backed server "
                "(ForecastServer.from_manifest)")
        from repro_torch.core.tasks import read_routing_manifest

        with self._reload_lock:
            generation, manifest = read_routing_manifest(src["root"])
            if generation <= self._gen.generation:
                if self.metrics is not None:
                    self._m_reloads.labels("stale").inc()
                return False
            if warm_channels is None:
                warm_channels = tuple(self._warm_channels) or (1,)
            staged = self._staged_gen
            if staged is not None and staged.generation == generation:
                new_gen = staged   # already built and warmed on a prior tick
            else:
                try:
                    with _on(self._stream):
                        new_gen = self._build_generation(
                            src, generation, manifest, warm_channels)
                except Exception:
                    if self.metrics is not None:
                        self._m_reloads.labels("error").inc()
                    raise
            if self.process_shard is not None and self.process_shard[1] > 1:
                if not self._announce_and_await(src["root"], generation,
                                                sync_timeout_s):
                    self._staged_gen = new_gen   # reuse next tick, no rebuild
                    if self.metrics is not None:
                        self._m_reloads.labels("waiting").inc()
                    return False
            self._gen = new_gen   # THE swap: one atomic attribute store
            self._staged_gen = None
            self.stats["reloads"] += 1
            if self.metrics is not None:
                self._m_reloads.labels("swapped").inc()
        return True

    def _build_generation(self, src: dict, generation: int, manifest: dict,
                          warm_channels: Sequence[int]) -> _Generation:
        old = self._gen
        reuse = {c: (old.sources.get(c), e) for c, e in old.engines.items()}
        _, restored, sources = self._restore_generation(
            src["root"], manifest, src["policy"], src["step"],
            src["comm_bits"], self.device, reuse=reuse,
            process_shard=self.process_shard)
        engines = {c: (v if isinstance(v, _ClusterEngine)
                       else _ClusterEngine(v[0], v[1], self.device,
                                           self._stream, self._shards))
                   for c, v in restored.items()}
        station_norm = None
        if src["denormalize"]:
            station_norm = (manifest["norm"]["mu"], manifest["norm"]["sd"])
        new_gen = _Generation(generation, engines,
                              station_cluster=manifest["station_cluster"],
                              station_norm=station_norm, sources=sources)
        fresh = [c for c, e in engines.items() if e is not old.engines.get(c)]
        for ch in warm_channels:
            for c in fresh:
                L = engines[c].forecaster.cfg.look_back
                for b in self.buckets:
                    self._run_bucket(np.zeros((b, ch, L), np.float32), c,
                                     new_gen)
        return new_gen

    def _announce_and_await(self, root: str, generation: int,
                            sync_timeout_s: float) -> bool:
        """Write this process's ready marker for ``generation``, then poll
        for every peer's. True once all exist, False on timeout."""
        idx, cnt = self.process_shard
        atomic_write_bytes(self._ready_marker(root, generation, idx),
                           json.dumps({"generation": generation,
                                       "process": idx}).encode())
        deadline = time.perf_counter() + sync_timeout_s
        while True:
            missing = [p for p in range(cnt)
                       if not os.path.exists(
                           self._ready_marker(root, generation, p))]
            if not missing:
                return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(min(0.05, sync_timeout_s / 10))

    def watch_manifest(self, interval_s: float = 2.0,
                       sync_timeout_s: float = 30.0):
        """Background poller: every ``interval_s`` seconds, :meth:`reload`
        if the manifest's generation moved. Restore errors are tallied
        (``forecast_reloads_total{outcome="error"}``) and retried next tick.
        Idempotent; stopped by :meth:`unwatch` or :meth:`close`."""
        if self._manifest_source is None:
            raise RuntimeError(
                "watch_manifest() needs a manifest-backed server "
                "(ForecastServer.from_manifest)")
        if self._watch_thread is not None:
            return self._watch_thread
        self._watch_stop = threading.Event()

        def _poll():
            while not self._watch_stop.wait(interval_s):
                try:
                    self.reload(sync_timeout_s=sync_timeout_s)
                except Exception:
                    pass  # already tallied as outcome="error"; retry next tick

        self._watch_thread = threading.Thread(
            target=_poll, daemon=True, name="manifest-watch")
        self._watch_thread.start()
        return self._watch_thread

    def unwatch(self):
        """Stop the :meth:`watch_manifest` poller (no-op when not running)."""
        if self._watch_thread is None:
            return
        self._watch_stop.set()
        self._watch_thread.join()
        self._watch_thread = None
        self._watch_stop = None

    # --- routing ----------------------------------------------------------
    @property
    def forecaster(self) -> Forecaster:
        """The first engine's forecaster (all clusters of one experiment
        share the config geometry)."""
        return next(iter(self.engines.values())).forecaster

    def resolve_cluster(self, station=None, cluster=None):
        """Explicit ``cluster`` wins; else ``station`` routes through the
        ``station_cluster`` table; else the single-model default. Raises for
        unroutable requests."""
        return self._resolve(self._gen, station=station, cluster=cluster)

    @staticmethod
    def _resolve(gen: _Generation, station=None, cluster=None):
        if cluster is None and station is not None:
            if gen.station_cluster is None:
                if gen.default is not _NO_DEFAULT:  # single model: no ambiguity
                    return gen.default
                raise ValueError(
                    "no routing table: build the server with from_manifest "
                    "(or station_cluster=) to route by station")
            s = int(station)
            if not 0 <= s < len(gen.station_cluster):
                raise KeyError(f"unknown station {s}: manifest covers "
                               f"{len(gen.station_cluster)} stations")
            cluster = gen.station_cluster[s]
        if cluster is None and None not in gen.engines:
            if gen.default is _NO_DEFAULT:
                raise ValueError(
                    "multi-cluster server: pass station= or cluster= "
                    f"(have {sorted(gen.engines, key=str)})")
            cluster = gen.default
        if cluster not in gen.engines:
            raise KeyError(f"no checkpoint for cluster {cluster!r} "
                           f"(have {sorted(gen.engines, key=str)})")
        return cluster

    @staticmethod
    def _norm_for_gen(gen: _Generation, station):
        """The (mu, sd) a station-routed RAW request is rescaled with, or
        None when raw serving is off or the request has no station."""
        if gen.station_norm is None or station is None:
            return None
        mu, sd = gen.station_norm
        s = int(station)
        if not 0 <= s < len(mu):
            raise KeyError(f"no normalization stats for station {s}: "
                           f"manifest covers {len(mu)} stations")
        return float(mu[s]), float(sd[s])

    def routable_stations(self):
        """Stations the routing table maps to a RESTORED engine; empty
        without a routing table."""
        if self.station_cluster is None:
            return []
        return [s for s, c in enumerate(self.station_cluster)
                if c in self.engines]

    # --- bucketed batch inference -----------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run_bucket(self, x: np.ndarray, cluster=None,
                    gen: Optional[_Generation] = None) -> np.ndarray:
        """x: (b, M, L) with b <= max_batch. Pads to the bucket, runs the
        cluster engine, unpads. ``gen`` pins the generation the request was
        admitted under; default is the current one."""
        gen = gen or self._gen
        b, M, L = x.shape
        cluster = self._resolve(gen, cluster=cluster)
        bucket = self.bucket_for(b)
        if b < bucket:
            x = np.concatenate(
                [x, np.zeros((bucket - b, M, L), np.float32)], axis=0)
        result = gen.engines[cluster].run_padded(x, b)
        self.stats["batches"] += 1
        self.stats["padded_slots"] += bucket - b
        self.stats["series_served"] += b * M
        self._cluster_stats(cluster)["series_served"] += b * M
        if self.metrics is not None:
            lbl = (str(cluster), f"{M}x{L}")
            self._m_batches.labels(*lbl).inc()
            self._m_padded.labels(*lbl).inc(bucket - b)
            self._m_fill.labels(*lbl).observe(b / bucket)
            self._m_series.labels(str(cluster)).inc(b * M)
        return result

    def predict(self, x, station=None, cluster=None) -> np.ndarray:
        """x: (b, M, L) for any b (chunked over max_batch) -> (b, M, T) from
        the routed cluster's model. With per-station norm stats loaded
        (``from_manifest(denormalize=True)``), a station-routed ``x`` is RAW;
        an explicit ``cluster=`` keeps the request in normalized units."""
        return self._predict(self._gen, x, station=station, cluster=cluster)

    def _predict(self, gen: _Generation, x, station=None,
                 cluster=None) -> np.ndarray:
        if cluster is not None:
            station = None  # explicit cluster: no station routing, no rescale
        cluster = self._resolve(gen, station=station, cluster=cluster)
        norm = self._norm_for_gen(gen, station)
        if norm is not None:
            mu, sd = norm
            y = self._predict(gen, (np.asarray(x, np.float32) - mu) / sd,
                              cluster=cluster)
            return y * sd + mu
        x = np.asarray(x, np.float32)
        if x.ndim == 2:  # single request (M, L)
            return self._predict(gen, x[None], cluster=cluster)[0]
        look_back = gen.engines[cluster].forecaster.cfg.look_back
        if x.ndim != 3 or x.shape[-1] != look_back:
            raise ValueError(
                f"batch must be (b, M, look_back={look_back}), got {x.shape}")
        outs = [self._run_bucket(x[i : i + self.max_batch], cluster, gen)
                for i in range(0, x.shape[0], self.max_batch)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def warmup(self, channels: int = 1, buckets: Optional[Sequence[int]] = None,
               gen: Optional[_Generation] = None):
        """Run every bucket of every cluster engine once (first-launch costs,
        kernel builds included, off the serving path). :meth:`reload` warms
        a new generation's engines at the same channel counts."""
        if channels not in self._warm_channels:
            self._warm_channels.append(channels)
        gen = gen or self._gen
        for c, eng in gen.engines.items():
            L = eng.forecaster.cfg.look_back
            for b in buckets or self.buckets:
                self._run_bucket(np.zeros((b, channels, L), np.float32), c,
                                 gen)

    # --- micro-batching request queue -------------------------------------
    def start(self):
        """Spawn the coalescing worker; ``submit`` becomes non-blocking."""
        if self._closed:
            raise RuntimeError("ForecastServer is closed")
        if self._worker_thread is not None:
            return
        self._worker_thread = threading.Thread(target=self._worker, daemon=True)
        self._worker_thread.start()

    def submit(self, x, station=None, cluster=None) -> Future:
        """Enqueue ONE request (M, L); resolves to its (M, T) forecast from
        the routed cluster's model (same units contract as :meth:`predict`).

        A malformed or unroutable request fails ONLY its own future: it never
        reaches the queue."""
        fut: Future = Future()
        gen = self._gen  # ONE snapshot read: route, norm and serve cohere
        try:
            if cluster is not None:
                station = None  # explicit cluster: no station stats
            cluster = self._resolve(gen, station=station, cluster=cluster)
            L = gen.engines[cluster].forecaster.cfg.look_back
            x = np.asarray(x, np.float32)
            if x.ndim != 2 or x.shape[1] != L:
                raise ValueError(
                    f"request must be (M, look_back={L}), got {x.shape}")
            norm = self._norm_for_gen(gen, station)
            if norm is not None:
                x = (x - norm[0]) / norm[1]
        except Exception as exc:  # incl. ragged/non-numeric asarray failures
            if self.metrics is not None:
                kind = ("unroutable" if isinstance(exc, KeyError)
                        else "malformed")
                self._m_rejected.labels(kind).inc()
            fut.set_exception(exc)
            return fut
        with self._lifecycle:
            # closed-check and enqueue are one atomic step, so a request can
            # never slip in between close() draining the queue and the flag
            if self._closed:
                fut.set_exception(RuntimeError(
                    "ForecastServer is closed; request was not enqueued"))
                return fut
            self.stats["requests"] += 1
            self._cluster_stats(cluster)["requests"] += 1
            if self.metrics is not None:
                self._m_requests.labels(str(cluster)).inc()
                lat = self._m_latency.labels(str(cluster))
                t0 = time.perf_counter()
                fut.add_done_callback(
                    lambda f, lat=lat, t0=t0: lat.observe(
                        time.perf_counter() - t0))
            # the queue item CARRIES its generation: a swap between enqueue
            # and dispatch serves it with the engines it was admitted under
            self._queue.put((gen, cluster, x, fut))
        if norm is None:
            return fut
        mu, sd = norm
        outer: Future = Future()

        def _rescale(f, outer=outer, mu=mu, sd=sd):
            if f.cancelled():
                outer.cancel()
                return
            exc = f.exception()
            if exc is not None:
                _safe_set(outer, exc=exc)
            else:
                _safe_set(outer, f.result() * sd + mu)

        fut.add_done_callback(_rescale)
        return outer

    def stop(self):
        """Pause the worker: it drains its current coalescing window, then
        exits; ``start()`` resumes."""
        if self._worker_thread is None:
            return
        self._queue.put(_STOP)
        self._worker_thread.join()
        self._worker_thread = None

    def close(self):
        """TERMINAL shutdown: stop the worker and fail every still-pending
        future with ``RuntimeError``; later submits fail the same way.
        Idempotent; ``predict`` keeps working."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
        self.unwatch()
        self.stop()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            _safe_set(item[3], exc=RuntimeError(
                "ForecastServer closed before this request was served"))

    def _run_group(self, items):
        """Serve one coalesced (generation, cluster, shape) group with the
        generation its requests were admitted under; a failure reaches this
        group's waiters only."""
        gen, cluster = items[0][0], items[0][1]
        try:
            ys = self._predict(gen, np.stack([x for _, _, x, _ in items]),
                               cluster=cluster)
            for (_, _, _, fut), y in zip(items, ys):
                _safe_set(fut, y)
        except Exception as exc:
            if self.metrics is not None:
                self._m_errors.labels(str(cluster)).inc()
            for _, _, _, fut in items:
                _safe_set(fut, exc=exc)

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            # the window coalesces per (generation, cluster, shape) group and
            # runs one bucket per group; a group that fills to max_batch
            # dispatches at once while the others keep coalescing until the
            # deadline or the window cap
            def key_of(it):
                return (it[0].generation, it[1], it[2].shape)

            groups: dict = {}
            groups.setdefault(key_of(item), []).append(item)
            total = 1
            cap = self.max_batch * max(1, len(self.engines))
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            stopping = False
            while total < cap:
                for k in [k for k, v in groups.items()
                          if len(v) >= self.max_batch]:
                    self._run_group(groups.pop(k))
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                groups.setdefault(key_of(nxt), []).append(nxt)
                total += 1
            for items in groups.values():
                self._run_group(items)
            if stopping:
                return


def serve_requests(server: ForecastServer, requests: int, channels: int,
                   seed: int = 0, use_queue: bool = True,
                   stations: Optional[Sequence[int]] = None) -> dict:
    """Push ``requests`` synthetic (M, L) queries through the server and
    report wall time + forecasts/sec (a forecast = one series' horizon).
    ``stations`` routes request i to ``stations[i % len(stations)]``."""
    L = server.forecaster.cfg.look_back
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((requests, channels, L)).astype(np.float32)
    sts = None if stations is None else [int(s) for s in stations]
    if sts is not None and not sts:
        raise ValueError(
            "stations is empty — no routable stations (every cluster in the "
            "manifest skipped or missing a checkpoint?)")
    station_of = (lambda i: None) if sts is None else (lambda i: sts[i % len(sts)])
    server.warmup(channels)
    base = dict(server.stats)  # exclude warmup batches from the report
    t0 = time.perf_counter()
    if use_queue:
        server.start()
        futs = [server.submit(x, station=station_of(i))
                for i, x in enumerate(xs)]
        ys = [f.result(timeout=60) for f in futs]
        server.stop()
    elif sts is None:
        ys = list(server.predict(xs))
    else:
        # direct routed mode: one batched predict per cluster
        ys = [None] * requests
        by_cluster: dict = {}
        for i in range(requests):
            c = server.resolve_cluster(station=station_of(i))
            by_cluster.setdefault(c, []).append(i)
        for c, idxs in by_cluster.items():
            out = server.predict(xs[idxs], cluster=c)
            for i, y in zip(idxs, out):
                ys[i] = y
    secs = time.perf_counter() - t0
    if len(ys) != requests or ys[0].shape != (channels, server.forecaster.cfg.horizon):
        raise RuntimeError(f"served {len(ys)} results of shape {ys[0].shape}")
    return {
        "requests": requests,
        "channels": channels,
        "seconds": secs,
        "forecasts_per_sec": requests * channels / secs,
        "batches": server.stats["batches"] - base["batches"],
        "padded_slots": server.stats["padded_slots"] - base["padded_slots"],
        "mode": "queue" if use_queue else "direct",
        "routed": sts is not None,
    }


def stream_evaluate(server: ForecastServer, task, series=None,
                    max_windows: Optional[int] = None,
                    timeout: Optional[float] = 120.0,
                    include_metrics: bool = False) -> dict:
    """Replay the task's HELD-OUT test windows through the micro-batching
    queue in arrival order (every station's window w before any station's
    window w+1) and track per-cluster online RMSE as forecasts resolve.

    Each window submits its look-back as a ``(1, L)`` request routed by the
    window's original station id; stations without a checkpoint count as
    ``unroutable``, a request unresolved after ``timeout`` seconds as
    ``timed_out``; any other failure raises. The windows are already
    normalized, so on a raw-serving server routable requests go by their
    resolved cluster (same route, no station rescale).

    Returns ``{"overall_rmse", "windows", "unroutable", "timed_out",
    "seconds", "per_cluster": {label: {"rmse", "windows"}}}``.
    """
    from concurrent.futures import TimeoutError as FutTimeout
    if series is None:
        series = task.series()
    tr, va, te, info = task.client_data(series)
    stations = np.asarray(info["kept"])
    L, T = task.look_back, task.horizon
    n_win = te.shape[1] if max_windows is None else min(max_windows, te.shape[1])

    def cluster_of(s: int):
        try:
            return server.resolve_cluster(station=s)
        except (KeyError, ValueError):
            return None

    server.warmup(channels=1)
    running = server._worker_thread is not None
    if not running:
        server.start()
    pending = []  # (cluster, truth, future)
    t0 = time.perf_counter()
    try:
        for w in range(n_win):
            for k, s in enumerate(stations.tolist()):
                x = te[k, w, :L][None].astype(np.float32)      # (1, L)
                c = cluster_of(s)
                fut = (server.submit(x, cluster=c)
                       if server.station_norm is not None and c is not None
                       else server.submit(x, station=s))
                pending.append((c, te[k, w, L:], fut))
        sse: dict = {}
        cnt: dict = {}
        unroutable = 0
        timed_out = 0
        for c, y_true, fut in pending:
            try:
                y_hat = fut.result(timeout=timeout)[0]         # (T,)
            except KeyError:      # routing failure ONLY; shape errors raise
                unroutable += 1
                continue
            except FutTimeout:    # one stuck request must not stall the replay
                timed_out += 1
                continue
            err = float(np.sum((np.asarray(y_hat, np.float64)
                                - np.asarray(y_true, np.float64)) ** 2))
            sse[c] = sse.get(c, 0.0) + err
            cnt[c] = cnt.get(c, 0) + 1
    finally:
        if not running:
            server.stop()
    secs = time.perf_counter() - t0
    per_cluster = {c: {"rmse": float(np.sqrt(sse[c] / (cnt[c] * T))),
                       "windows": cnt[c]} for c in sorted(cnt, key=str)}
    total_cnt = sum(cnt.values())
    rep = {
        "overall_rmse": (float(np.sqrt(sum(sse.values()) / (total_cnt * T)))
                         if total_cnt else float("nan")),
        "windows": total_cnt,
        "unroutable": unroutable,
        "timed_out": timed_out,
        "seconds": secs,
        "per_cluster": per_cluster,
    }
    if include_metrics:
        rep["metrics_text"] = server.metrics_text()
    return rep


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        description="restore FL forecaster checkpoints and serve them")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt-dir", help="single-model checkpoint dir")
    src.add_argument("--manifest",
                     help="experiment root containing routing.json "
                          "(multi-cluster routed serving)")
    ap.add_argument("--policy", default=None,
                    help="grid policy to serve from a multi-policy manifest")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--comm-bits", type=int, default=32, choices=(8, 16, 32),
                    help="16 = bf16-quantized restore, 8 = int8 + per-leaf "
                         "scale restore")
    ap.add_argument("--shard-batch", action="store_true",
                    help="shard each bucket's batch axis over the local "
                         "devices (ForecastServer(shard_batch=True))")
    ap.add_argument("--denormalize", action="store_true",
                    help="serve station-routed requests in RAW units via the "
                         "manifest's per-station norm stats (--manifest only)")
    ap.add_argument("--process-shard", default=None, metavar="I/N",
                    help="serve shard I of an N-process fleet (--manifest "
                         "only; e.g. --process-shard 0/2)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; fails without a GPU)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue", action=argparse.BooleanOptionalAction,
                    default=True, help="micro-batching queue vs direct batches")
    args = ap.parse_args(argv)

    kw = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
              shard_batch=args.shard_batch, device=args.device)
    if args.process_shard is not None and not args.manifest:
        ap.error("--process-shard requires --manifest")
    process_shard = None
    if args.process_shard is not None:
        try:
            i, n = args.process_shard.split("/")
            process_shard = (int(i), int(n))
        except ValueError:
            ap.error(f"--process-shard wants I/N, got {args.process_shard!r}")
    if args.manifest:
        server = ForecastServer.from_manifest(
            args.manifest, policy=args.policy, step=args.step,
            comm_bits=args.comm_bits, denormalize=args.denormalize,
            process_shard=process_shard, **kw)
        stations = server.routable_stations()
        print(f"restored {len(server.engines)} cluster models "
              f"({server.forecaster.name}, {server.forecaster.num_params():,} "
              f"params each) from {args.manifest} on {server.device}; routing "
              f"{len(stations)}/{len(server.station_cluster)} stations")
    else:
        server = ForecastServer.from_checkpoint(
            args.ckpt_dir, step=args.step, comm_bits=args.comm_bits, **kw)
        stations = None
        fc = server.forecaster
        print(f"restored {fc.name} ({fc.num_params():,} params) "
              f"from {args.ckpt_dir} on {server.device}")
    rep = serve_requests(server, args.requests, args.channels,
                         use_queue=args.queue, stations=stations)
    server.close()
    print(f"served {rep['requests']} requests x {rep['channels']} series in "
          f"{rep['seconds']:.3f}s -> {rep['forecasts_per_sec']:.0f} "
          f"forecasts/s ({rep['batches']} batches, "
          f"{rep['padded_slots']} padded slots, {rep['mode']}"
          f"{', routed' if rep['routed'] else ''})")


if __name__ == "__main__":
    main()
