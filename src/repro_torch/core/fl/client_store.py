"""Host-resident client store (counterpart of ``repro.core.fl.client_store``):
fleets whose ``(K, D)`` client state does not fit on the card.

The other drivers keep the client state on the device. :class:`ClientStore`
keeps the client params, the Adam moments and the raw ``(K, T)`` train and
test series in host memory, pinned when the device is CUDA, and
:func:`run_fl_host` (``run_fl(driver="host")``) moves only each round's
cohort:

  1. the cohort comes from the round key exactly as the device drivers draw
     it (``engine.sample_cohort`` on the post-split round key), so the same
     seed gives the same cohort sequence;
  2. :meth:`ClientStore.gather` takes the cohort's rows with
     ``index_select`` into pinned staging buffers and copies them to the
     device without blocking (``O(S * D)`` bytes a round);
  3. the staged round runs on the device: ``engine._round_down`` ->
     ``engine._local_update_all`` -> ``engine._round_up``, the functions
     every driver runs;
  4. :meth:`ClientStore.scatter` copies the updated rows back through the
     staging buffers and writes them into the store once an event says the
     copy has landed. Only the server state (global vector, counters) stays
     on the device.

Same key, same rounds: on one device the states and comm counters equal the
loop driver's bit for bit. :meth:`ClientStore.evaluate_rmse` streams the
test series through the forward in client chunks.

``partition=(index, count)`` is the multi-process mode (on by itself under
an initialized ``launch.distributed`` group): the store holds only its
``block_range`` block of the client rows and series, and each round is the
partitioned cycle of :mod:`repro_torch.core.fl.partition`
(``PartitionedRound`` over the store's host rows, the cycle the device mesh
runs over device rows: the cohort's rows merged from every process, the
downlink and uplink replicated, LocalUpdate on this process's block of
cohort positions), bitwise equal to the one-process run.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core import forecast
from repro_torch.core.fl import engine as E
from repro_torch.core.fl import partition as P
from repro_torch.core.fl import policies as pol
from repro_torch.launch import distributed
from repro_torch.models.spec import init_params_from_key

_STATE_KEYS = E._CLIENT_AXIS_KEYS


def _as_host(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


class ClientStore:
    """Client-axis FL state and raw series in host memory.

    Mirrors ``engine.init_fl_state``: the same params from ``key`` (or
    ``init_params``), every client row a copy of the global vector, zero
    Adam moments. ``w_clients``/``adam_m``/``adam_v``/``adam_t`` and the raw
    ``(K, T)`` ``train``/``test`` slices are host tensors, pinned when
    ``device`` is CUDA; the global vector ``w_global`` lives on ``device``.
    Requires ``fl_cfg.streaming_windows`` (the store holds raw slices, ~(L+T)x
    smaller rows than materialized windows).

    ``partition=(index, count)`` with ``count > 1`` keeps only the rows
    ``[lo, hi)`` of process ``index`` (``launch.distributed.block_range``;
    ``num_clients`` must divide by ``count``), and ``exchange`` (a
    :class:`repro_torch.core.fl.partition.Exchange` over the default
    process group) carries its rounds' exchanges. ``rows`` (a
    ``partition.OwnedRows``) holds the same host tensors with one scratch
    row each, for the partitioned round's payload and scatter; the
    attributes above are views of them without it."""

    def __init__(self, model_cfg, fl_cfg, train, test, key, init_params=None,
                 partition=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if not fl_cfg.streaming_windows:
            raise ValueError(
                "ClientStore requires FLConfig.streaming_windows=True: the "
                "store holds raw (K, T) series slices "
                "(repro_torch.data.windowing.client_series_datasets)")
        train, test = _as_host(train), _as_host(test)
        if train.dim() != 2 or test.dim() != 2:
            raise ValueError(f"expected raw (K, T) series slices, got ndim "
                             f"{train.dim()}/{test.dim()}")
        K = fl_cfg.num_clients
        if train.shape[0] != K:
            raise ValueError(f"train series has {train.shape[0]} clients, "
                             f"FLConfig says num_clients={K}")
        self.partition, self.exchange = None, None
        self.lo, self.hi = 0, K
        if partition is not None and int(partition[1]) > 1:
            idx, cnt = int(partition[0]), int(partition[1])
            if not 0 <= idx < cnt:
                raise ValueError(f"partition index {idx} out of range "
                                 f"for count {cnt}")
            if K % cnt:
                raise ValueError(
                    f"partition mode needs num_clients divisible by the "
                    f"process count, got K={K} over {cnt} processes")
            self.partition = (idx, cnt)
            self.lo, self.hi = distributed.block_range(K, idx, cnt)
            self.exchange = P.Exchange(idx, cnt, distributed.backend(), self.device)
        if init_params is None:
            init_params = init_params_from_key(
                forecast.model_spec(model_cfg), key, self.device)
        vec, self.meta = pt.tree_flatten_to_vector(init_params)
        self.model_cfg, self.fl_cfg = model_cfg, fl_cfg
        self.w_global = vec.to(self.device, torch.float32)
        self.num_clients = K
        self.pinned = self.device.type == "cuda"
        D, f32 = self.meta.total, torch.float32
        Kp = self.hi - self.lo
        train, test = train[self.lo:self.hi], test[self.lo:self.hi]
        (w, m, v, t, train_rows, self.test), self._registered = P._host_block(
            [((Kp + 1, D), f32)] * 3 + [((Kp + 1,), torch.int32),
             ((Kp + 1,) + tuple(train.shape[1:]), f32),
             (tuple(test.shape), f32)], self.pinned)
        w.copy_(self.w_global.cpu()[None, :].expand(Kp + 1, D))
        for z in (m, v, t, train_rows[Kp]):
            z.zero_()
        train_rows[:Kp].copy_(train)
        self.test.copy_(test)
        self.rows = P.OwnedRows(dict(zip(_STATE_KEYS, (w, m, v, t))),
                                train_rows, self.lo, self.hi)
        for k, rows in self.rows.state().items():
            setattr(self, k, rows)
        self.train = train_rows[:Kp]
        self._stage = {}      # (name, rows) -> [pinned staging buffer, event]

    def close(self):
        """Unpin the store and its transport buffers (its tensors stay
        usable as ordinary host memory). Called when the store is
        collected."""
        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None
        if self.exchange is not None:
            self.exchange.close()

    def __del__(self):
        if getattr(self, "_registered", None) is not None:
            self.close()

    @property
    def state_nbytes(self) -> int:
        """Host bytes of the client-axis state (params + Adam moments)."""
        return sum(getattr(self, k).nbytes for k in _STATE_KEYS)

    @property
    def series_nbytes(self) -> int:
        """Host bytes of the raw train + test series."""
        return self.train.nbytes + self.test.nbytes

    @property
    def nbytes(self) -> int:
        """Total host-resident bytes (client state + series)."""
        return self.state_nbytes + self.series_nbytes

    def _staging(self, name: str, src: torch.Tensor, rows: int):
        """The pinned ``(rows, ...)`` staging slot of ``name``: ``[buffer,
        event after its last host-to-device copy or None]``."""
        slot = self._stage.get((name, rows))
        if slot is None:
            slot = self._stage[(name, rows)] = [torch.empty(
                (rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                pin_memory=self.pinned), None]
        return slot

    def _to_device(self, name: str, src: torch.Tensor, rows: torch.Tensor):
        """``src[rows]`` on the device: gathered into the staging buffer
        (once its previous copy has landed), then copied without
        blocking."""
        slot = self._staging(name, src, rows.numel())
        if slot[1] is not None:
            slot[1].synchronize()
        torch.index_select(src, 0, rows, out=slot[0])
        out = slot[0].to(self.device, non_blocking=True, copy=True)
        if self.pinned:
            slot[1] = torch.cuda.Event()
            slot[1].record()
        return out

    def gather(self, cohort: torch.Tensor) -> dict:
        """The cohort's client-axis rows as device tensors (``O(S * D)``
        bytes, never ``O(K)``). ``cohort`` is an int64 CPU index tensor."""
        return {k: self._to_device(k, getattr(self, k), cohort)
                for k in _STATE_KEYS}

    def gather_train(self, cohort: torch.Tensor) -> torch.Tensor:
        """The cohort's raw train slices as a device ``(S, T)`` tensor."""
        return self._to_device("train", self.train, cohort)

    def scatter(self, cohort: torch.Tensor, sub: dict) -> None:
        """Write a cohort round's updated client rows back into the store:
        copied into the staging buffers without blocking (behind the
        gather's copies on the same stream), written into the store once an
        event says they have landed."""
        slots = {k: self._staging(k, getattr(self, k), cohort.numel())
                 for k in _STATE_KEYS}
        for k, slot in slots.items():
            slot[0].copy_(sub[k], non_blocking=self.pinned)
        if self.pinned:
            landed = torch.cuda.Event()
            landed.record()
            landed.synchronize()
        for k, slot in slots.items():
            slot[1] = None
            getattr(self, k).index_copy_(0, cohort, slot[0])

    def evaluate_rmse(self, w_vec, client_chunk: Optional[int] = None) -> float:
        """RMSE of the global model over all clients' test windows, streamed
        from the store in client chunks (default ``min(K, 1024)``). Equals
        ``engine.evaluate_rmse`` up to float summation order. In partition
        mode each process streams its own block and the per-chunk float32
        sums are gathered and added in (process, chunk) order: the
        one-process order, bit for bit, when ``chunk`` divides ``K /
        count``."""
        K = self.num_clients
        chunk = client_chunk if client_chunk is not None else min(K, 1024)
        Lb, H = self.model_cfg.look_back, self.model_cfg.horizon
        n = self.test.shape[1] - (Lb + H) + 1
        widx = (torch.arange(n, device=self.device)[:, None]
                + torch.arange(Lb + H, device=self.device)[None, :])
        params = pt.tree_unflatten_from_vector(w_vec, self.meta)
        sums = []
        with torch.no_grad():
            for lo in range(0, self.hi - self.lo, chunk):
                part = self.test[lo:lo + chunk].to(self.device,
                                                   non_blocking=True)
                win = part[:, widx]                          # (C, n, L+T)
                pred = forecast.forward(self.model_cfg, params,
                                        win[:, :, :Lb].reshape(-1, Lb))
                err = pred - win[:, :, Lb:].reshape(-1, H)
                sums.append(float(torch.sum(torch.square(err))))
        if self.exchange is not None:
            sums = self.exchange.gather_values(sums)
        sse = 0.0
        for v in sums:
            sse += v
        return math.sqrt(sse / (K * n * H))


def run_fl_host(model_cfg, fl_cfg, train_data, test_data, key, *,
                max_rounds: int = 300, patience: int = 10,
                eval_every: int = 10, verbose: bool = False, policy=None,
                checkpoint_dir: Optional[str] = None, init_params=None,
                partition=None, device=DEFAULT_DEVICE) -> dict:
    """``run_fl(driver="host")``: the loop driver's rounds and stop with the
    ``(K, D)`` client state in a :class:`ClientStore` and only each round's
    cohort on ``device`` (see the module docstring). Returns
    ``engine.run_fl``'s history plus ``history["client_store"]``, the live
    store, ``history["client_store_setup_s"]``, the host seconds that built
    it, and ``history["round_s"]``, each round's host seconds (its cohort's
    copies, its evaluation where due, and the read of its loss, which waits
    for the round).

    ``partition=(index, count)`` (by default ``(process_index(),
    process_count())`` under an initialized process group) runs the
    partitioned round of :mod:`repro_torch.core.fl.partition`: this process
    holds rows ``history["owned_rows"]`` of the store and trains its block
    of each cohort; ``history["exchange"]`` holds the bytes and seconds of
    each exchange. Needs :func:`partition.validate_partition`'s conditions
    with ``streamed_eval``; process 0 alone writes the checkpoint."""
    dev = resolve_device(device)
    if partition is None and distributed.process_count() > 1:
        partition = (distributed.process_index(), distributed.process_count())
    if partition is not None and int(partition[1]) <= 1:
        partition = None
    K, S = fl_cfg.num_clients, fl_cfg.participation_size()
    if partition is not None:
        P.validate_partition(K, S, int(partition[1]), fl_cfg.client_chunk,
                             streamed_eval=True)
        if int(partition[0]) != 0:
            checkpoint_dir = None      # process 0 owns the checkpoint write
    policy = pol.from_config(fl_cfg) if policy is None else policy
    key = E._as_device(key, dev, torch.int64)
    key, init_key = R.split(key).unbind(0)
    t0 = time.perf_counter()
    store = ClientStore(model_cfg, fl_cfg, train_data, test_data, init_key,
                        init_params=init_params, partition=partition,
                        device=dev)
    W = model_cfg.look_back + model_cfg.horizon
    if min(store.train.shape[1], store.test.shape[1]) < W:
        raise ValueError(
            f"raw series slices too short for look_back+horizon={W}: "
            f"train T={store.train.shape[1]}, test T={store.test.shape[1]}")

    meta = store.meta
    ex = store.exchange
    server = E._server_state(store.w_global, fl_cfg)
    cycle = None if ex is None else P.PartitionedRound(
        store.rows, ex, server, key.clone(), model_cfg, fl_cfg, meta, policy)

    history = {"round": [], "train_loss": [], "comm": [], "rmse": [],
               "client_store_setup_s": time.perf_counter() - t0,
               "round_s": []}
    best_loss, stall, comm_total = math.inf, 0, 0.0
    for r in range(max_rounds):
        t0 = time.perf_counter()
        if cycle is not None:
            cycle.run()                # the server state updated in place
            metrics = cycle.metrics
        else:
            key, rk, cohort = P.draw_round(key, K, S)
            cohort = cohort.cpu()
            sub = store.gather(cohort)
            merged = tuple(sub[k] for k in _STATE_KEYS) + (
                store.gather_train(cohort),)
            sub_state, down, upd = P.local_stage(server, merged, rk, (0, S),
                                                 model_cfg, fl_cfg, meta,
                                                 policy)
            sub_new, metrics = E._round_up(sub_state, down, tuple(upd),
                                           fl_cfg, meta, policy)
            store.scatter(cohort, sub_new)
            server = {k: sub_new[k] for k in server}

        loss = float(metrics["train_loss"])
        comm_total = float(metrics["comm_total"])
        history["round"].append(r)
        history["train_loss"].append(loss)
        history["comm"].append(comm_total)
        if (r + 1) % eval_every == 0 or r == max_rounds - 1:
            rmse = store.evaluate_rmse(server["w_global"], fl_cfg.client_chunk)
            history["rmse"].append((r, rmse))
            if verbose:
                print(f"round {r:4d}  loss {loss:.4f}  rmse {rmse:.4f}  "
                      f"comm {comm_total:.3e}")
        history["round_s"].append(time.perf_counter() - t0)
        if E._improved(loss, best_loss):
            best_loss, stall = loss, 0
        else:
            stall += 1
            if stall >= patience:
                break

    if history["rmse"] and history["rmse"][-1][0] == len(history["round"]) - 1:
        final_rmse = history["rmse"][-1][1]
    else:
        final_rmse = store.evaluate_rmse(server["w_global"], fl_cfg.client_chunk)
    state = dict(server)
    state.update({k: getattr(store, k) for k in _STATE_KEYS})
    history["client_store"] = store
    if ex is not None:
        history["exchange"] = ex.stats
        history["owned_rows"] = (store.lo, store.hi)
    return E._finalize_history(history, state, meta, model_cfg, fl_cfg,
                               final_rmse, comm_total, checkpoint_dir)
