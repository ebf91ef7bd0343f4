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

The multi-process partition mode of the reference (``partition=``) is not
ported yet (ROADMAP Queue A 7).
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
from repro_torch.core.fl import policies as pol
from repro_torch.models.spec import init_params_from_key

_STATE_KEYS = E._CLIENT_AXIS_KEYS


def _host_block(specs, pinned: bool):
    """Uninitialized host tensors of the given ``(shape, dtype)`` specs, carved
    out of ONE allocation that is page-locked with ``cudaHostRegister`` when
    ``pinned``: exact size (``pin_memory()``'s caching allocator rounds each
    allocation up to a power of two, up to 2x for a large store) and one
    registration. Returns ``(tensors, base pointer to unregister or None)``."""
    offsets, total = [], 0
    for shape, dtype in specs:
        offsets.append(total)
        total += -(-math.prod(shape) * dtype.itemsize // 64) * 64
    raw = torch.empty(total, dtype=torch.uint8)
    base = None
    if pinned and total:
        err = int(torch.cuda.cudart().cudaHostRegister(raw.data_ptr(), total, 0))
        if err != 0:
            raise RuntimeError(f"cudaHostRegister of {total} bytes failed: "
                               f"CUDA error {err}")
        base = raw.data_ptr()
    tensors = [raw[o:o + math.prod(shape) * dtype.itemsize].view(dtype)
               .view(shape) for o, (shape, dtype) in zip(offsets, specs)]
    return tensors, base


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
    smaller rows than materialized windows)."""

    def __init__(self, model_cfg, fl_cfg, train, test, key, init_params=None,
                 partition=None, device=DEFAULT_DEVICE):
        if partition is not None:
            raise NotImplementedError(
                "ClientStore(partition=...), the multi-process store, is not "
                "ported yet (ROADMAP Queue A 7)")
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
        if init_params is None:
            init_params = init_params_from_key(
                forecast.model_spec(model_cfg), key, self.device)
        vec, self.meta = pt.tree_flatten_to_vector(init_params)
        self.model_cfg, self.fl_cfg = model_cfg, fl_cfg
        self.w_global = vec.to(self.device, torch.float32)
        self.num_clients = K
        self.pinned = self.device.type == "cuda"
        D, f32 = self.meta.total, torch.float32
        (self.w_clients, self.adam_m, self.adam_v, self.adam_t, self.train,
         self.test), self._registered = _host_block(
            [((K, D), f32), ((K, D), f32), ((K, D), f32),
             ((K,), torch.int32), (tuple(train.shape), f32),
             (tuple(test.shape), f32)], self.pinned)
        self.w_clients.copy_(self.w_global.cpu()[None, :].expand(K, D))
        self.adam_m.zero_()
        self.adam_v.zero_()
        self.adam_t.zero_()
        self.train.copy_(train)
        self.test.copy_(test)
        self._stage = {}      # (name, rows) -> [pinned staging buffer, event]

    def close(self):
        """Unpin the store (its tensors stay usable as ordinary host
        memory). Called when the store is collected."""
        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None

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
        ``engine.evaluate_rmse`` up to float summation order."""
        K = self.num_clients
        chunk = client_chunk if client_chunk is not None else min(K, 1024)
        Lb, H = self.model_cfg.look_back, self.model_cfg.horizon
        n = self.test.shape[1] - (Lb + H) + 1
        widx = (torch.arange(n, device=self.device)[:, None]
                + torch.arange(Lb + H, device=self.device)[None, :])
        params = pt.tree_unflatten_from_vector(w_vec, self.meta)
        sse = 0.0
        with torch.no_grad():
            for lo in range(0, K, chunk):
                part = self.test[lo:lo + chunk].to(self.device,
                                                   non_blocking=True)
                win = part[:, widx]                          # (C, n, L+T)
                pred = forecast.forward(self.model_cfg, params,
                                        win[:, :, :Lb].reshape(-1, Lb))
                err = pred - win[:, :, Lb:].reshape(-1, H)
                sse += float(torch.sum(torch.square(err)))
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
    for the round). ``partition=`` (several processes) is not ported yet (ROADMAP
    Queue A 7) and raises."""
    if partition is not None:
        raise NotImplementedError(
            "run_fl_host(partition=...), the multi-process host driver, is "
            "not ported yet (ROADMAP Queue A 7)")
    dev = resolve_device(device)
    policy = pol.from_config(fl_cfg) if policy is None else policy
    key = E._as_device(key, dev, torch.int64)
    key, init_key = R.split(key).unbind(0)
    t0 = time.perf_counter()
    store = ClientStore(model_cfg, fl_cfg, train_data, test_data, init_key,
                        init_params=init_params, device=dev)
    W = model_cfg.look_back + model_cfg.horizon
    if min(store.train.shape[1], store.test.shape[1]) < W:
        raise ValueError(
            f"raw series slices too short for look_back+horizon={W}: "
            f"train T={store.train.shape[1]}, test T={store.test.shape[1]}")

    K, S = fl_cfg.num_clients, fl_cfg.participation_size()
    meta = store.meta
    zero = lambda: torch.zeros((), dtype=E.ACCOUNTING_DTYPE, device=dev)  # noqa: E731
    server = {"w_global": store.w_global,
              "round": torch.zeros((), dtype=torch.int32, device=dev),
              "comm_down": zero(), "comm_up": zero()}
    if fl_cfg.comm_bits == 8:
        server["comm_scales"] = zero()
    full_cohort = torch.arange(K)

    history = {"round": [], "train_loss": [], "comm": [], "rmse": [],
               "client_store_setup_s": time.perf_counter() - t0,
               "round_s": []}
    best_loss, stall, comm_total = math.inf, 0, 0.0
    for r in range(max_rounds):
        t0 = time.perf_counter()
        key, rk = R.split(key).unbind(0)
        if S < K:
            # the device drivers' key chain: _round splits (k_cohort,
            # k_round) off the round key
            k_cohort, rk = R.split(rk).unbind(0)
            cohort = E.sample_cohort(k_cohort, K, S).cpu()
        else:
            cohort = full_cohort
        sub = store.gather(cohort)
        data = store.gather_train(cohort)
        sub_state = {**server, **sub}
        down = E._round_down(sub_state, rk, fl_cfg, meta, policy)
        upd = E._local_update_all(model_cfg, fl_cfg, meta, down["w_mixed"],
                                  sub["adam_m"], sub["adam_v"], sub["adam_t"],
                                  data, R.split(down["k_local"], cohort.numel()))
        sub_new, metrics = E._round_up(sub_state, down, upd, fl_cfg, meta,
                                       policy)
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
    return E._finalize_history(history, state, meta, model_cfg, fl_cfg,
                               final_rmse, comm_total, checkpoint_dir)
