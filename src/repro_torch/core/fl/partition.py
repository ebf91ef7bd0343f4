"""The partitioned FL round: several processes, each holding one block of the
client axis, train as one (the multi-process paths of the reference's
``core/fl/client_store.py`` partition mode and ``core/fl/engine.py``
client mesh).

Every process replays the same key chain, so it draws the same cohorts,
selections and gates, and holds only its ``launch.distributed.block_range``
rows of the client state (params, Adam moments, step counts) and of the
train series (:class:`OwnedRows`). A round is five stages, one cycle
(:class:`PartitionedRound`) for the host store (rows in host memory,
``client_store.run_fl_host``) and the device mesh (rows on the device,
:class:`MeshRun`):

  1. ``OwnedRows.cohort_payload``: the full-shape ``(S, ...)`` cohort rows,
     zeros outside the rows this process owns;
  2. :meth:`Exchange.merge` (the int32 bit sum of
     ``distributed.merge_disjoint``): every process now holds the whole
     cohort bit for bit, and runs the downlink (``engine._round_down``)
     replicated;
  3. LocalUpdate (``engine._local_update_all``) on this process's
     contiguous block of ``S / count`` cohort positions (:func:`local_stage`);
  4. :meth:`Exchange.gather` of the blocks (``all_gather``, pure movement),
     then the uplink and aggregation (``engine._round_up``) replicated;
  5. ``OwnedRows.scatter_owned``: each process writes back the cohort rows
     it owns.

Every arithmetic stage either runs replicated on identical inputs or runs
exactly the rows and ``client_chunk`` chunks the one-process run runs, and
every exchange is bit transport, so under :func:`validate_partition` states,
comm counters and losses equal the one-process run's bit for bit, and so
does the RMSE: the mesh evaluates the replicated test series, the host
store streams each process's rows in ``client_chunk`` chunks, which
``validate_partition(streamed_eval=True)`` aligns with the one-process
run's.

The exchange volume is the reference's: the merge moves the full-shape
payload from every process (three ``(S, D)`` float32 leaves, the step counts
and the ``(S, ...)`` train rows), the gather a block of ``S / count`` rows of
each. Under gloo the transport buffers are host memory (one block pinned
with ``cudaHostRegister`` when the device is CUDA), under NCCL device memory.

The same cycle runs over a LOCAL mesh: ``count`` shards of one process, each
a block of the client axis on one of the mesh's devices (one device may hold
several shards, as the reference's virtual host devices do) with its own
CUDA stream, and a :class:`LocalExchange` in place of the process group: the
merge and the gather are device-to-device copies of bits between the shards,
ordered after the stages that fill them by events on the shards' streams.

Across processes with several devices in each (the reference's
``make_client_mesh(multi_host=True)`` over every device of every process),
shard ``p * n + i`` is device ``i`` of process ``p`` and the exchange has two
levels: the local one into the process's first shard, then one
:class:`Exchange` over the process group of that shard's result (the merged
payload, the process's ``n`` contiguous blocks), then copies from the first
shard to the others. The merge stays an int32 sum over disjoint rows and the
gather pure movement in shard order, so the levels change no bit.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import normalized
from repro_torch.core.fl import engine as E
from repro_torch.launch import distributed as D

_ROWS = E._CLIENT_AXIS_KEYS
_F32, _I32 = torch.float32, torch.int32


def validate_partition(K: int, S: int, count: int,
                       client_chunk: Optional[int], *,
                       streamed_eval: bool = False) -> None:
    """The conditions under which a ``count``-process run equals the
    one-process run bit for bit (``docs/distributed.md``, "Bitwise
    alignment conditions"); raises ``ValueError`` otherwise.

    The port also requires ``client_chunk`` (the reference only documents
    it): a client's gradients depend on how many clients share its vmap (on
    the CPU, at d_model 128, a vmap of 2 and one of 4 differ in the last
    bits; cuBLAS picks its kernels by batch too), so every process must run
    exactly the chunks the one-process run runs. ``streamed_eval`` (the
    host store, whose RMSE streams each process's ``K / count`` rows in
    ``client_chunk`` chunks) also needs ``client_chunk`` to divide
    ``K / count``, so that the chunks' sums are the one-process run's."""
    if K % count:
        raise ValueError(
            f"partition mode needs num_clients divisible by the process "
            f"count, got K={K} over {count} processes")
    if S % count or S // count < 2:
        raise ValueError(
            f"partition mode needs the cohort size divisible by the process "
            f"count with >= 2 rows per process (vmapped LocalUpdate rows are "
            f"batch-invariant only for batches >= 2), got participation={S} "
            f"over {count} processes")
    block = S // count
    if client_chunk is None or block % client_chunk:
        raise ValueError(
            f"partition mode needs FLConfig.client_chunk to divide the "
            f"{block} cohort rows of each process (participation={S} over "
            f"{count} processes), got client_chunk={client_chunk}: a client's "
            f"gradients depend on how many clients share its vmap, so each "
            f"process must run the one-process run's own chunks")
    if streamed_eval and (K // count) % client_chunk:
        raise ValueError(
            f"the host store's partition mode needs FLConfig.client_chunk to "
            f"divide the {K // count} store rows of each process too "
            f"(num_clients={K} over {count} processes), got client_chunk="
            f"{client_chunk}: each process streams its RMSE in chunks of its "
            f"own rows, whose sums are the one-process run's only at the "
            f"same chunk boundaries")


def _host_block(specs, pinned: bool):
    """Uninitialized host tensors of the given ``(shape, dtype)`` specs, carved
    out of ONE allocation that is page-locked with ``cudaHostRegister`` when
    ``pinned``: exact size (``pin_memory()``'s caching allocator rounds each
    allocation up to a power of two, up to 2x for a large store), one
    registration, and copies that a CUDA graph may hold (the caching host
    allocator records events on its blocks). Returns ``(tensors, base
    pointer to unregister or None)``."""
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


def merge_specs(S: int, D_: int, row_shape) -> list:
    """The merge's ``(shape, dtype)``: w, m, v ``(S, D)``, t ``(S,)``, the
    train rows ``(S, *row_shape)``."""
    return [((S, D_), _F32)] * 3 + [((S,), _I32), ((S,) + tuple(row_shape), _F32)]


def update_specs(rows: int, D_: int) -> list:
    """A LocalUpdate result of ``rows`` clients: w, m, v, t and the loss."""
    return [((rows, D_), _F32)] * 3 + [((rows,), _I32), ((rows,), _F32)]


class Exchange:
    """The exchanges of a partitioned run over the default process group,
    with their cost: ``stats[kind]["bytes"]`` (what this process hands to
    the collective) and ``["s"]`` (host seconds inside the call, the wait
    for the slower process included; under NCCL the call only enqueues) for
    each call, so one entry per round for ``"merge"`` and ``"gather"`` and
    one per evaluation for ``"rmse"``.

    :meth:`buffers` holds the transport tensors by name, allocated once:
    host memory under gloo (pinned when ``device`` is CUDA), device memory
    under NCCL."""

    def __init__(self, index: int, count: int, backend: Optional[str],
                 device: torch.device):
        self.index, self.count = index, count
        self.backend = backend or "gloo"
        self.device = device
        self.on_host = self.backend == "gloo"
        self.pinned = self.on_host and device.type == "cuda"
        self._slots = {}         # name -> [tensors, registered base or None]
        self.stats = {"backend": self.backend, "processes": count,
                      **{k: {"bytes": [], "s": []}
                         for k in ("merge", "gather", "rmse")}}

    def buffers(self, name: str, specs, device=None) -> list:
        """The transport tensors of ``name``, allocated at the first call
        (on ``device``, default this exchange's, when not on the host)."""
        slot = self._slots.get(name)
        if slot is None:
            if self.on_host:
                tensors, base = _host_block(specs, self.pinned)
            else:
                tensors, base = [torch.empty(s, dtype=d,
                                             device=device or self.device)
                                 for s, d in specs], None
            slot = self._slots[name] = [tensors, base]
        return slot[0]

    def _timed(self, kind: str, nbytes: int, fn) -> None:
        t0 = time.perf_counter()
        fn()
        self.stats[kind]["s"].append(time.perf_counter() - t0)
        self.stats[kind]["bytes"].append(int(nbytes))

    def merge(self, bufs) -> None:
        """Stage 2's exchange, in place on transport tensors: every
        process's disjoint rows summed as int32 words."""
        def run():
            for b in bufs:
                D.all_reduce_bits_(b)
        self._timed("merge", sum(b.nbytes for b in bufs), run)

    def gather(self, blocks, outs) -> None:
        """Stage 4's exchange: ``outs[i]`` <- every process's ``blocks[i]``
        in process order."""
        def run():
            for b, o in zip(blocks, outs):
                D.all_gather_rows_(b, o)
        self._timed("gather", sum(b.nbytes for b in blocks), run)

    def gather_values(self, values) -> list:
        """Every process's list of float32 ``values`` (equal lengths) in
        process order (the RMSE's per-chunk sums)."""
        dev = "cpu" if self.on_host else self.device
        mine = torch.tensor(values, dtype=_F32, device=dev)
        full = torch.empty(self.count * len(values), dtype=_F32, device=dev)
        self._timed("rmse", mine.nbytes,
                    lambda: D.all_gather_rows_(mine, full))
        return full.tolist()

    def close(self) -> None:
        """Unpin the host transport buffers."""
        for slot in self._slots.values():
            if slot[1] is not None:
                torch.cuda.cudart().cudaHostUnregister(slot[1])
                slot[1] = None


def _on(device, stream):
    """``device`` and ``stream`` current (CUDA), or nothing (the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


class LocalExchange(Exchange):
    """The exchanges of a local mesh: ``n`` shards of this process, shard
    ``i`` on ``devices[i]`` (a device may repeat) with its own CUDA stream
    ``streams[i]`` (None on the CPU). Both exchanges are device-to-device
    copies of bits, each ordered after the stage that filled its source by
    an event recorded on the source shard's stream, never by a host wait or
    a device-wide sync:

      * :meth:`merge`: every other shard's payload is copied next to each
        shard's own, and once every shard has copied, each adds the copies
        to its own payload as int32 words in place (disjoint supports: bit
        transport, ``-0.0`` survives, as ``distributed.merge_disjoint``);
      * :meth:`gather`: every shard's block is copied into each shard's
        ``(S, ...)`` rows, in shard order.

    A shard writes its transport tensors again only after its next merge
    has waited for every shard's copies of that merge, which each shard
    makes after its reads of the previous gather. :attr:`stats` are
    :class:`Exchange`'s: per call the bytes each shard hands over, and the
    host seconds the call takes (to enqueue, on the card).

    With ``process`` (an :class:`Exchange` over the process group) the
    shards are this process's part of a mesh across processes: shard ``i``
    is ``index + i`` of ``count`` (``index = process.index * n``). Each
    exchange then runs locally into the first shard alone, then through
    ``process`` on the first shard's result (staged into its transport
    tensors on the first shard's stream; under gloo the host waits for that
    stream first, under NCCL the collective is enqueued on it), then every
    other shard copies the first shard's result after an event, and the
    first shard's stream waits for those copies before it writes again.
    ``stats["across"]`` is ``process``'s own record of the second level."""

    def __init__(self, devices, streams, process: Optional[Exchange] = None):
        n = len(devices)
        index, processes = ((process.index, process.count) if process
                            else (0, 1))
        super().__init__(index * n, processes * n, "local", devices[0])
        self.devices, self.streams = list(devices), list(streams)
        self.process = process
        self.stats.update(processes=processes, shards=n)
        if process is not None:
            self.stats["across"] = process.stats

    def port(self, i: int) -> "_Port":
        return _Port(self, i)

    def _mark(self, i: int):
        """An event after the work queued so far on shard ``i``'s stream."""
        if self.streams[i] is None:
            return None
        event = torch.cuda.Event()
        event.record(self.streams[i])
        return event

    def _after(self, j: int, event) -> None:
        if event is not None:
            self.streams[j].wait_event(event)

    def _copy(self, dst, src, j: int, i: int) -> None:
        """``dst`` (shard ``j``'s) <- ``src`` (shard ``i``'s) on shard ``j``'s
        stream; between two devices torch copies on the source's current
        stream (here shard ``i``'s) behind a barrier with the destination's."""
        with _on(self.devices[i], self.streams[i]), \
                _on(self.devices[j], self.streams[j]):
            dst.copy_(src, non_blocking=True)

    def _targets(self):
        """The shards that receive the local level: every shard, or only
        the first when a process level follows."""
        return range(len(self.devices)) if self.process is None else (0,)

    def merge(self, bufs) -> None:
        """Stage 2's exchange, in place on each shard's transport tensors
        ``bufs[i]`` (:func:`merge_specs`)."""
        n = len(self.devices)

        def run():
            ready = [self._mark(i) for i in range(n)]
            recv = {}
            for j in self._targets():
                others = [i for i in range(n) if i != j]
                rx = self.buffers(f"merge_rx/{j}", [
                    (tuple(b.shape), b.dtype) for b in bufs[j]] * len(others),
                    self.devices[j])
                for k, i in enumerate(others):
                    self._after(j, ready[i])
                    for dst, src in zip(rx[k * len(bufs[i]):], bufs[i]):
                        self._copy(dst, src, j, i)
                recv[j] = rx
            copied = [self._mark(j) for j in range(n)]
            for j in self._targets():
                for i in range(n):
                    if i != j:
                        self._after(j, copied[i])
                with _on(self.devices[j], self.streams[j]):
                    for k, src in enumerate(recv[j]):
                        D._bits(bufs[j][k % len(bufs[j])]).add_(D._bits(src))
        self._timed("merge", sum(b.nbytes for b in bufs[0]), run)
        if self.process is not None:
            def across(ins):
                self.process.merge(ins)
                return ins
            self._across("merge", bufs[0], bufs[0], across)
            self._broadcast(bufs)

    def gather(self, blocks, outs) -> None:
        """Stage 4's exchange: ``outs[j][t]`` <- every shard's
        ``blocks[i][t]`` in shard order, for every shard ``j``."""
        n = len(self.devices)

        def run():
            ready = [self._mark(i) for i in range(n)]
            for j in self._targets():
                for i in range(n):
                    self._after(j, ready[i])
                    for src, out in zip(blocks[i], outs[j]):
                        rows = src.shape[0]
                        at = (self.index + i) * rows
                        self._copy(out[at:at + rows], src, j, i)
        self._timed("gather", sum(b.nbytes for b in blocks[0]), run)
        if self.process is not None:       # this process's n blocks
            at, rows = self.index * blocks[0][0].shape[0], n * blocks[0][0].shape[0]
            mine = [o[at:at + rows] for o in outs[0]]

            def across(ins):
                full = self.process.buffers(
                    "gathered", [(tuple(o.shape), o.dtype) for o in outs[0]])
                self.process.gather(ins, full)
                return full
            self._across("block", mine, outs[0], across)
            self._broadcast(outs)

    def _across(self, name: str, srcs, dsts, exchange) -> None:
        """The process level on the first shard: ``srcs`` into the process
        exchange's transport tensors ``name``, ``exchange(them)`` (which
        returns the tensors that hold its result), the result into
        ``dsts``, all on the first shard's stream."""
        x, dev, stream = self.process, self.devices[0], self.streams[0]
        ins = x.buffers(name, [(tuple(t.shape), t.dtype) for t in srcs])
        with _on(dev, stream):
            for b, t in zip(ins, srcs):
                b.copy_(t, non_blocking=True)
            if x.on_host and stream is not None:
                stream.synchronize()       # gloo reads the host copies
            got = exchange(ins)
            for d, g in zip(dsts, got):
                d.copy_(g, non_blocking=True)

    def _broadcast(self, tensors) -> None:
        """Every other shard's ``tensors[j]`` <- the first shard's, after
        the first shard's stream; then the first shard's stream waits for
        those copies."""
        n = len(self.devices)
        ready = self._mark(0)
        for j in range(1, n):
            self._after(j, ready)
            for dst, src in zip(tensors[j], tensors[0]):
                self._copy(dst, src, j, 0)
        for j in range(1, n):
            self._after(0, self._mark(j))

    def close(self) -> None:
        super().close()
        if self.process is not None:
            self.process.close()


class _Port:
    """Shard ``i``'s side of a :class:`LocalExchange`: what
    :class:`PartitionedRound` reads of an exchange (its index among every
    shard of the mesh, their count, transport tensors, here on the shard's
    device)."""

    def __init__(self, ex: LocalExchange, i: int):
        self.ex, self.i = ex, i
        self.index, self.count = ex.index + i, ex.count

    def buffers(self, name: str, specs) -> list:
        return self.ex.buffers(f"{name}/{self.i}", specs, self.ex.devices[self.i])


def draw_round(key, K: int, S: int):
    """One round of every driver's key chain: ``(next chain key, round key,
    cohort)``, the cohort of ``S < K`` clients drawn from the round key as
    ``engine._round`` draws it (all ``K`` clients otherwise)."""
    key, rk = R.split(key).unbind(0)
    if S < K:
        k_cohort, rk = R.split(rk).unbind(0)
        return key, rk, E.sample_cohort(k_cohort, K, S)
    return key, rk, torch.arange(K, device=rk.device)


def local_stage(server, merged, rk, block, model_cfg, fl_cfg, meta, policy):
    """Stages 2-3 on the merged cohort rows ``(w, m, v, t, train)``: the
    downlink on the whole cohort, LocalUpdate on the cohort positions
    ``block = (lo, hi)``. Returns ``(cohort state, downlink, LocalUpdate
    result of the block)``."""
    w_c, a_m, a_v, a_t, data = merged
    sub_state = {**server, "w_clients": w_c, "adam_m": a_m, "adam_v": a_v,
                 "adam_t": a_t}
    down = E._round_down(sub_state, rk, fl_cfg, meta, policy)
    lo, hi = block
    keys = R.split(down["k_local"], w_c.shape[0])
    with record_function("fl.local_update"):
        upd = E._local_update_all(model_cfg, fl_cfg, meta,
                                  down["w_mixed"][lo:hi], a_m[lo:hi],
                                  a_v[lo:hi], a_t[lo:hi], data[lo:hi],
                                  keys[lo:hi])
    return sub_state, down, upd


class OwnedRows:
    """This process's block ``[lo, hi)`` of the client-axis state and of the
    train rows, in host memory (the host store) or on the device (the
    mesh), each with one scratch row at the end (index ``hi - lo``): a
    cohort position that another process owns reads and writes the scratch
    row, so no stage depends on how many positions this process owns (a
    shape that would need a host read, which no CUDA graph can hold)."""

    def __init__(self, rows: dict, train: torch.Tensor, lo: int, hi: int):
        self.rows, self.train = rows, train
        self.lo, self.n = lo, hi - lo
        self.device = train.device

    def _locate(self, cohort):
        cohort = cohort.to(self.device)
        own = (cohort >= self.lo) & (cohort < self.lo + self.n)
        return own, torch.where(own, cohort - self.lo, self.n)

    def cohort_payload(self, cohort, out) -> None:
        """Stage 1 into the transport tensors ``out`` (:func:`merge_specs`):
        the full-shape cohort rows of w, m, v, t and the train series, the
        owned positions from the block, exact zeros elsewhere."""
        own, loc = self._locate(cohort)
        srcs = [self.rows[k] for k in _ROWS] + [self.train]
        for src, dst in zip(srcs, out):
            got = src.index_select(0, loc)
            got.masked_fill_(~own.reshape((-1,) + (1,) * (got.dim() - 1)), 0)
            dst.copy_(got, non_blocking=True)

    def scatter_owned(self, cohort, sub: dict) -> None:
        """Stage 5: the owned cohort rows of ``sub`` into the block (the
        others into the scratch row)."""
        _, loc = self._locate(cohort)
        for k in _ROWS:
            self.rows[k].index_copy_(0, loc, sub[k].to(self.device))

    def state(self) -> dict:
        return {k: v[:self.n] for k, v in self.rows.items()}


class PartitionedRound:
    """One round of the partitioned cycle (the module docstring's stages
    1-5), the same for the host store and the device mesh: they differ only
    in where ``rows`` (:class:`OwnedRows`) live. Every stage reads and
    writes static tensors (the chain ``key`` and ``server``, updated in
    place, the transport buffers of ``ex`` and device buffers allocated
    here), so :class:`MeshRun` can capture each stage as a CUDA graph and
    replay it; :meth:`run` puts the host exchanges between them."""

    def __init__(self, rows: OwnedRows, ex: Exchange, server: dict, key,
                 model_cfg, fl_cfg, meta, policy):
        dev = key.device
        self.rows, self.ex, self.server, self.key = rows, ex, server, key
        self.model_cfg, self.fl_cfg, self.meta, self.policy = (
            model_cfg, fl_cfg, meta, policy)
        self.K, self.S = fl_cfg.num_clients, fl_cfg.participation_size()
        self.block = D.block_range(self.S, ex.index, ex.count)
        m_specs = merge_specs(self.S, meta.total, rows.train.shape[1:])
        u_specs = update_specs(self.S, meta.total)
        self.tb = ex.buffers("merge", m_specs)
        self.gb = ex.buffers("block", update_specs(self.S // ex.count,
                                                   meta.total))
        self.go = ex.buffers("gathered", u_specs)
        self.merged = [torch.empty(s, dtype=d, device=dev) for s, d in m_specs]
        self.gathered = [torch.empty(s, dtype=d, device=dev)
                         for s, d in u_specs]
        self.rk = key.clone()
        self.cohort = torch.zeros(self.S, dtype=torch.int64, device=dev)
        self.down = None                   # static copy of the downlink
        self.metrics = None
        self.cuda = dev.type == "cuda"

    def payload(self):
        """Stage 1: the round's keys and cohort, and the cohort's rows into
        the merge's transport tensors."""
        key, rk, cohort = draw_round(self.key, self.K, self.S)
        self.key.copy_(key)
        self.rk.copy_(rk)
        self.cohort.copy_(cohort)
        self.rows.cohort_payload(self.cohort, self.tb)

    def local(self):
        """Stages 2-3 after the merge: the downlink, then LocalUpdate of
        this process's block into the gather's transport tensors."""
        for d, b in zip(self.merged, self.tb):
            d.copy_(b, non_blocking=True)
        _, down, upd = local_stage(self.server, self.merged, self.rk,
                                   self.block, self.model_cfg, self.fl_cfg,
                                   self.meta, self.policy)
        if self.down is None:              # the first round, never captured
            self.down = pt.tree_map(torch.empty_like, down)
        for d, s in zip(pt.leaves(self.down), pt.leaves(down)):
            d.copy_(s)
        for d, u in zip(self.gb, upd):
            d.copy_(u, non_blocking=True)

    def up(self) -> dict:
        """Stages 4-5 after the gather: the uplink and aggregation into the
        server state, the owned rows scattered back. Returns the round's
        metrics (device tensors)."""
        for d, g in zip(self.gathered, self.go):
            d.copy_(g, non_blocking=True)
        w, m, v, t, _ = self.merged
        sub = {**self.server, "w_clients": w, "adam_m": m, "adam_v": v,
               "adam_t": t}
        new, self.metrics = E._round_up(sub, self.down, tuple(self.gathered),
                                        self.fl_cfg, self.meta, self.policy)
        for k, v in self.server.items():
            v.copy_(new[k])
        self.rows.scatter_owned(self.cohort, new)
        return self.metrics

    def _landed(self):
        """Wait (host) for the work enqueued so far on this stream, before
        an exchange through host memory (NCCL's collectives are enqueued
        behind it on the device)."""
        if self.cuda and self.ex.on_host:
            torch.cuda.current_stream(self.key.device).synchronize()

    def run(self, step=None):
        """One round: ``step(name)`` runs each stage (default: the stage
        itself; :class:`MeshRun` replays its graphs), each exchange once the
        stage that fills its buffers has landed."""
        step = step or (lambda name: getattr(self, name)())
        step("payload")
        self._landed()
        self.ex.merge(self.tb)
        step("local")
        self._landed()
        self.ex.gather(self.gb, self.go)
        step("up")


class _MeshShard:
    """One block ``[lo, hi)`` of the client axis on one device (this
    process's block across processes; one of a local mesh's shards): its
    rows with their scratch row, and its own copies of the server state, the
    test series and the while driver's flags (key chain, patience state,
    counters, history buffers), its cycle (:class:`PartitionedRound` over
    its side of the exchange), and on the card its own CUDA stream, on which
    every segment runs, eagerly or as the graph captured there. Each segment
    reads and writes only these static tensors and the transport buffers."""

    def __init__(self, run: "MeshRun", index: int, count: int, device,
                 stream, ex, vec, key, train_data, test_data, policy):
        K = run.fl_cfg.num_clients
        self.run, self.device, self.stream = run, device, stream
        self.lo, self.hi = D.block_range(K, index, count)
        vec = vec.to(device, copy=True)
        self.server = E._server_state(vec, run.fl_cfg)
        train = E._as_device(train_data[self.lo:self.hi], device, _F32)
        train = torch.cat([train, train.new_zeros((1,) + tuple(train.shape[1:]))])
        self.rows = OwnedRows(E._client_rows(vec, self.hi - self.lo + 1),
                              train, self.lo, self.hi)
        self.test = E._as_device(test_data, device, _F32)
        self.flags = E._while_flags(key.to(device), len(run.lengths),
                                    run.eval_every)
        self.cycle = PartitionedRound(self.rows, ex, self.server,
                                      self.flags["key"], run.model_cfg,
                                      run.fl_cfg, run.meta, policy)
        self.graphs = {}
        self.replays = {name: 0 for name in MeshRun.SEGMENTS}
        if stream is not None:       # the set-up above ran on the current one
            stream.wait_stream(torch.cuda.current_stream(device))

    def on(self):
        return _on(self.device, self.stream)

    # --- the segments: static tensors in, static tensors out -------------
    def _seg_payload(self):
        self.cycle.payload()

    def _seg_local(self):
        self.cycle.local()

    def _seg_up(self):
        metrics = self.cycle.up()
        f, loss = self.flags, metrics["train_loss"]
        r = f["r"].reshape(1)
        f["loss_buf"].index_copy_(0, r, loss.reshape(1))
        f["comm_buf"].index_copy_(0, r, metrics["comm_total"].reshape(1))
        patience = E._patience_step(f["best"], f["stall"], f["stop"], loss,
                                    self.run.patience)
        for k, v in zip(("best", "stall", "stop"), patience):
            f[k].copy_(v)
        f["r"].add_(1)

    def rmse(self):
        return E._rmse_device(self.run.model_cfg, self.server["w_global"],
                              self.run.meta, self.test,
                              self.run.fl_cfg.client_chunk)

    def _seg_end_chunk(self):
        f = self.flags
        f["rmse_buf"].index_copy_(0, f["c"].reshape(1), self.rmse().reshape(1))
        f["c"].add_(1)

    def step(self, name: str):
        """Segment ``name`` on this shard's device and stream: its graph's
        replay once captured, else the segment itself."""
        with self.on():
            graph = self.graphs.get(name)
            if graph is None:
                getattr(self, "_seg_" + name)()
            else:
                graph.replay()
                self.replays[name] += 1

    def capture(self):
        """Capture each segment as a CUDA graph on this shard's stream
        (``engine._capture_graph``: ``thread_local`` mode, one memory pool
        for the four, which replay in turn, never at once)."""
        pool = None
        with torch.cuda.device(self.device):
            for name in MeshRun.SEGMENTS:
                graph = torch.cuda.CUDAGraph()
                with E._capture_graph(graph, pool, self.stream):
                    getattr(self, "_seg_" + name)()
                pool = graph.pool()
                self.graphs[name] = graph


class MeshRun:
    """``run_fl(client_mesh=...)`` over the mesh's shards (:class:`_MeshShard`):
    across processes with one device each, this process's one block on its
    device with an :class:`Exchange` over the process group; with several
    devices in this process (a local mesh, or this process's part of one
    across processes), one shard per device with a :class:`LocalExchange`
    (over an :class:`Exchange` of the process group across processes), all
    driven from this thread. Each round
    runs the segments ``payload``, ``local`` and ``up`` on every shard (the
    stages of :class:`PartitionedRound`; ``up`` also runs the patience test
    and writes the loss and comm at the round counter) with the merge after
    the first and the gather after the second, each chunk of ``eval_every``
    rounds ends with ``end_chunk`` (the RMSE written at the chunk counter),
    and the host reads the first shard's stop flag after it, as the scan
    driver stops. Across processes under gloo the host waits for the
    stream that fills an exchange's buffers before the exchange; under
    NCCL and between local shards the exchanges wait for nothing on the
    host.

    ``driver="scan"`` (and every driver on the CPU) runs the segments
    eagerly. ``driver="while"`` on the card runs the first round eagerly (it
    builds the kernels and allocates psgf_mix's ticket counters, which no
    capture may do), then captures each shard's segments as CUDA graphs on
    its stream (:meth:`_MeshShard.capture`) and replays them around the
    exchanges. A failed capture raises. At the end the host waits for every
    shard's stream (the run's graphs and their memory go with it)."""

    SEGMENTS = ("payload", "local", "up", "end_chunk")

    def __init__(self, mesh, model_cfg, fl_cfg, train_data, test_data, key,
                 policy, max_rounds: int, eval_every: int, patience: int,
                 init_params=None, graphs: bool = False):
        dev = mesh.device
        n = len(mesh.devices)
        self.local = n > 1               # this process's shards exchange locally
        count = n * mesh.count
        if mesh.count > 1:
            if (D.process_count(), D.process_index()) != (mesh.count, mesh.index):
                raise RuntimeError(
                    f"a client mesh across {mesh.count} processes (this one "
                    f"{mesh.index}) needs their initialized process group "
                    f"(launch.distributed.initialize_distributed); this "
                    f"process is {D.process_index()} of {D.process_count()}")
            if normalized(dev) != normalized(D.device()):
                raise ValueError(f"a client mesh across processes starts at "
                                 f"this process's group device "
                                 f"{D.device()}, not at {dev}")
            validate_partition(fl_cfg.num_clients, fl_cfg.participation_size(),
                               count, fl_cfg.client_chunk)
        self.mesh, self.model_cfg, self.fl_cfg = mesh, model_cfg, fl_cfg
        self.patience, self.eval_every = patience, eval_every
        key = E._as_device(key, dev, torch.int64)
        key, init_key = R.split(key).unbind(0)
        vec, self.meta = E._init_vector(model_cfg, init_key, init_params, dev)
        full, rem = divmod(max_rounds, eval_every)
        self.lengths = [eval_every] * full + ([rem] if rem else [])
        devices = mesh.devices
        streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                   for d in devices]
        across = (Exchange(mesh.index, mesh.count, mesh.backend, dev)
                  if mesh.count > 1 else None)
        if self.local:
            self.ex = LocalExchange(devices, streams, across)
            places = [(self.ex.index + i, self.ex.port(i)) for i in range(n)]
        else:
            self.ex = across
            places = [(mesh.index, self.ex)]
        self.shards = [
            _MeshShard(self, i, count, devices[k], streams[k], ex, vec, key,
                       train_data, test_data, policy)
            for k, (i, ex) in enumerate(places)]
        self.want_graphs = graphs and dev.type == "cuda"
        self.warmup_s = self.capture_s = self.run_s = 0.0

    def _round(self):
        shards = self.shards
        if not self.local:      # the host waits on and exchanges from its stream
            with shards[0].on():
                shards[0].cycle.run(shards[0].step)
            return
        cycles = [s.cycle for s in shards]
        for shard in shards:
            shard.step("payload")
        self.ex.merge([c.tb for c in cycles])
        for shard in shards:
            shard.step("local")
        self.ex.gather([c.gb for c in cycles], [c.go for c in cycles])
        for shard in shards:
            shard.step("up")

    def _warm_round_and_capture(self):
        """Round 1 eagerly (with ``end_chunk``'s RMSE forward on every shard,
        its result dropped), then every shard's capture: no kernel is built
        and no counter allocated under capture."""
        t0 = time.perf_counter()
        self._round()
        for shard in self.shards:
            with shard.on():
                shard.rmse()
        self.finish()
        t1 = time.perf_counter()
        for shard in self.shards:
            shard.capture()
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def _stopped(self) -> bool:
        first = self.shards[0]
        with first.on():
            return bool(first.flags["stop"])

    def run(self):
        """Every chunk until ``max_rounds`` or the stop flag."""
        t0 = time.perf_counter()
        try:
            for length in self.lengths:
                for _ in range(length):
                    if self.want_graphs and not self.shards[0].graphs:
                        self._warm_round_and_capture()
                    else:
                        self._round()
                for shard in self.shards:
                    shard.step("end_chunk")
                if self._stopped():
                    break
        finally:
            self.finish()
        self.run_s = time.perf_counter() - t0

    def finish(self):
        """Wait (host) for every shard's stream: nothing of the run is in
        flight once it returns."""
        for shard in self.shards:
            if shard.stream is not None:
                shard.stream.synchronize()

    def take_state(self) -> dict:
        """The run's final state: the first shard's server state and the
        client rows of this process's shards, their blocks in order on the
        mesh's first device (over a local mesh the reference's global
        array; each leaf's blocks are dropped once joined)."""
        first = self.shards[0]
        if len(self.shards) == 1:
            return {**first.server, **first.rows.state()}
        rows = {}
        for k in _ROWS:
            rows[k] = torch.cat([s.rows.state()[k].to(first.device)
                                 for s in self.shards])
            for s in self.shards:
                del s.rows.rows[k]
        return {**first.server, **rows}


def run_fl_mesh(model_cfg, fl_cfg, train_data, test_data, key, mesh, *,
                driver: str, max_rounds: int, patience: int, eval_every: int,
                verbose: bool = False, policy=None,
                checkpoint_dir: Optional[str] = None, init_params=None) -> dict:
    """``run_fl(driver="scan"|"while", client_mesh=mesh)`` over the shards of
    ``mesh`` (see :class:`MeshRun`). Returns ``run_fl``'s history plus
    ``history["exchange"]`` (:attr:`Exchange.stats`) and
    ``history["mesh_run"]`` (processes, shards, devices, backend, graphs per
    shard, their replays; the eager first round's, the capture's and the
    run's seconds). Across processes
    ``state`` holds this process's rows of the client axis
    (``history["owned_rows"]``), on its first device, and process 0 alone
    writes the checkpoint; over a local mesh it holds the whole client axis
    on the mesh's first device."""
    from repro_torch.core.fl import policies as pol

    policy = pol.from_config(fl_cfg) if policy is None else policy
    run = MeshRun(mesh, model_cfg, fl_cfg, train_data, test_data, key, policy,
                  max_rounds, eval_every, patience, init_params=init_params,
                  graphs=driver == "while")
    first = run.shards[0]
    try:
        run.run()
        rounds, _, losses, comms, rmses = E._read_while(first.flags)
    finally:
        run.ex.close()
    history = E._chunk_history(rounds, losses, comms, rmses, eval_every,
                               max_rounds, verbose)
    history["exchange"] = run.ex.stats
    history["owned_rows"] = (first.lo, run.shards[-1].hi)
    history["mesh_run"] = {
        "processes": mesh.count, "index": mesh.index,
        "backend": mesh.backend or run.ex.backend,
        "shards": len(run.shards), "sharded": True,
        "device": str(mesh.device),
        "devices": [str(s.device) for s in run.shards],
        "graphs": list(first.graphs),
        "replays": dict(first.replays), "warmup_s": run.warmup_s,
        "capture_s": run.capture_s, "run_s": run.run_s}
    state = run.take_state()
    if mesh.index != 0:
        checkpoint_dir = None          # process 0 owns the checkpoint write
    return E._finalize_history(history, state, run.meta, model_cfg, fl_cfg,
                               rmses[-1], comms[-1] if comms else 0.0,
                               checkpoint_dir)
