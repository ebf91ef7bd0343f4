"""Multi-process launch path on ``torch.distributed`` (counterpart of
``repro.launch.distributed``): the process group and the exact cross-process
exchange primitives of the FL engine and the serving fleet.

:func:`initialize_distributed` joins the process to a group described by its
arguments or by the ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` environment (falling back to torch's own
``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``). The backend is
explicit: ``gloo`` when the processes run on the CPU or share a GPU (NCCL
refuses two ranks on one GPU), ``nccl`` when each process has a GPU of its
own; the choice is recorded (:func:`backend`) and nothing switches to
another backend on a failure. Under gloo a process may still compute on the
card: the exchanges stage through host memory, pinned when the data came
from the card.

The exchange primitives are EXACT, pure data movement or integer arithmetic
on bit patterns, because a multi-process run must equal the one-process run
bit for bit (``docs/distributed.md``):

  * :func:`merge_disjoint` — every process passes full-shape tensors with
    zeros outside the rows it owns; float32 payloads are viewed as int32
    and summed by ``all_reduce(SUM)`` (disjoint supports: the integer sum
    is bit transport, ``-0.0`` survives), then viewed back;
  * :func:`allgather_blocks` — equal row blocks concatenated in process
    order (``all_gather``, no arithmetic);
  * :func:`fetch` — the identity: a tensor of the port is always local.

Left out because they have no PyTorch meaning: ``process_mesh``,
``_proc_shardings`` and ``host_to_global`` (they build process-spanning
``jax.Array`` values; a process of the port holds plain local tensors) and
``client_axis_sharding`` (a ``NamedSharding`` from ``sharding/rules.py``).

``python -m repro_torch.launch.distributed --smoke [--device cpu]
[--num-processes 2]`` is the self-contained check: the parent spawns the
children, each joins the group (a group of one for ``--num-processes 1``),
checks the exchange primitives bit for bit on its device, runs a small
host-partitioned ``run_fl`` and serves a forecast through a process-sharded
``ForecastServer``; the parent holds their reports bitwise to each other
and to its own one-process run.

The zoo's launchers (``launch.train``, ``launch.serve``) take ``--processes
N`` through :func:`launch_processes` and join with :func:`join_group`.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from contextlib import closing
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
BACKENDS = ("gloo", "nccl")
# A collective that waits longer than this for a peer raises (a peer that
# died must fail the run, not hang it).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

# The process group is process-wide state in torch.distributed itself; this
# records what initialize_distributed chose for it.
_GROUP: dict = {}


def _env(name: str, torch_name: str) -> Optional[str]:
    for key in (name, torch_name):
        val = os.environ.get(key)
        if val:
            return val
    return None


def _coordinator_from_env() -> Optional[str]:
    addr = os.environ.get(ENV_COORDINATOR)
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def process_device(device=DEFAULT_DEVICE, rank: int = 0) -> torch.device:
    """The device of process ``rank``: ``device`` as given, where a CUDA
    device without an index becomes ``cuda:{rank % device_count}``. Raises
    for CUDA without a GPU (``common.device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _make_store(address: str, world: int, rank: int,
                timeout: datetime.timedelta):
    """``file://PATH`` -> a FileStore (no port to collide on); ``[tcp://]
    HOST:PORT`` -> a TCPStore served by rank 0."""
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], world)
        store.set_timeout(timeout)
        return store
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    # under torch's launcher (torchrun) its agent serves the store already
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    return dist.TCPStore(host, int(port), world,
                         is_master=rank == 0 and not agent, timeout=timeout)


def _device_name(dev: torch.device) -> str:
    """What identifies ``dev`` across the processes of a host."""
    if dev.type != "cuda":
        return dev.type
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return f"cuda/{socket.gethostname()}/{uuid if uuid is not None else dev.index}"


def _pick_backend(requested: Optional[str], names: Sequence[str]) -> str:
    """The backend for processes on the devices ``names`` (one per rank, the
    same list on every rank, so every rank picks the same)."""
    cuda = [n for n in names if n.startswith("cuda/")]
    on_cpu = len(cuda) < len(names)
    shared = len(set(cuda)) < len(cuda)
    if requested is None:
        return "gloo" if on_cpu or shared else "nccl"
    if requested not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {requested!r}")
    if requested == "nccl" and (on_cpu or shared):
        raise ValueError(
            "backend='nccl' needs every process on a GPU of its own: NCCL "
            "refuses two ranks on one GPU and cannot run on the CPU; use "
            "backend='gloo', which stages the exchanges through host memory")
    return requested


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device=DEFAULT_DEVICE,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                           min_processes: int = 2) -> bool:
    """Join the process group described by the arguments or the environment
    (``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``,
    falling back to ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``).
    The coordinator is ``HOST:PORT`` (rank 0 serves a TCP store there) or
    ``file://PATH`` (a file store). Returns True in a group of
    ``min_processes`` or more processes, False for the no-op (no
    coordinator, or fewer processes), so a launcher can call it
    unconditionally; ``min_processes=1`` forms a group of one (the zoo's
    launchers, which then run their steps on a one-rank mesh). Idempotent.

    ``device`` is this process's device (:func:`process_device`: ``"cuda"``
    without an index takes ``cuda:{rank % device_count}``; the default
    raises without a GPU). ``backend`` is ``"gloo"``, ``"nccl"`` or None:
    gloo when a process is on the CPU or two share a GPU, NCCL when each has
    its own (the ranks tell each other their devices through the store
    first); an explicit ``"nccl"`` on a shared GPU or the CPU raises.
    ``timeout`` bounds every collective and the set-up."""
    address = coordinator_address or _coordinator_from_env()
    world = (num_processes if num_processes is not None
             else _env(ENV_NUM_PROCESSES, "WORLD_SIZE"))
    rank = (process_id if process_id is not None
            else _env(ENV_PROCESS_ID, "RANK"))
    if address is None or not world or int(world) < max(min_processes, 1):
        return False
    if is_initialized():
        return True
    world, rank = int(world), int(rank or 0)
    dev = process_device(device, rank)
    store = _make_store(address, world, rank, timeout)
    store.set(f"repro/device/{rank}", _device_name(dev))
    keys = [f"repro/device/{r}" for r in range(world)]
    store.wait(keys)
    chosen = _pick_backend(backend, [store.get(k).decode() for k in keys])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    _GROUP.update(backend=chosen, device=dev)
    return True


def join_group(device=DEFAULT_DEVICE) -> bool:
    """A zoo launcher's side of ``--processes N`` (:func:`launch_processes`)
    or of torch's launcher: join the group the environment describes, even
    a group of one, one device a rank: NCCL for ``"cuda"`` (raises when two
    ranks share a GPU: DTensor's collectives on CUDA tensors are NCCL's, and
    the zoo's steps never share a card under gloo), gloo on the CPU.
    Returns whether it joined one (False when the environment names
    none)."""
    cuda = torch.device(device).type == "cuda"
    return initialize_distributed(device=device,
                                  backend="nccl" if cuda else "gloo",
                                  min_processes=1)


def child_env() -> dict:
    """This environment with this package's ``src`` first on the path."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def _without_option(argv: Sequence[str], name: str) -> list:
    """``argv`` less ``name VALUE`` / ``name=VALUE``."""
    out, skip = [], False
    for arg in argv:
        if skip:
            skip = False
        elif arg == name:
            skip = True
        elif not arg.startswith(name + "="):
            out.append(arg)
    return out


def launch_processes(num_processes: int, module: str, argv: Sequence[str],
                     device=DEFAULT_DEVICE) -> int:
    """``python -m module ... --processes N``: N children ``python -m module
    argv`` (``--processes`` dropped) in one group (:func:`spawn_processes`,
    which ends the others when one fails); each joins it with
    :func:`join_group`. Relays process 0's output, and
    every failed child's error tail, once all have ended. Returns 0, or the
    first non-zero exit code in process order. On ``"cuda"`` it raises
    unless each rank gets a GPU of this host."""
    if num_processes < 1:
        raise ValueError(f"--processes must be >= 1, got {num_processes}")
    have = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and num_processes > have:
        raise ValueError(
            f"--processes {num_processes} on {device}: NCCL takes one GPU a "
            f"rank and refuses two ranks on one GPU, and this host has "
            f"{have}; the zoo's steps do not share a card under gloo")
    procs = spawn_processes(
        num_processes, [sys.executable, "-m", module,
                        *_without_option(argv, "--processes")],
        env=child_env(), timeout=float("inf"))
    sys.stdout.write(procs[0].stdout)
    for i, r in enumerate(procs):
        if r.returncode:
            sys.stderr.write(f"--- process {i} exited {r.returncode} ---\n"
                             f"{r.stderr[-4000:]}\n")
    return next((r.returncode for r in procs if r.returncode), 0)


def shutdown_distributed() -> None:
    """Leave the process group (no-op outside one)."""
    if is_initialized():
        dist.destroy_process_group()
    _GROUP.clear()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The group's backend (``"gloo"`` / ``"nccl"``), None outside a group."""
    return _GROUP.get("backend") if is_initialized() else None


def device() -> Optional[torch.device]:
    """This process's device in the group, None outside a group."""
    return _GROUP.get("device") if is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """True on the process that owns run-level side effects (checkpoint
    writes, result files): process 0."""
    return process_index() == 0


def block_range(total: int, index: Optional[int] = None,
                count: Optional[int] = None) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` row block of ``total`` rows owned by
    process ``index`` out of ``count``: the one ownership convention of
    every partitioned structure (client store, series, eval chunks)."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    return (total * index) // count, (total * (index + 1)) // count


def sync(tag: str = "repro") -> None:
    """Barrier across all processes of the group (no-op outside one).
    ``tag`` names the barrier for the reader; torch's barrier takes no
    name."""
    if not is_initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[device().index])
    else:
        dist.barrier()


def fetch(x):
    """The full value of ``x``: the identity, since no tensor of the port
    spans processes (the reference's gathers a process-sharded
    ``jax.Array``)."""
    return x


# ---------------------------------------------------------------------------
# exact exchanges
# ---------------------------------------------------------------------------


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the int32 words the merge sums: float32 viewed, int32 as is."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.int32:
        return t
    raise TypeError(f"merge_disjoint supports float32/int32 rows, got {t.dtype}")


def _transport_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` where the group's collectives run: this process's
    device under NCCL, host memory under gloo (pinned when ``t`` is on the
    card)."""
    if backend() == "nccl":
        return t.to(device(), copy=True)
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_reduce_bits_(t: torch.Tensor) -> None:
    """In place: the sum over the processes of ``t``'s int32 words (float32
    viewed as int32). ``t`` is a transport tensor (:func:`_transport_copy`)."""
    dist.all_reduce(_bits(t), op=dist.ReduceOp.SUM)


def all_gather_rows_(block: torch.Tensor, out: torch.Tensor) -> None:
    """``out`` <- every process's ``block`` stacked in process order (``out``
    has ``count * len(block)`` rows; both are transport tensors)."""
    dist.all_gather(list(out.chunk(dist.get_world_size())), block)


def merge_disjoint(*arrays):
    """EXACT reconstruction of row-partitioned tensors across processes.

    Each process passes, per array, the FULL-shape value (tensor or numpy)
    with zeros outside the rows it owns (ownership disjoint, covering every
    nonzero row). Float32 payloads are summed as int32 words, so the sum is
    bit transport: no ``-0.0 + 0.0`` normalization, no rounding, no order.
    Returns tensors on each input's device, bit-identical on every process
    to the unpartitioned originals (the inputs themselves outside a group;
    a group of one moves them through its transport all the same).
    Raises ``TypeError`` for dtypes other than float32 and int32."""
    tensors = [_as_tensor(a) for a in arrays]
    for t in tensors:
        _bits(t)
    if is_initialized():
        out = []
        for t in tensors:
            buf = _transport_copy(t.contiguous())
            all_reduce_bits_(buf)
            out.append(buf.to(t.device))
        tensors = out
    return tensors[0] if len(tensors) == 1 else tensors


def allgather_blocks(blocks, total_rows: int):
    """Concatenate EQUAL per-process row blocks in process order: process p
    passes its ``(total_rows / P, ...)`` block (a tensor or numpy array, or
    a list of them), every process receives the full ``(total_rows, ...)``
    tensors on each block's device. Pure data movement."""
    single = not isinstance(blocks, (list, tuple))
    blocks = [_as_tensor(b) for b in ([blocks] if single else blocks)]
    P = process_count()
    if total_rows % P:
        raise ValueError(f"allgather_blocks needs total_rows divisible by "
                         f"the process count, got {total_rows} over {P}")
    out = []
    for b in blocks:
        if b.shape[0] != total_rows // P:
            raise ValueError(f"block has {b.shape[0]} rows, expected "
                             f"{total_rows // P} (= {total_rows} / {P})")
        if not is_initialized():
            out.append(b)
            continue
        src = _transport_copy(b.contiguous())
        full = torch.empty((total_rows,) + tuple(b.shape[1:]), dtype=b.dtype,
                           device=src.device)
        all_gather_rows_(src, full)
        out.append(full.to(b.device))
    return out[0] if single else out


# ---------------------------------------------------------------------------
# launcher + the smoke
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_processes(num_processes: int, argv: Sequence[str],
                    env: Optional[dict] = None, timeout: float = 900.0,
                    coordinator: Optional[str] = None):
    """Run ``num_processes`` fresh interpreters of ``argv`` wired into one
    group: the coordinator on a free localhost port (or ``coordinator``,
    e.g. ``file://PATH``), the ``REPRO_*`` triplet set per child. Waits for
    all of them within ``timeout`` seconds in all; as soon as one exits
    non-zero the others are killed (a peer blocked in a collective would
    otherwise wait for its timeout), and on a timeout all are killed and
    ``subprocess.TimeoutExpired`` raises. Returns the
    ``subprocess.CompletedProcess`` of each child, in process order."""
    base = dict(os.environ if env is None else env)
    base[ENV_COORDINATOR] = coordinator or f"127.0.0.1:{_free_port()}"
    base[ENV_NUM_PROCESSES] = str(num_processes)
    procs, files = [], []
    deadline = time.monotonic() + timeout
    try:
        for p in range(num_processes):
            child_env = dict(base)
            child_env[ENV_PROCESS_ID] = str(p)
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files += [out, err]
            procs.append(subprocess.Popen(list(argv), env=child_env,
                                          stdout=out, stderr=err, text=True))
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(list(argv), timeout)
            time.sleep(0.02)
        done = []
        for proc, out, err in zip(procs, files[::2], files[1::2]):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.seek(0)
            err.seek(0)
            done.append(subprocess.CompletedProcess(
                proc.args, proc.returncode, out.read(), err.read()))
        return done
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()


SMOKE_MODEL = dict(look_back=16, horizon=2, d_model=8, num_heads=2, d_ff=8,
                   patch_len=8, stride=4)
SMOKE_K, SMOKE_S, SMOKE_ROUNDS = 8, 4, 4


def _smoke_fl(dev) -> dict:
    """The smoke's FL run (``driver="host"``, partitioned in a group): a
    digest of what a one-process run must reproduce bitwise."""
    import hashlib

    from repro_torch import random as R
    from repro_torch.core.fl.engine import FLConfig, run_fl
    from repro_torch.core.forecaster import get_forecaster
    from repro_torch.data.synthetic import nn5_synthetic
    from repro_torch.data.windowing import client_series_datasets

    series = nn5_synthetic(seed=0, num_clients=SMOKE_K, num_days=120)
    tr, _, te, _ = client_series_datasets(series, 16, 2)
    fl_cfg = FLConfig(policy="psgf", num_clients=SMOKE_K, local_steps=1,
                      batch_size=4, streaming_windows=True,
                      participation=SMOKE_S, client_chunk=2)
    fc = get_forecaster("logtst", **SMOKE_MODEL)
    hist = run_fl(fc.cfg, fl_cfg, tr, te, R.PRNGKey(0),
                  max_rounds=SMOKE_ROUNDS, patience=SMOKE_ROUNDS + 1,
                  eval_every=SMOKE_ROUNDS, driver="host", device=dev)
    w = hist["state"]["w_global"].detach().cpu().numpy()
    return {"losses": hist["train_loss"], "final_rmse": hist["final_rmse"],
            "comm": hist["comm"],
            "w_global_sha": hashlib.sha256(w.tobytes()).hexdigest()}


def smoke_serving(root: str, dev) -> dict:
    """Routed serving through a process-sharded server: process 0 writes
    two cluster checkpoints and the routing manifest into ``root``, every
    process restores only the clusters it owns
    (``ForecastServer.from_manifest(process_shard=...)``), serves one
    forecast and reports its shard gauges."""
    from repro_torch import random as R
    from repro_torch.core import forecast
    from repro_torch.core.forecaster import get_forecaster, save_forecaster
    from repro_torch.launch.serve_forecast import ForecastServer
    from repro_torch.models.spec import init_params_from_key

    idx, n = process_index(), process_count()
    fc = get_forecaster("logtst", **SMOKE_MODEL)
    if idx == 0:
        params = init_params_from_key(forecast.model_spec(fc.cfg),
                                      R.PRNGKey(1), torch.device("cpu"))
        subs = {}
        for c in range(2):
            sub = f"smoke_c{c}"
            save_forecaster(os.path.join(root, sub), fc, params, step=1)
            subs[str(c)] = sub
        with open(os.path.join(root, "routing.json"), "w") as f:
            json.dump({"generation": 0, "task": "smoke", "model": fc.name,
                       "look_back": 16, "horizon": 2, "clusters": 2,
                       "station_cluster": [0, 1, 0, 1],
                       "policies": {"psgf": subs}}, f)
    sync("smoke-manifest")
    server = ForecastServer.from_manifest(root, process_shard=(idx, n),
                                          device=dev)
    try:
        owned = sorted(server.engines)
        served = None
        if owned:
            y = server.predict(np.zeros((1, 1, 16), np.float32),
                               cluster=owned[0])
            served = list(map(int, y.shape))
        metrics = server.metrics_text()
    finally:
        server.close()
    return {"owned_clusters": owned, "served_shape": served,
            "shard_gauges": ("forecast_process_index" in metrics
                             and "forecast_process_count" in metrics)}


def _smoke_exchange(dev) -> bool:
    """The exchange primitives on ``dev`` over the group (through its
    transport, on the device under NCCL): bit for bit, ``-0.0`` included."""
    full = torch.arange(24, dtype=torch.float32).reshape(8, 3) * 0.5 - 3.0
    full[0, 0] = -0.0
    lo, hi = block_range(8)
    mine = torch.zeros_like(full)
    mine[lo:hi] = full[lo:hi]
    merged = merge_disjoint(mine.to(dev)).cpu()
    gathered = allgather_blocks(full[lo:hi].to(dev), 8).cpu()
    want = full.view(torch.int32)
    return bool(torch.equal(merged.view(torch.int32), want)
                and torch.equal(gathered.view(torch.int32), want))


def _smoke_child(device_arg: str) -> dict:
    if not initialize_distributed(device=device_arg, min_processes=1):
        raise RuntimeError("smoke child: no process group configured")
    try:
        dev = device()
        report = {"process": process_index(), "num_processes": process_count(),
                  "backend": backend(), "device": str(dev),
                  "exchange_exact": _smoke_exchange(dev), **_smoke_fl(dev)}
        report.update(smoke_serving(os.environ["REPRO_SMOKE_DIR"], dev))
        sync("smoke-done")
        return report
    finally:
        shutdown_distributed()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="torch.distributed multi-process launcher / smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="parent mode: spawn --num-processes children of "
                         "this module, check their reports bitwise")
    ap.add_argument("--smoke-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="every process's device: cpu, cuda (cuda:{rank %% "
                         "count}) or cuda:N (default cuda)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole smoke")
    args = ap.parse_args(argv)

    if args.smoke_child:
        print(json.dumps(_smoke_child(args.device)))
        return 0
    if not args.smoke:
        ap.error("pass --smoke (the only parent-mode action)")
    dev = resolve_device(args.device)
    want = _smoke_fl(dev)          # the one-process run the children must equal
    with tempfile.TemporaryDirectory(prefix="repro-torch-dist-smoke-") as root:
        env = child_env()
        env["REPRO_SMOKE_DIR"] = root
        procs = spawn_processes(
            args.num_processes,
            [sys.executable, "-m", "repro_torch.launch.distributed",
             "--smoke-child", "--device", args.device],
            env=env, timeout=args.timeout)
    reports = []
    for i, r in enumerate(procs):
        if r.returncode != 0:
            sys.stderr.write(f"--- child {i} stderr ---\n{r.stderr[-4000:]}\n")
            raise SystemExit(f"smoke child {i} exited {r.returncode}")
        reports.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for r in reports:
        for k in ("losses", "comm", "final_rmse", "w_global_sha"):
            if r[k] != want[k]:
                raise SystemExit(f"process {r['process']}: {k} differs from "
                                 f"the one-process run")
    all_owned = sorted(c for r in reports for c in r["owned_clusters"])
    if all_owned != [0, 1]:
        raise SystemExit(f"cluster shards wrong: {all_owned}")
    if not all(r["exchange_exact"] for r in reports):
        raise SystemExit("merge_disjoint / allgather_blocks moved a bit")
    if not all(r["shard_gauges"] for r in reports):
        raise SystemExit("a process lacks the shard gauges")
    if not all(r["served_shape"] == [1, 1, 2]
               for r in reports if r["owned_clusters"]):
        raise SystemExit("a served forecast has the wrong shape")
    print(json.dumps({"processes": args.num_processes,
                      "backend": reports[0]["backend"],
                      "devices": [r["device"] for r in reports],
                      "bitwise_to_one_process": True,
                      "owned_clusters": [r["owned_clusters"] for r in reports]}))
    print(f"distributed smoke OK: {args.num_processes} processes over "
          f"{reports[0]['backend']}, losses/comm/w_global/rmse bitwise equal "
          f"to the one-process run, clusters {all_owned} sharded across "
          f"processes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
