"""Meshes of the port (counterpart of ``repro.launch.mesh``).

A mesh here is a small plain object, :class:`Mesh`: the processes along one
axis (this process's index and their count, and the backend of the
default process group of ``launch.distributed``) and this process's devices
on it. Row
ownership along the axis is ``launch.distributed.block_range``.

  * :func:`make_client_mesh` — the FL client axis: this process's local
    devices, or with ``multi_host=True`` every process of the initialized
    group over every local device of each, so that
    ``run_fl(client_mesh=...)`` holds only this process's block of the
    client rows;
  * :func:`make_batch_mesh` — serving's batch axis over the local devices.

On one local device either is the unsharded path, as in the reference. A
mesh of one process may hold several local devices and may name one device
more than once (``Mesh("clients", (d, d))``: two shards of one device, the
counterpart of the reference's virtual host devices), which is what
``run_fl(client_mesh=...)`` and ``ForecastServer(shard_batch=True)`` run
over in one process, one shard a device of the mesh.

The zoo's meshes are :class:`AbstractMesh`es: named axes and their sizes,
all that ``sharding.rules`` reads.

  * :func:`make_production_mesh` — the reference's production layouts,
    ``(16, 16)`` over ``("data", "model")`` on one pod and ``(2, 16, 16)``
    over ``("pod", "data", "model")`` on two, with no devices behind them:
    the dry run (``launch.dryrun``) accounts specs and bytes on them, so
    that the rules and the accounting agree with the reference's;
  * :func:`make_host_mesh` — the reference's host mesh, ``(n // model,
    model)`` over ``("data", "model")`` with one device a rank: the ranks of
    the initialized process group (one process a GPU under NCCL, or CPU
    processes under gloo), or without a group this process's one local
    device, ``(1, 1)``, where every shard shape is the whole shape.

:func:`device_mesh` lays an :class:`AbstractMesh` out as a
``torch.distributed`` ``DeviceMesh`` with the same axis names and sizes,
rank ``r`` at the row-major place ``r`` (the reference's device order), so
that DTensor placements (``sharding.rules.spec_to_placements``) can carry
the specs. It needs a default process group of at least ``mesh.size``
ranks: a real one on devices (the host mesh: one rank a GPU over NCCL, or
CPU ranks over gloo), or for accounting :func:`accounting_group`, one process playing
rank 0 of a ``fake`` group in which no collective moves data (the
reference's dry run lowers on 512 placeholder CPU devices the same way).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import distributed as D


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis across processes: this process is ``index`` of ``count``
    and computes on ``devices`` (its own devices on the axis, one shard
    each; a device may repeat); collectives run in the default process
    group over ``backend`` (None in one process)."""

    axis: str
    devices: Tuple[torch.device, ...]
    index: int = 0
    count: int = 1
    backend: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def rows(self, total: int) -> Tuple[int, int]:
        """The ``[lo, hi)`` block of ``total`` rows this process owns."""
        return D.block_range(total, self.index, self.count)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named mesh axes and their sizes (``.shape``, an ordered axis -> size
    mapping, as a jax mesh's), and the local devices it lays out, if any."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """``(16, 16)`` over ``("data", "model")`` on one pod; ``(2, 16, 16)``
    over ``("pod", "data", "model")`` for the 2-pod, 512-chip deployment."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, *, device=DEFAULT_DEVICE) -> AbstractMesh:
    """``(n // model, model)`` over ``("data", "model")`` with ``model``
    clamped to ``n``, as the reference's, over ``n`` devices, one a rank.
    Under an initialized process group ``n`` is its world size and this
    process lays out its group device (:func:`group_device`: its GPU under
    NCCL, the CPU under gloo); without one ``n`` is 1, this process's one
    local device (the GPU for ``"cuda"``; raises without one). Several
    local GPUs without a group raise: a ``DeviceMesh`` takes one process a
    device, which ``--processes N`` of ``launch.train`` / ``launch.serve``
    starts (or torch's own launcher)."""
    import torch.distributed as dist

    if dist.is_initialized():
        n, devices = dist.get_world_size(), (group_device(device),)
    else:
        devices = _local_devices(device)
        if len(devices) > 1:
            raise NotImplementedError(
                f"a host mesh over {len(devices)} local devices of one "
                f"process: the zoo's DTensor steps take one process a GPU; "
                f"start them with `python -m repro_torch.launch.train "
                f"--processes {len(devices)}` (or launch.serve), or under "
                f"torch's launcher")
        n = 1
    model = min(model, n)
    if model < 1 or n % model:
        raise ValueError(f"make_host_mesh(model={model}) does not divide "
                         f"the {n} devices")
    return AbstractMesh(("data", "model"), (n // model, model), devices)


def group_device(device=DEFAULT_DEVICE) -> torch.device:
    """This process's device in the initialized process group: the one
    ``launch.distributed.initialize_distributed`` recorded, or else
    ``device`` for this rank (``distributed.process_device``). Raises when
    ``device`` names another device type than the group's."""
    dev = D.device() or D.process_device(device, D.process_index())
    if torch.device(device).type != dev.type:
        raise ValueError(f"device {device!r}, but this process's group "
                         f"device is {dev}")
    return dev


def _local_devices(device) -> Tuple[torch.device, ...]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def make_client_mesh(axis: str = "clients", *, multi_host: bool = False,
                     device=None) -> Mesh:
    """The FL client mesh. Default: this process alone over its local
    devices (``device``, default ``"cuda"``: every local GPU; raises without
    one). ``multi_host=True`` under an initialized group
    (``launch.distributed.initialize_distributed``): every local device of
    every process (:func:`_process_devices`), in process order as the
    reference's, shard ``p * n + i`` device ``i`` of process ``p``, so that
    ``run_fl(driver="scan"|"while", client_mesh=...)`` spans the processes.
    A mesh with a device repeated (several shards of one card) is built as
    ``Mesh(axis, devices, index, count, backend)``."""
    if multi_host and D.is_initialized():
        dev = D.device()
        if device is not None and D.process_device(device, D.process_index()) != dev:
            raise ValueError(f"make_client_mesh(device={device!r}): this "
                             f"process's group device is {dev}")
        return Mesh(axis, _process_devices(), D.process_index(),
                    D.process_count(), D.backend())
    return Mesh(axis, _local_devices(DEFAULT_DEVICE if device is None else device))


def _process_devices() -> Tuple[torch.device, ...]:
    """This process's local devices in the initialized group, its group
    device first: the host's ``G`` GPUs dealt over the group's ``P``
    processes as ``distributed.process_device`` deals each its first
    (process ``r`` takes ``cuda:r``, ``cuda:r + P``, ..., ``G // P`` of
    them, as many in every process); its group device alone where ``G <
    2 P``, on the CPU, or where it was given another GPU than ``cuda:r``."""
    dev, r, P = D.device(), D.process_index(), D.process_count()
    if dev.type != "cuda" or dev.index != r or torch.cuda.device_count() < 2 * P:
        return (dev,)
    return tuple(torch.device("cuda", r + k * P)
                 for k in range(torch.cuda.device_count() // P))


def make_batch_mesh(axis: str = "batch", device=DEFAULT_DEVICE) -> Mesh:
    """Serving's batch mesh over this process's local devices (every local
    GPU for ``"cuda"``)."""
    return Mesh(axis, _local_devices(device))


@contextlib.contextmanager
def accounting_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks with this
    process as rank 0, destroyed on exit: DTensors over a
    :func:`device_mesh` on it run every op on rank 0's shards and issue
    the collectives a real mesh would, which move no data
    (``launch.cost.collective_bytes`` counts them). Raises if a default
    group exists already, so it never replaces a real one.

    The ``fake`` backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg`` and by nothing public:
    ``init_process_group("fake", ...)`` fails ("Unknown c10d backend type")
    until that module has been imported."""
    import torch.distributed as dist
    from torch.testing._internal.distributed import fake_pg

    if dist.is_initialized():
        raise RuntimeError(
            "accounting_group: a default process group exists already "
            f"(backend {dist.get_backend()!r}, world {dist.get_world_size()}); "
            "the accounting group never replaces one")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: AbstractMesh, device_type: Optional[str] = None):
    """``mesh`` as a ``DeviceMesh`` of ``device_type`` over the default
    process group: the same axis names and sizes, ranks ``0 ..
    mesh.size - 1`` in row-major order. ``device_type`` defaults to the
    type of the mesh's device (``"cuda"`` for :func:`make_host_mesh` over
    an NCCL group, ``"cpu"`` over gloo), or ``"cpu"`` for a mesh without
    devices (under :func:`accounting_group`, for accounting)."""
    if device_type is None:
        device_type = mesh.devices[0].type if mesh.devices else "cpu"
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a default process group "
                           "(accounting_group, or launch.distributed)")
    if dist.get_world_size() < mesh.size:
        raise ValueError(f"a {mesh.axis_sizes} mesh needs {mesh.size} ranks; "
                         f"the default group has {dist.get_world_size()}")
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


def host_mesh(device=DEFAULT_DEVICE):
    """``(DeviceMesh, host mesh, this process's device)`` for the zoo's
    launchers: under an initialized process group the reference's host
    mesh over it (:func:`make_host_mesh`), without one ``(None, None,
    device)``."""
    if not D.is_initialized():
        return None, None, resolve_device(device)
    host = make_host_mesh(device=device)
    return device_mesh(host), host, group_device(device)


def global_value(t) -> torch.Tensor:
    """A DTensor's whole value (a collective that every rank joins); a
    plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
