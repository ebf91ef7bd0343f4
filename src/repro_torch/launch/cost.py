"""Cost and memory accounting of a step on ``meta`` tensors (counterpart of
``repro.launch.hlo_analysis``, which reads them off XLA's compiled HLO).

  * :func:`cost_summary` — the matmul and convolution FLOPs of one call,
    counted by ``torch.utils.flop_counter.FlopCounterMode`` while it runs on
    meta tensors (nothing is computed or allocated). A train step's count
    holds its forward, its backward and the remat recompute. Kernel
    wrappers run their plain versions' arithmetic on meta tensors, so
    flash attention counts the full S x S products, where the kernel skips
    the blocks its mask drops.
  * the reference's ``memory_summary`` in two parts: :func:`argument_bytes`,
    the per-device bytes of a step's arguments (params, optimizer state,
    batch or cache) from their shard shapes, which is exact; and
    :func:`peak_bytes`, one device's peak while a step runs, estimated by
    ``torch.distributed._tools.mem_tracker.MemTracker`` under
    ``FakeTensorMode``, counting the arguments, the gradients, the
    optimizer's temporaries and the activations the port's remat keeps.

  * :func:`collective_bytes` — the reference's collective accounting
    (``hlo_analysis.collective_bytes``, which reads XLA's HLO text), read
    here from the functional collectives a step over DTensors issues
    (``torch.ops._c10d_functional.*``, their coalesced forms and DTensor's
    ``shard_dim_alltoall``), through a ``TorchDispatchMode``: the same keys
    and the same bytes model (per participating device, from each op's
    result bytes, an all-reduce twice), and ``cross_pod`` from the ranks of
    each op's group. On a ``fake`` group (``launch.mesh.accounting_group``)
    nothing moves, so a step on the production meshes is counted on one
    CPU process, as the reference counts it on 512 placeholder devices.
    The ops are DTensor's choice of collectives, not XLA's, so a model
    step's bytes are not the reference's.

Not ported: ``cost_analysis``'s ``bytes accessed`` and ``transcendentals``,
which are XLA's own estimates.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common import pytree_utils as pt


def cost_summary(fn, *args, **kwargs) -> dict:
    """``{"flops": matmul and convolution FLOPs of fn(*args, **kwargs),
    "flops_by_op": {aten op: FLOPs}}`` (2 FLOPs a multiply-add)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = counter.get_flop_counts().get("Global", {})
    return {"flops": int(counter.get_total_flops()),
            "flops_by_op": {str(op): int(n) for op, n in sorted(
                by_op.items(), key=lambda kv: str(kv[0]))}}


def argument_bytes(**trees) -> dict:
    """Per-device bytes of each named tree of ``ShardedStruct``s
    (``launch.api``) and their ``total``."""
    out = {name: sum(s.shard_nbytes for s in pt.leaves(tree))
           for name, tree in trees.items()}
    out["total"] = sum(out.values())
    return out


def peak_bytes(fn, *args) -> dict:
    """One device's peak while ``fn(*args)`` runs on meta tensors:
    ``MemTracker`` under ``FakeTensorMode`` with every tensor of ``args``
    counted from the start. Returns ``{"peak_bytes", "arguments_bytes"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    # the arguments become fake tensors first: a view of a fake tensor shares
    # its storage, where one of a plain meta tensor would be counted anew;
    # ``allow_non_fake_inputs`` admits the scalars ``Tensor.new_tensor``
    # makes inside the mode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = pt.tree_map(lambda x: mode.from_tensor(x) if isinstance(x, torch.Tensor)
                       else x, list(args))
    tensors = [x for x in pt.leaves(args) if isinstance(x, torch.Tensor)]
    arguments = sum(t.untyped_storage().nbytes() for t in
                    {t.untyped_storage()._cdata: t for t in tensors}.values())
    with mode:
        tracker = MemTracker()
        tracker.track_external(*tensors)
        with tracker:
            fn(*args)
        peak = tracker.get_tracker_snapshot("peak")
    return {"peak_bytes": int(sum(dev["Total"] for dev in peak.values())),
            "arguments_bytes": int(arguments)}



# the reference's op names (``hlo_analysis._COLLECTIVES``), in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (``torch.ops._c10d_functional``, and the autograd
# variants where they reach the mode) -> the reference's op
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def group_ranks(group_name: str):
    """The global ranks of the process group named ``group_name``, or None
    when it cannot be resolved."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    try:
        return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))
    except Exception:  # noqa: BLE001  (an unknown name: unresolved)
        return None


def spans_pods(ranks, pod_size: int) -> bool:
    """True if ``ranks`` hold ranks of more than one pod (``rank //
    pod_size`` differs), and, as the reference does when it finds no
    groups, when the group could not be resolved (``ranks`` None)."""
    if ranks is None:
        return True
    return len({r // pod_size for r in ranks}) > 1


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class _CollectiveCounter(TorchDispatchMode):
    """Counts each functional collective's result bytes by the reference's
    op name. ``records`` holds ``(op, bytes, ranks)`` per op counted."""

    def __init__(self):
        super().__init__()
        self.records = []
        self._inside_fallback = 0

    def add(self, op: str, nbytes: int, ranks):
        if ranks is not None and len(ranks) == 1:
            return  # a group of one moves nothing (XLA emits no such op)
        self.records.append((op, nbytes * (2 if op == "all-reduce" else 1), ranks))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # a mode runs before a subclass: let DTensor turn the op into
            # local ops and collectives first, which then come here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = _FUNCTIONAL.get(func._opname) if func.namespace in _NAMESPACES else None
        if op is not None and not self._inside_fallback:
            name = kwargs.get("group_name", args[-1])
            self.add(op, _nbytes(out), group_ranks(name) if isinstance(name, str)
                     else None)
        return out


@contextlib.contextmanager
def _all_to_all_as_such(counter: _CollectiveCounter):
    """DTensor's all-to-all on a CPU mesh falls back to an all-gather and a
    chunk (Gloo has no all-to-all, ``_collective_utils.shard_dim_alltoall``);
    while counting, that fallback is counted as the all-to-all it stands
    for: its result bytes (the input's, as a real all-to-all's), over the
    mesh dimension's group."""
    from torch.distributed.tensor import placement_types

    original = placement_types.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = mesh.get_group(mesh_dim)
        counter.add("all-to-all", _nbytes(input), group_ranks(group.group_name))
        counter._inside_fallback += 1
        try:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter._inside_fallback -= 1

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


def summarize_collectives(records, pod_size=None) -> dict:
    """The reference's dict from ``(op, bytes, ranks)`` records:
    ``{op: bytes, ..., "total", "count"}``, and ``"cross_pod"`` given
    ``pod_size`` (the bytes of ops whose group spans pods)."""
    out = defaultdict(float)
    cross_pod = 0.0
    for op, nbytes, ranks in records:
        out[op] += nbytes
        if pod_size is not None and spans_pods(ranks, pod_size):
            cross_pod += nbytes
    out["total"] = sum(out[c] for c in COLLECTIVES if c in out)
    out["count"] = len(records)
    if pod_size is not None:
        out["cross_pod"] = cross_pod
    return dict(out)


@contextlib.contextmanager
def counting_collectives():
    """Counts the collectives issued inside the block; yields the list of
    ``(op, bytes, ranks)`` records it fills (:func:`summarize_collectives`
    turns them into the reference's dict)."""
    counter = _CollectiveCounter()
    with _all_to_all_as_such(counter), counter:
        yield counter.records


def collective_bytes(fn, *args, pod_size=None, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` (over DTensors) and returns the
    reference's ``collective_bytes`` dict for the collectives it issued:
    per op ``all-gather``, ``all-reduce`` (result bytes twice),
    ``reduce-scatter``, ``all-to-all`` and ``collective-permute`` bytes per
    participating device, ``total``, ``count``, and with ``pod_size``
    ``cross_pod``: the bytes of ops whose group's ranks span more than one
    ``rank // pod_size``. An op over a group of one rank moves nothing and
    is not counted."""
    with counting_collectives() as records:
        fn(*args, **kwargs)
    return summarize_collectives(records, pod_size)
