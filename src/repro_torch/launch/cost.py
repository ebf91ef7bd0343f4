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

Not ported: ``collective_bytes`` and its cross-pod classifier, which parse
XLA's HLO text. PyTorch produces none; its collective bytes come from
DTensor's ``CommDebugMode`` on a real mesh of several GPUs (ROADMAP Queue
A 11). Nor ``cost_analysis``'s ``bytes accessed`` and ``transcendentals``,
which are XLA's own estimates.
"""
from __future__ import annotations

import torch
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

