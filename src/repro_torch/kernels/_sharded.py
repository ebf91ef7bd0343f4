"""The kernel wrappers over DTensors (``launch.steps`` with a mesh).

A wrapper given DTensors runs its kernel on each rank's local shards
through ``torch.distributed.tensor.experimental.local_map`` wherever the
inputs' placements keep the op local (each wrapper names the dimensions it
may split: flash attention its batch or heads, ssm_scan its batch or
channels, psgf_mix its rows or D). A placement that does not is first
redistributed to ``Replicate()``, which is a collective that
``launch.cost.collective_bytes`` counts; nothing switches to another
version quietly. Inside, the wrapper sees plain tensors: on the card the
kernel launches, on the CPU or ``meta`` its plain version runs, as for any
plain call.
"""
from __future__ import annotations

import sys


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. None exists before
    ``torch.distributed.tensor`` is imported, so a plain step reads one
    dict entry here and imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def any_dtensor(*tensors) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor) for t in tensors)


def mesh_of(*tensors):
    """The device mesh of the DTensors among ``tensors`` (one mesh)."""
    from torch.distributed.tensor import DTensor

    meshes = {t.device_mesh for t in tensors if isinstance(t, DTensor)}
    if len(meshes) != 1:
        raise ValueError(f"kernel inputs on {len(meshes)} device meshes")
    return meshes.pop()


def shard_offset(size: int, mesh, placements, dim: int) -> int:
    """The global index, along ``dim`` of ``size`` elements, of this
    rank's first element under ``placements``: DTensor's even chunks
    (``ceil(size / n)``, the last ones short or empty), the mesh dimensions
    that shard ``dim`` taken left to right. In Python ints, so it holds
    under a ``FakeTensorMode`` (the dry run's), where DTensor's own
    ``compute_local_shape_and_global_offset`` makes a tensor of the
    offsets and cannot read it back."""
    coordinate = mesh.get_coordinate()
    offset = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            start = min(chunk * coordinate[i], size)
            offset += start
            size = min(chunk, size - start)
    return offset


def run_local(fn, mesh, args, in_placements, out_placements,
              in_grad_placements=None):
    """``fn`` on the local shards of ``args``: each tensor of ``args`` laid
    out as its entry of ``in_placements`` first (a plain tensor is taken as
    replicated; a redistribution is counted like any other), then
    ``local_map``. ``None`` in ``in_placements`` marks a non-tensor
    argument. ``in_grad_placements`` says how each input's gradient lies
    (default: as the input); an input replicated over a mesh dimension
    whose ranks each use a part of it gets a ``Partial()`` gradient
    there."""
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    laid = []
    for a, want in zip(args, in_placements):
        if want is None:
            laid.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != tuple(want):
            a = a.redistribute(mesh, want)
        laid.append(a)
    # local_map reads a tuple as one entry per output: a single output's
    # placements go as a list
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)
    else:
        out_placements = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(in_grad_placements)),
                     device_mesh=mesh)(*laid)


def attention_layouts(q, k, mesh):
    """Per mesh dimension, how attention over q (B, Sq, H, hd) and k / v
    (B, Skv, KV, hd) stays local: ``(q's, k's and v's, their gradients')``
    placements. A batch split stays (k, v split alike); so does a head
    split when the kv heads split alike, or when there is one kv head
    (whole on every rank, its gradient then a sum over the ranks); any
    other split is made whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    B, _, H, _ = q.shape
    KV = k.shape[2]
    qpl = q.placements if isinstance(q, DTensor) else (Replicate(),) * mesh.ndim
    kpl = k.placements if isinstance(k, DTensor) else (Replicate(),) * mesh.ndim
    rows = []
    for i, (qp, kp) in enumerate(zip(qpl, kpl)):
        n = mesh.size(i)
        if qp.is_shard(0) and B % n == 0:
            rows.append((Shard(0), Shard(0), Shard(0)))
        elif qp.is_shard(2) and H % n == 0 and kp.is_shard(2) and KV % n == 0:
            rows.append((Shard(2), Shard(2), Shard(2)))
        elif qp.is_shard(2) and H % n == 0 and KV == 1:
            rows.append((Shard(2), Replicate(), Partial()))
        else:
            rows.append((Replicate(),) * 3)
    return tuple(tuple(r[j] for r in rows) for j in range(3))


def attention_local(fn, q, k, v, *batch_args, whole=()):
    """``fn(q, k, v, *batch_args, *whole)`` (an attention over plain
    tensors) on each rank's shards, laid out by :func:`attention_layouts`;
    ``batch_args`` are batch-leading tensors (masks) split as q's batch,
    or non-tensors; ``whole`` tensors (a mask bias) are whole on every
    rank. Returns q's layout."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    tensors = [a for a in batch_args + tuple(whole) if isinstance(a, torch.Tensor)]
    mesh = mesh_of(q, k, v, *tensors)
    q_in, kv_in, kv_grad = attention_layouts(q, k, mesh)
    b_in = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in q_in)
    extra = tuple(b_in if isinstance(a, torch.Tensor) else None for a in batch_args)
    extra += ((Replicate(),) * mesh.ndim,) * len(whole)
    return run_local(fn, mesh, (q, k, v) + batch_args + tuple(whole),
                     (q_in, kv_in, kv_in) + extra, q_in,
                     (q_in, kv_grad, kv_grad) + extra)


def local_product(fn, x, w, w_out: dict, w_contract: dict):
    """``fn(x, w)``, a product of a batch-leading ``x`` with a weight ``w``,
    on each rank's shards, with the layout fixed per mesh dimension
    instead of left to DTensor's choice (which can split a merged
    dimension that a later view cannot take):

      * ``x``'s batch split: stays; ``w`` whole there (an FSDP all-gather
        if the rules split it), the output split alike, ``w``'s gradient a
        sum over the ranks;
      * a split of a contracted dimension (``w_contract``: ``w`` dim ->
        ``x`` dim; on ``x``, or else taken from ``w``): both split alike,
        the output a pending sum (``Partial``);
      * a split of one of ``w``'s output dimensions (``w_out``: ``w`` dim
        -> output dim): stays, ``x`` whole, the output split there, ``x``'s
        gradient a sum over the ranks;
      * anything else is made whole.
    """
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = mesh_of(x, w)
    xpl = x.placements if isinstance(x, DTensor) else (Replicate(),) * mesh.ndim
    wpl = w.placements if isinstance(w, DTensor) else (Replicate(),) * mesh.ndim
    x_dims = {xd: wd for wd, xd in w_contract.items()}
    R = Replicate()
    rows = []   # (x_in, w_in, out, x_grad, w_grad)
    for xp, wp in zip(xpl, wpl):
        if xp.is_shard(0) and 0 not in x_dims:
            rows.append((Shard(0), R, Shard(0), Shard(0), Partial()))
        elif xp.is_shard() and xp.dim in x_dims:
            wd = x_dims[xp.dim]
            rows.append((xp, Shard(wd), Partial(), xp, Shard(wd)))
        elif not xp.is_shard() and wp.is_shard() and wp.dim in w_contract:
            rows.append((Shard(w_contract[wp.dim]), wp, Partial(),
                         Shard(w_contract[wp.dim]), wp))
        elif not xp.is_shard() and wp.is_shard() and wp.dim in w_out:
            rows.append((R, wp, Shard(w_out[wp.dim]), Partial(), wp))
        else:
            rows.append((R,) * 5)
    x_in, w_in, out, x_grad, w_grad = (tuple(r[j] for r in rows) for j in range(5))
    if not isinstance(w, torch.Tensor):
        raise TypeError("local_product wants a weight tensor")
    return run_local(fn, mesh, (x, w), (x_in, w_in), out, (x_grad, w_grad))


def heads_local(fn, seq_args, weights, outs):
    """``fn(*seq_args, *weights)``, a recurrence over positions that keeps
    batch rows and heads apart (the xLSTM cells), on each rank's shards.
    ``seq_args`` are (B, S, H, ...) tensors, ``weights`` (H, ...), and
    ``outs`` names each output's layout: ``"bsh"`` (B, S, H, ...) or
    ``"bh"`` (B, H, ...). Per mesh dimension of the first input's
    placements, a batch split stays (the weights whole, their gradient a
    sum over the ranks), a head split that the heads divide stays (the
    weights split alike), anything else is made whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = mesh_of(*seq_args, *weights)
    first = seq_args[0]
    pl = first.placements if isinstance(first, DTensor) else (Replicate(),) * mesh.ndim
    H = first.shape[2]
    R = Replicate()
    rows = []   # (seq, weights, weights' gradient, bsh out, bh out)
    for i, p in enumerate(pl):
        if p.is_shard(0):
            rows.append((Shard(0), R, Partial(), Shard(0), Shard(0)))
        elif p.is_shard(2) and H % mesh.size(i) == 0:
            rows.append((Shard(2), Shard(0), Shard(0), Shard(2), Shard(1)))
        else:
            rows.append((R,) * 5)
    seq, w, w_grad, bsh, bh = (tuple(r[j] for r in rows) for j in range(5))
    out = tuple(bsh if kind == "bsh" else bh for kind in outs)
    n_seq, n_w = len(seq_args), len(weights)
    return run_local(fn, mesh, tuple(seq_args) + tuple(weights),
                     (seq,) * n_seq + (w,) * n_w, out,
                     (seq,) * n_seq + (w_grad,) * n_w)
