"""PSGF-DP: the paper's partial-sharing FL mapped onto data-parallel pods
(counterpart of ``repro.core.psgf_dp``).

Each **pod** is a "client" and a sync round is a global FL iteration. Pods
run H local steps on their own data (no traffic between pods), then one
:func:`psgf_sync`:

  * a subset of pods is *selected* (select_ratio);
  * a random subset of parameter **leaves** (share_ratio of the leaves) is
    aggregated across the selected pods into the global model (paper eq. 5)
    and written back to them (eq. 4);
  * every unselected pod receives a smaller *forwarded* leaf subset
    (forward_ratio) of the global model (eq. 6 — the PSGF idea).

``psgf_sync`` is the FL engine's :func:`~repro_torch.core.fl.engine.sync_round`
under the leaf-granularity :class:`~repro_torch.core.fl.policies.LeafPSGF`
policy, so selection, gates and wire bytes are bitwise the reference's for
the same key. Wire bytes scale with share_ratio / forward_ratio instead of
the model's size — the paper's Table II/III trade-off as bytes between pods.

On one card the pods are a leading axis of every leaf: ``local`` holds one
real copy per pod (:func:`stack_for_pods`), and :func:`make_local_train_step`
runs one independent step per pod in turn, holding one pod's gradients at a
time.

On a mesh with a ``pod`` axis (``launch.mesh.device_mesh``) the pod axis is
a mesh axis, as in the reference: :func:`stack_for_pods` lays the leading
pod axis out as ``Shard(0)`` over ``pod`` and :func:`on_mesh` the global
model as ``Replicate()``. The syncs then sum over the pod axis as the
reference's ``jnp.sum(..., axis=0)`` does, which is an all-reduce over
``pod`` (``launch.cost.collective_bytes`` counts it); in
:func:`psgf_sync_static` a leaf that no pod receives makes no collective
at all, the reference's point for it. ``make_local_train_step(...,
mesh=)`` runs each rank's pods on its own shard (``local_map`` over
``pod``): no collective, as the reference's vmapped step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from repro_torch.common import pytree_utils as pt
from repro_torch.core.fl import engine as E
from repro_torch.core.fl import policies as pol
from repro_torch.core.fl.masks import leaf_gates  # noqa: F401  (the reference's location)


@dataclasses.dataclass(frozen=True)
class PSGFDPConfig:
    share_ratio: float = 0.3
    forward_ratio: float = 0.2
    select_ratio: float = 0.5
    sync_interval: int = 8  # local steps between syncs (H)


def _over_mesh(tree):
    """A context for a sync over ``tree``'s leaves: DTensor's
    ``implicit_replication`` (the gates and masks are plain tensors) when
    they are DTensors, else nothing."""
    import contextlib

    from repro_torch.kernels import _sharded

    if not _sharded.any_dtensor(*pt.leaves(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _laid_as(x, like):
    """``x`` redistributed to ``like``'s placements when both are DTensors
    (a whole global leaf written into pod-split local leaves: each rank
    keeps its pods' part, nothing moves), else ``x``."""
    from repro_torch.kernels import _sharded

    if (_sharded.any_dtensor(x) and _sharded.any_dtensor(like)
            and tuple(x.placements) != tuple(like.placements)):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _whole(x):
    """A DTensor replicated over every mesh dimension (the global model):
    the pending sum over ``pod`` reduced, an all-reduce. Plain tensors pass."""
    from repro_torch.kernels import _sharded

    if not _sharded.any_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def psgf_sync(local, global_, key, cfg: PSGFDPConfig, num_pods: int):
    """One PSGF sync round (the engine's sync core).

    local  : tree whose leaves carry a leading pod axis (num_pods, ...).
    global_: the "server" model (the same tree without the pod axis).
    Returns (new_local, new_global, stats) with ``stats["wire_bytes"]``.
    """
    leading = pt.leaves(local)[0].shape[0]
    if num_pods != leading:
        raise ValueError(
            f"num_pods={num_pods} does not match local's pod axis ({leading})")
    policy = pol.LeafPSGF(share_ratio=cfg.share_ratio,
                          forward_ratio=cfg.forward_ratio)
    with record_function("psgf.sync"), _over_mesh(local):
        new_local, new_global, stats = E.sync_round(local, global_, key, policy,
                                                    cfg.select_ratio)
        new_global = pt.tree_map(_whole, new_global)
        new_local = pt.tree_map(_laid_as, new_local, local)
    return new_local, new_global, stats


def _pod_axis(mask, leaf):
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


def psgf_sync_static(local, global_, share_gates, fwd_gates, selected):
    """PSGF sync with host-decided gates: ``share_gates`` / ``fwd_gates``
    are trees of Python bools (the structure of ``global_``), ``selected``
    a sequence of Python bools, one per pod. A leaf that no pod receives is
    not touched (returned as it is): over pod-split DTensors it makes no
    collective, and a shared leaf makes one all-reduce over ``pod``."""
    num_pods = len(selected)
    c = max(1, sum(bool(s) for s in selected))
    device = pt.leaves(local)[0].device
    sel = torch.tensor([bool(s) for s in selected], device=device)

    def agg(leaf_local, leaf_global, gs):
        if not gs:
            return leaf_global
        w = _pod_axis(sel.to(leaf_local.dtype), leaf_local)
        return _whole(torch.sum(leaf_local * w, dim=0) / c)

    def dist(leaf_local, leaf_global, gs, gf):
        if not gs and not gf:
            return leaf_local
        if gs and gf:
            return _laid_as(leaf_global[None].expand(leaf_local.shape).clone(),
                            leaf_local)
        mask = sel if gs else ~sel
        return _laid_as(torch.where(_pod_axis(mask, leaf_local),
                                    leaf_global[None], leaf_local), leaf_local)

    with _over_mesh(local):
        new_global = pt.tree_map(agg, local, global_, share_gates)
        new_local = pt.tree_map(dist, local, new_global, share_gates, fwd_gates)

    leaves_g = pt.leaves(global_)
    sb = sum(leaf.numel() * leaf.element_size()
             for leaf, g in zip(leaves_g, pt.leaves(share_gates)) if g)
    fb = sum(leaf.numel() * leaf.element_size()
             for leaf, g in zip(leaves_g, pt.leaves(fwd_gates)) if g)
    stats = {"wire_bytes": float(sb * 2 * c + fb * (num_pods - c))}
    return new_local, new_global, stats


def sample_static_gates(rng, tree, ratio: float):
    """Host-side per-leaf Bernoulli gates for :func:`psgf_sync_static`, one
    ``rng.random()`` per leaf in leaf order (a numpy ``Generator``)."""
    return pt.tree_map_indexed(lambda _, __: bool(rng.random() < ratio), tree)


def full_sync(local, num_pods: int):
    """Baseline: the mean over pods of ALL parameters, written to every pod
    (over pod-split DTensors: an all-reduce of every leaf over ``pod``)."""
    with _over_mesh(local):
        new_global = pt.tree_map(lambda leaf: _whole(torch.mean(leaf, dim=0)),
                                 local)
        new_local = pt.tree_map(
            lambda g, leaf: _laid_as(g[None].expand(leaf.shape).clone(), leaf),
            new_global, local)
    stats = {"wire_bytes": 2.0 * num_pods * pt.tree_size_bytes(new_global)}
    return new_local, new_global, stats


def stack_for_pods(tree, num_pods: int, mesh=None):
    """One real copy of the tree per pod, along a new leading pod axis (the
    pods diverge, so no leaf may be a broadcast view). With ``mesh`` (a
    ``DeviceMesh`` with a ``pod`` axis) each leaf is a DTensor split along
    the pod axis over ``pod`` and whole over the other mesh axes."""
    stacked = pt.tree_map(
        lambda x: x[None].repeat((num_pods,) + (1,) * x.dim()), tree)
    if mesh is None:
        return stacked
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    placements = tuple(Shard(0) if name == "pod" else Replicate()
                       for name in mesh.mesh_dim_names)
    if "pod" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no 'pod'")
    return pt.tree_map(lambda x: distribute_tensor(x, mesh, placements), stacked)


def on_mesh(tree, mesh):
    """The global model over ``mesh``: every leaf a DTensor whole on every
    mesh axis (``Replicate()``)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    placements = (Replicate(),) * mesh.ndim
    return pt.tree_map(lambda x: distribute_tensor(x, mesh, placements), tree)


def init_pod_opt_state(optimizer, local):
    """The optimizer's state for pod-stacked params (the reference's
    ``vmap(optimizer.init)``): the moments carry the pod axis, and each pod
    counts its own steps."""
    first = pt.leaves(local)[0]
    from repro_torch.kernels import _sharded

    if _sharded.any_dtensor(first):
        # the moments and counts laid out as the pods: split over ``pod``
        from torch.distributed.tensor import distribute_tensor

        mesh, placements = first.device_mesh, first.placements
        zeros = optimizer.init(pt.tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.to_local().device),
            local))
        zeros["t"] = zeros["t"].expand(first.shape[0]).clone()
        return pt.tree_map(lambda x: distribute_tensor(x, mesh, placements), zeros)
    state = optimizer.init(local)
    num_pods = first.shape[0]
    state["t"] = state["t"].expand(num_pods).clone()
    return state


def make_local_train_step(loss_fn, optimizer, mesh=None):
    """A per-pod local train step over the leading pod axis.

    ``loss_fn(params, batch) -> (loss, metrics)``; ``optimizer`` from
    ``repro_torch.optim``. ``step(stacked_params, stacked_opt,
    stacked_batch) -> (params, opt_state, loss (num_pods,))`` runs each
    pod's forward, backward and optimizer update in turn and writes the
    results into ``stacked_params`` and ``stacked_opt`` (which it returns):
    the pods stay independent, as the reference's ``vmap``, and one pod's
    gradients are held at a time.

    With ``mesh``, the stacked trees are DTensors split over ``pod`` (see
    :func:`stack_for_pods`; the optimizer state and batch laid out alike)
    and each rank runs that step on its own pods' shards through
    ``local_map``: no collective. Indexing a pod of the split axis on the
    DTensors would gather it, so the loop runs only inside.
    """
    step = _local_train_step(loss_fn, optimizer)
    if mesh is None:
        return step
    from torch.distributed.tensor.experimental import local_map

    def sharded(stacked_params, stacked_opt, stacked_batch):
        trees = (stacked_params, stacked_opt, stacked_batch)
        leaves = [pt.leaves(t) for t in trees]
        flat = [x for ls in leaves for x in ls]
        sizes = [len(ls) for ls in leaves]

        def local(*xs):
            parts, at = [], 0
            for tree, n in zip(trees, sizes):
                parts.append(pt.unflatten(
                    [(path, x) for (path, _), x in
                     zip(pt.flatten_with_paths(tree), xs[at:at + n])]))
                at += n
            _, _, losses = step(*parts)
            return losses

        pod_split = tuple(flat[0].placements)
        losses = local_map(local, out_placements=list(pod_split),
                           in_placements=tuple(tuple(x.placements) for x in flat),
                           device_mesh=mesh)(*flat)
        return stacked_params, stacked_opt, losses

    return sharded


def _local_train_step(loss_fn, optimizer):
    """:func:`make_local_train_step` on one device: a loop over the pods."""

    def step(stacked_params, stacked_opt, stacked_batch):
        num_pods = pt.leaves(stacked_params)[0].shape[0]
        losses = []
        for p in range(num_pods):
            pick = lambda x: x[p]  # noqa: E731
            params = pt.tree_map(pick, stacked_params)
            (loss, _), grads = pt.value_and_grad(loss_fn, params,
                                                 pt.tree_map(pick, stacked_batch))
            with record_function("train.optimizer"):
                optimizer.update_(params, grads, pt.tree_map(pick, stacked_opt))
            del grads
            losses.append(loss)
        return stacked_params, stacked_opt, torch.stack(losses)

    return step
