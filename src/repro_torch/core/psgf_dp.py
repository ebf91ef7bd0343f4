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
time. The reference's point for :func:`psgf_sync_static` — an HLO in which
unshared leaves make no collective — has no PyTorch meaning here; its gate
math and byte counts are ported as they are.
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
    with record_function("psgf.sync"):
        return E.sync_round(local, global_, key, policy, cfg.select_ratio)


def _pod_axis(mask, leaf):
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


def psgf_sync_static(local, global_, share_gates, fwd_gates, selected):
    """PSGF sync with host-decided gates: ``share_gates`` / ``fwd_gates``
    are trees of Python bools (the structure of ``global_``), ``selected``
    a sequence of Python bools, one per pod. A leaf that no pod receives is
    not touched (returned as it is)."""
    num_pods = len(selected)
    c = max(1, sum(bool(s) for s in selected))
    device = pt.leaves(local)[0].device
    sel = torch.tensor([bool(s) for s in selected], device=device)

    def agg(leaf_local, leaf_global, gs):
        if not gs:
            return leaf_global
        w = _pod_axis(sel.to(leaf_local.dtype), leaf_local)
        return torch.sum(leaf_local * w, dim=0) / c

    new_global = pt.tree_map(agg, local, global_, share_gates)

    def dist(leaf_local, leaf_global, gs, gf):
        if not gs and not gf:
            return leaf_local
        if gs and gf:
            return leaf_global[None].expand(leaf_local.shape).clone()
        mask = sel if gs else ~sel
        return torch.where(_pod_axis(mask, leaf_local), leaf_global[None],
                           leaf_local)

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
    """Baseline: the mean over pods of ALL parameters, written to every pod."""
    new_global = pt.tree_map(lambda leaf: torch.mean(leaf, dim=0), local)
    new_local = pt.tree_map(lambda g, leaf: g[None].expand(leaf.shape).clone(),
                            new_global, local)
    stats = {"wire_bytes": 2.0 * num_pods * pt.tree_size_bytes(new_global)}
    return new_local, new_global, stats


def stack_for_pods(tree, num_pods: int):
    """One real copy of the tree per pod, along a new leading pod axis (the
    pods diverge, so no leaf may be a broadcast view)."""
    return pt.tree_map(
        lambda x: x[None].repeat((num_pods,) + (1,) * x.dim()), tree)


def init_pod_opt_state(optimizer, local):
    """The optimizer's state for pod-stacked params (the reference's
    ``vmap(optimizer.init)``): the moments carry the pod axis, and each pod
    counts its own steps."""
    state = optimizer.init(local)
    num_pods = pt.leaves(local)[0].shape[0]
    state["t"] = state["t"].expand(num_pods).clone()
    return state


def make_local_train_step(loss_fn, optimizer):
    """A per-pod local train step over the leading pod axis.

    ``loss_fn(params, batch) -> (loss, metrics)``; ``optimizer`` from
    ``repro_torch.optim``. ``step(stacked_params, stacked_opt,
    stacked_batch) -> (params, opt_state, loss (num_pods,))`` runs each
    pod's forward, backward and optimizer update in turn and writes the
    results into ``stacked_params`` and ``stacked_opt`` (which it returns):
    the pods stay independent, as the reference's ``vmap``, and one pod's
    gradients are held at a time.
    """

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
