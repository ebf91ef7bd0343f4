"""Gating policies for the FL engine (counterpart of
``repro.core.fl.policies``).

A :class:`Policy` answers the three questions of a partial-sharing round
(paper eqs. 3-6):

  * ``downlink_gates`` — which parameters each client RECEIVES from the
    server this round (S_n^i for selected clients, F_n^i for unselected);
  * ``uplink_gates``   — which parameters each selected client SENDS back;
  * ``train_mask``     — which clients run LocalUpdate.

At element granularity, state is the flat ``(K, D)`` client matrix and
gates are dense ``(K, D)`` float32 0/1 tensors. ``K`` is whatever rides the
client axis (the fleet or a sampled cohort). :class:`LeafPSGF` gates whole
leaves of a client-stacked tree instead (``core.psgf_dp``'s pods).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.common import pytree_utils as pt
from repro_torch.core.fl import masks as M


@runtime_checkable
class Policy(Protocol):
    """Downlink/uplink gating + train-set selection for one FL round.
    ``granularity`` is ``"element"`` for dense ``(K, D)`` gates (eligible
    for the fused psgf_mix downlink kernel)."""

    granularity: str

    def downlink_gates(self, keys, global_tree, client_tree, selected): ...

    def uplink_gates(self, key, global_tree, client_tree, selected): ...

    def train_mask(self, selected): ...


def _rows(selected, K, D):
    return selected[:, None].expand(K, D)


@dataclasses.dataclass(frozen=True)
class OnlineFed:
    """Online-Fed (eq. 3): selected clients are REPLACED by the global
    model, train, and are averaged back. Unselected clients idle."""

    granularity = "element"

    def downlink_gates(self, keys, global_tree, client_tree, selected):
        K, D = client_tree.shape
        return _rows(selected, K, D).to(torch.float32)

    def uplink_gates(self, key, global_tree, client_tree, selected):
        K, D = client_tree.shape
        return _rows(selected, K, D).to(torch.float32)

    def train_mask(self, selected):
        return selected


@dataclasses.dataclass(frozen=True)
class PSOFed:
    """PSO-Fed (eqs. 4-5): selected clients receive a random subset S_n^i,
    everyone trains, the server aggregates the selected shared subsets."""

    granularity = "element"
    share_ratio: float = 0.3

    def downlink_gates(self, keys, global_tree, client_tree, selected):
        k_share, _ = keys
        K, D = client_tree.shape
        s_masks = M.client_masks(k_share, K, D, self.share_ratio)
        return (_rows(selected, K, D) & s_masks).to(torch.float32)

    def uplink_gates(self, key, global_tree, client_tree, selected):
        K, D = client_tree.shape
        s_masks = M.client_masks(key, K, D, self.share_ratio)
        return (_rows(selected, K, D) & s_masks).to(torch.float32)

    def train_mask(self, selected):
        return torch.ones_like(selected)


@dataclasses.dataclass(frozen=True)
class PSGFFed(PSOFed):
    """PSGF-Fed (eq. 6): PSO plus a random forward subset F_n^i of the
    global parameters for every UNSELECTED client."""

    forward_ratio: float = 0.2

    def downlink_gates(self, keys, global_tree, client_tree, selected):
        k_share, k_fwd = keys
        K, D = client_tree.shape
        s_masks = M.client_masks(k_share, K, D, self.share_ratio)
        f_masks = M.client_masks(k_fwd, K, D, self.forward_ratio)
        return torch.where(selected[:, None], s_masks, f_masks).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class PSGFTopK:
    """Beyond-paper: magnitude-based masks — share the ``share_ratio * D``
    parameters where ``|w_global - w_client|`` is largest (index top-k, so
    ties still select exactly k entries)."""

    granularity = "element"
    share_ratio: float = 0.3
    forward_ratio: float = 0.2

    def downlink_gates(self, keys, global_tree, client_tree, selected):
        D = client_tree.shape[1]
        diff = torch.abs(global_tree[None, :] - client_tree)
        s_masks = M.topk_mask(diff, max(1, int(D * self.share_ratio)))
        f_masks = M.topk_mask(diff, max(1, int(D * self.forward_ratio)))
        return torch.where(selected[:, None], s_masks, f_masks).to(torch.float32)

    def uplink_gates(self, key, global_tree, client_tree, selected):
        K, D = client_tree.shape
        diff_up = torch.abs(global_tree[None, :] - client_tree)
        m_up = M.topk_mask(diff_up, max(1, int(D * self.share_ratio)))
        return (_rows(selected, K, D) & m_up).to(torch.float32)

    def train_mask(self, selected):
        return torch.ones_like(selected)


# ---------------------------------------------------------------------------
# leaf granularity (pytree client state — the datacenter / cross-pod mode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafPSGF:
    """PSGF at leaf granularity: the sync of ``repro_torch.core.psgf_dp``.

    Each pod is a "client"; a random subset of parameter LEAVES (share_ratio
    of leaves) is shared by selected pods and a smaller forwarded subset
    (forward_ratio) is pushed to unselected pods. ``leaf_gates`` is
    deterministic in its key, so passing the downlink share key to
    ``uplink_gates`` ties the up and down S-masks together. Each gate leaf
    is a per-client scalar of shape ``(K, 1, ..., 1)``."""

    granularity = "leaf"
    share_ratio: float = 0.3
    forward_ratio: float = 0.2

    @staticmethod
    def _per_client(gate_scalar, client_leaf, selected, fallback_scalar=None):
        K = selected.shape[0]
        sel = selected.reshape((K,) + (1,) * (client_leaf.dim() - 1))
        sel_f = sel.to(torch.float32)
        if fallback_scalar is None:
            return sel_f * gate_scalar
        return sel_f * gate_scalar + (1.0 - sel_f) * fallback_scalar

    def downlink_gates(self, keys, global_tree, client_tree, selected):
        k_share, k_fwd = keys
        g_share = M.leaf_gates(k_share, global_tree, self.share_ratio)
        g_fwd = M.leaf_gates(k_fwd, global_tree, self.forward_ratio)
        return pt.tree_map(
            lambda ll, gs, gf: self._per_client(gs, ll, selected, gf),
            client_tree, g_share, g_fwd)

    def uplink_gates(self, key, global_tree, client_tree, selected):
        g_share = M.leaf_gates(key, global_tree, self.share_ratio)
        return pt.tree_map(lambda ll, gs: self._per_client(gs, ll, selected),
                           client_tree, g_share)

    def train_mask(self, selected):
        return torch.ones_like(selected)


def from_config(fl_cfg) -> Policy:
    """Map an ``FLConfig.policy`` string to its element-granularity Policy."""
    if fl_cfg.policy == "online":
        return OnlineFed()
    if fl_cfg.policy == "pso":
        return PSOFed(share_ratio=fl_cfg.share_ratio)
    if fl_cfg.policy == "psgf":
        return PSGFFed(share_ratio=fl_cfg.share_ratio,
                       forward_ratio=fl_cfg.forward_ratio)
    if fl_cfg.policy == "psgf_topk":
        return PSGFTopK(share_ratio=fl_cfg.share_ratio,
                        forward_ratio=fl_cfg.forward_ratio)
    raise ValueError(f"unknown FL policy: {fl_cfg.policy!r}")
