"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's.

Training steps (one model):
  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the largest gap, over leaves, between the norms of the
    first gradient as the optimizer received it (read back from its first
    moment after one step), over the larger of the reference's norm of that
    leaf and of the median leaf;
  * ``change_gap``: the same gap for the norm of each leaf's change over the
    steps compared, leaving out the leaves whose reference gradient norm is
    under a thousandth of the median leaf's (their change is Adam's
    normalised round-off: an attention key bias, whose gradient is zero
    under softmax).

Federated jobs, the whole job the window ran:
  * ``loss_gap``: the largest relative gap of a round's training loss over
    the first rounds;
  * ``rmse_gap``: the relative gap of the global model's RMSE at the first
    evaluation;
  * ``comm_gap``: the largest relative gap of the cumulative count of
    parameters on the wire, every round, against the exact integer count;
  * ``rmse_last_gap``: the relative gap of the RMSE at the last evaluation;
  * ``change_gap``: as for training steps, the worst leaf's gap between the
    norms of the global model's change over the whole job, leaving out the
    leaves whose gradient of the first local step is under a thousandth of
    the median leaf's.
"""
from __future__ import annotations

import math

import torch


def rel_gap(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def max_rel_gap(got, want) -> float:
    if len(got) < len(want):
        return math.inf
    return max(rel_gap(g, w) for g, w in zip(got, want))


def _leaf_norms(vec, sizes):
    return [float(torch.linalg.vector_norm(p.double()))
            for p in torch.split(vec, sizes)]


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def norm_gap(got_vec, want_vec, sizes, keep=None) -> float:
    """Worst leaf's ``| |got| - |want| | / max(|want|, median |want|)``."""
    got, want = _leaf_norms(got_vec, sizes), _leaf_norms(want_vec, sizes)
    floor = _median(want)
    idx = range(len(sizes)) if keep is None else keep
    return max(abs(got[i] - want[i]) / max(want[i], floor, 1e-30) for i in idx)


def moving_leaves(grad_vec, sizes):
    """Indices of the leaves whose gradient norm is at least a thousandth of
    the median leaf's."""
    norms = _leaf_norms(grad_vec, sizes)
    floor = 1e-3 * _median(norms)
    return [i for i, n in enumerate(norms) if n >= floor]


def train_gaps(prog: dict, ref: dict, sizes) -> dict:
    """``prog`` / ``ref``: ``loss`` per step, ``grad1`` (D,), ``start``
    (D,) and ``params`` (D,) after the steps."""
    keep = moving_leaves(ref["grad1"], sizes)
    return {
        "loss_gap": max_rel_gap(prog["loss"], ref["loss"]),
        "grad_gap": norm_gap(prog["grad1"], ref["grad1"], sizes),
        "change_gap": norm_gap(prog["params"] - prog["start"],
                               ref["params"] - ref["start"], sizes, keep),
    }


def fl_gaps(prog: dict, ref: dict, loss_rounds: int, sizes) -> dict:
    """``prog`` / ``ref``: ``loss`` and ``comm`` per round, ``rmse`` per
    evaluation, ``start`` and ``final`` global model (D,); ``ref`` also
    ``grad1`` (D,)."""
    keep = moving_leaves(ref["grad1"], sizes)
    if len(prog["rmse"]) < len(ref["rmse"]):
        return dict.fromkeys(("loss_gap", "rmse_gap", "comm_gap",
                              "rmse_last_gap", "change_gap"), math.inf)
    return {
        "loss_gap": max_rel_gap(prog["loss"][:loss_rounds],
                                ref["loss"][:loss_rounds]),
        "rmse_gap": rel_gap(prog["rmse"][0], ref["rmse"][0]),
        "comm_gap": max_rel_gap(prog["comm"], ref["comm"]),
        "rmse_last_gap": rel_gap(prog["rmse"][-1], ref["rmse"][-1]),
        "change_gap": norm_gap(prog["final"] - prog["start"],
                               ref["final"] - ref["start"], sizes, keep),
    }
