"""Plain PSGF-Fed (the paper's eqs. 3-6), round by round: the yardstick for
the program's federated training.

One round, from the round key, as the configuration states the algorithm:

  * with a cohort of ``S < K`` clients, the round key splits into the
    cohort key (the first ``S`` of a permutation of the fleet) and the
    round's own key, and the cohort's rows are gathered and scattered back;
  * the round key splits five ways: selection, share masks, forward masks,
    uplink masks, LocalUpdate;
  * ``round(S * select_ratio)`` clients are selected (the first of a
    permutation); a selected client receives the global model where its
    share mask (density ``share_ratio``) is set, an unselected one where
    its forward mask (density ``forward_ratio``) is set: ``gate * global +
    (1 - gate) * local``;
  * every client runs ``local_steps`` Adam steps on ``batch_size`` windows
    drawn uniformly from its training windows (one key per client, split
    per step);
  * each selected client uploads where its uplink share mask is set; the
    server averages, per element, the uploaded values and its own value for
    the selected clients that did not upload that element;
  * the wire carries every gated element once: the count of a round is the
    number of downlink and uplink gates set, counted exactly here.

The global model's RMSE over every client's test windows is taken at the
end of each chunk of ``eval_every`` rounds. Nothing of the program is used;
draws come from the frozen threefry copy in :mod:`bench.reference.rng`.
"""
from __future__ import annotations

import math

import torch

from bench.reference import model as RM
from bench.reference import rng as R


def _windows(model, data, rows, idx):
    """``(S, B, L+T)`` windows of the clients ``rows`` at start indices
    ``idx`` ``(S, B)``, from raw series ``(K, T)`` or materialized windows
    ``(K, n, L+T)``."""
    if data.dim() == 2:
        offs = torch.arange(model["look_back"] + model["horizon"],
                            device=data.device)
        return data[rows[:, None, None], idx[:, :, None] + offs]
    return data[rows[:, None], idx]


def _num_windows(model, data):
    if data.dim() == 2:
        return data.shape[1] - (model["look_back"] + model["horizon"]) + 1
    return data.shape[1]


def rmse(model, w_global, test, precision="fp32", block=256):
    """RMSE of ``w_global`` ``(D,)`` over every stride-1 test window of every
    client, in blocks of clients."""
    L, H = model["look_back"], model["horizon"]
    n = _num_windows(model, test)
    flat = w_global[None]
    total, count = 0.0, 0
    with torch.no_grad():
        for lo in range(0, test.shape[0], block):
            rows = torch.arange(lo, min(lo + block, test.shape[0]),
                                device=test.device)
            idx = torch.arange(n, device=test.device).expand(len(rows), n)
            win = _windows(model, test, rows, idx).reshape(1, -1, L + H)
            pred = RM.forward(model, RM.unflatten(flat, model), win[..., :L],
                              precision)
            total += float(((pred - win[..., L:]).double() ** 2).sum())
            count += pred.numel()
    return math.sqrt(total / count)


def _round(model, fl, g, W, M, V, t, data, key, precision, faults):
    S, D = W.shape
    k_sel, k_share, k_fwd, k_up, k_local = R.split(key, 5).unbind(0)
    c = max(1, int(round(S * fl["select_ratio"])))
    selected = torch.zeros(S, dtype=torch.bool, device=W.device)
    selected[R.permutation(k_sel, S)[:c]] = True
    if "wrong_gates" in faults:
        k_share = k_up
    share = R.uniform(R.split(k_share, S), (D,)) < fl["share_ratio"]
    fwd = R.uniform(R.split(k_fwd, S), (D,)) < fl["forward_ratio"]
    gates = torch.where(selected[:, None], share, fwd).to(torch.float32)
    n_down = int(gates.sum(dtype=torch.float64))
    w = gates * g[None] + (1.0 - gates) * W

    L = model["look_back"]
    n_win = _num_windows(model, data)
    steps = fl["local_steps"]
    step_keys = R.split(R.split(k_local, S), steps)
    b1, b2, eps, lr = fl["adam_b1"], fl["adam_b2"], fl["adam_eps"], fl["lr"]
    rows = torch.arange(S, device=W.device)
    losses = []
    for s in range(steps):
        idx = R.randint(step_keys[:, s], (fl["batch_size"],), 0, n_win)
        if "half_batch" in faults:
            idx = idx[:, : fl["batch_size"] // 2]
        win = _windows(model, data, rows, idx)
        grad, loss = RM.client_grads(model, w, win[..., :L], win[..., L:],
                                     precision)
        t = t + 1
        tf = t.to(torch.float32)[:, None]
        M = b1 * M + (1 - b1) * grad
        V = b2 * V + (1 - b2) * grad * grad
        if "state_unchanged" not in faults:
            w = w - lr * (M / (1 - b1 ** tf)) / (torch.sqrt(V / (1 - b2 ** tf)) + eps)
        losses.append(loss)
        if s == 0:
            grad1 = grad.mean(dim=0)

    up = (selected[:, None]
          & (R.uniform(R.split(k_up, S), (D,)) < fl["share_ratio"])).to(torch.float32)
    n_up = int(up.sum(dtype=torch.float64))
    sel = selected.to(torch.float32)[:, None]
    g = (up * w + (sel - up) * g[None]).sum(dim=0) / c
    loss = float(torch.stack(losses, dim=1).mean(dim=1).mean())
    return g, w, M, V, t, loss, n_down, n_up, grad1


def run_job(model: dict, fl: dict, init_vec, key, train, test, cohort: int,
            rounds: int, eval_every: int, precision: str = "fp32", faults=()):
    """A whole job of ``rounds`` rounds started from ``init_vec`` with the
    job key ``key``, as the program's ``run_fl`` keys them (the job key
    splits into the run's key chain and an init key the given weights make
    unused; each round takes the next key of the chain), evaluated after
    every ``eval_every`` rounds. Returns ``{"loss": [per round], "comm":
    [cumulative count per round], "rmse": [the global model's RMSE after
    each chunk], "final": the global model after the last round (D,),
    "grad1": the clients' mean gradient of the first local step (D,)}``.

    Faults a broken driver could have, planted for the readings of
    ``bench/control.py``: ``carry_dropped`` starts every chunk from the
    job's initial state (its wire counts too) and returns that state, as a
    driver that never copies a chunk's result back into its state would; ``keys_repeat``
    starts every chunk's key chain where the job's starts."""
    K, D = train.shape[0], init_vec.shape[0]
    g0 = init_vec.to(torch.float32).clone()
    t0 = torch.zeros(K, dtype=torch.int32, device=g0.device)
    chain0 = R.split(key)[0]
    g, W = g0.clone(), g0[None].repeat(K, 1)
    M, V, t = torch.zeros_like(W), torch.zeros_like(W), t0.clone()
    chain = chain0
    losses, comms, rmses, total, grad1 = [], [], [], 0, None
    for r in range(rounds):
        if r % eval_every == 0 and r:
            if "carry_dropped" in faults:
                g, W = g0.clone(), g0[None].repeat(K, 1)
                M, V, t = torch.zeros_like(W), torch.zeros_like(W), t0.clone()
                total = 0
            if "keys_repeat" in faults:
                chain = chain0
        chain, rk = R.split(chain).unbind(0)
        if cohort < K:
            k_cohort, rk = R.split(rk).unbind(0)
            rows = R.permutation(k_cohort, K)[:cohort]
        else:
            rows = torch.arange(K, device=W.device)
        g, w, m, v, tt, loss, n_down, n_up, g1 = _round(
            model, fl, g, W[rows], M[rows], V[rows], t[rows], train[rows], rk,
            precision, faults)
        W[rows], M[rows], V[rows], t[rows] = w.detach(), m, v, tt
        grad1 = g1 if grad1 is None else grad1
        total += n_down + n_up
        losses.append(loss)
        comms.append(total)
        if (r + 1) % eval_every == 0 or r + 1 == rounds:
            rmses.append(rmse(model, g, test, precision))
    final = g0 if "carry_dropped" in faults else g
    return {"loss": losses, "comm": comms, "rmse": rmses, "final": final,
            "grad1": grad1}
