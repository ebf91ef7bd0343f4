"""The federated-learning engine in PyTorch (counterpart of
``repro.core.fl.engine``): one gate/aggregate/distribute core for every
element-granularity partial-sharing policy, plus the ``loop`` and ``scan``
round drivers.

Client state is a ``(K, D)`` matrix over the flat parameter vector
(``common.pytree_utils.tree_flatten_to_vector``, JAX's leaf order) plus
per-client Adam moments; every state tensor lives on one ``device``. A round
(:func:`fl_round`) is, as in the reference:

  1. :func:`_round_down` — split the round key five ways; select clients;
     the policy's downlink gates; the wire payload (fp32, bf16 or stochastic
     int8); the downlink mix and its comm count. With
     ``FLConfig.use_pallas_mix`` the mix and count run in the fused
     ``psgf_mix`` kernel (``kernels/psgf_mix``: the CUDA kernel on the card);
  2. :func:`_local_update_all` — ``local_steps`` Adam steps per client,
     ``torch.func.vmap(torch.func.grad_and_value(...))`` over the client axis
     (in chunks of ``client_chunk`` clients), minibatches drawn from
     materialized windows or gathered from the raw series
     (``streaming_windows``);
  3. :func:`_round_up` — merge, uplink gates, wire quantization, gated
     aggregation and exact comm accounting.

Every random draw goes through ``repro_torch.random``, a bit-exact threefry,
on the reference's key chain: same key, same selection, gates, cohorts,
minibatch indices and int8 rounding as the JAX engine, and the same on the
card as on the CPU. Float results (grads, states, RMSE) agree with the
reference within ``FL_PARITY_TOL``.

Each stage runs inside a ``torch.profiler.record_function`` range
(``fl.rng``: selection and gate draws; ``fl.mix``; ``fl.local_update``;
``fl.aggregate``), so a profile of a round splits by stage; outside a
profiler the ranges cost a few microseconds each.

Drivers (the same rounds, in the same order, from the same key):

  * ``"loop"`` — one round per step, patience checked after every round;
  * ``"scan"`` (the default) — :func:`_run_chunk` runs ``eval_every`` rounds,
    then the host reads the losses and checks patience at the chunk
    boundary, so ``rounds_run`` equals the reference's scan driver;
  * ``"while"`` — the same chunks with the patience test, the round and
    chunk counters and the history buffers on the device
    (:class:`_WhileRun`): on the card each chunk length is one captured
    CUDA graph, replayed without a host read per chunk; ``rounds_run``
    equals the scan driver's;
  * ``"host"`` — the client state in host memory, pinned on the card, and
    only each round's cohort on the device
    (:mod:`repro_torch.core.fl.client_store`), with the loop driver's stop.

Across processes (``launch.distributed``): ``run_fl(driver="scan"|"while",
client_mesh=launch.mesh.make_client_mesh(multi_host=True))`` holds only this
process's block of the client rows on its device, and ``driver="host"``
under an initialized group partitions the host store; both run the
partitioned round of :mod:`repro_torch.core.fl.partition` and equal the
one-process run bit for bit. Over a local mesh (``shard_clients=True``:
every local GPU; or a ``client_mesh`` of several devices of this process,
which may repeat one device) the same partitioned round runs in one
process, one shard a device of the mesh, each on its own CUDA stream, and
the whole client axis comes back on the mesh's first device; a client axis
the shards do not divide stays unsharded, as the reference leaves such
leaves replicated. On one device either is the unsharded run.

:func:`sync_round` is the train-free gate/aggregate/distribute cycle over
client-stacked trees that ``core.psgf_dp`` syncs its pods with, under the
leaf-granularity ``LeafPSGF`` policy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import random as R
from repro_torch.checkpoint.checkpoint import int8_roundtrip
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import (DEFAULT_DEVICE, normalized,
                                       resolve_device)
from repro_torch.core import forecast
from repro_torch.core.fl import masks as M
from repro_torch.core.fl import policies as pol
from repro_torch.models import spec as S

# One accounting dtype for every communication counter (comm_down / comm_up /
# comm_scales), as in the reference: accumulated float32 sums of mask
# densities, exact integers while a count stays under 2^24.
ACCOUNTING_DTYPE = torch.float32

# Port vs reference on one round or an N-round run from the same params,
# keys and data: selection, gates, minibatch indices and comm counters are
# bitwise equal (integer RNG); gradients come from torch's and XLA's float32
# kernels, which sum in other orders, and Adam carries those ulps into the
# states. Over 1-6 rounds at the tests' widths the states agree to 1.5e-6
# and the RMSE to 3e-7; 1e-5 (absolute and relative) leaves margin above
# that, while one wrong gate moves a weight by the client-global gap (~1e-3
# after one round) and fails it. One leaf is outside any tolerance: the
# attention key bias ``attn/bk``. Softmax is invariant to a per-row shift,
# so its gradient is zero analytically and float noise in both packages;
# Adam normalizes that noise into +-lr steps of random sign. It has no
# effect on any output, and parity checks leave it out (:func:`bk_free`).
FL_PARITY_TOL = 1e-5


def bk_free(meta) -> torch.Tensor:
    """Boolean ``(D,)`` mask of the flat vector without the ``attn/bk``
    leaves: the elements parity checks compare (see ``FL_PARITY_TOL``)."""
    keep = torch.ones(meta.total, dtype=torch.bool)
    off = 0
    for path, size in zip(meta.paths, meta.sizes):
        keep[off:off + size] = not path.endswith("attn/bk")
        off += size
    return keep


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Same fields, defaults and validation as the reference's
    ``FLConfig`` (see ``repro.core.fl.engine.FLConfig`` for each knob)."""

    policy: str = "psgf"           # online | pso | psgf | psgf_topk
    num_clients: int = 58
    select_ratio: float = 0.5      # paper: 50% for all methods
    share_ratio: float = 0.3       # PSO/PSGF S-mask density
    forward_ratio: float = 0.2     # PSGF F-mask density
    local_steps: int = 4
    batch_size: int = 32
    lr: float = 1e-3               # Adam, paper setting
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    comm_bits: int = 32            # wire payload: 32 | 16 (bf16) | 8 (int8)
    client_chunk: Optional[int] = None
    # the downlink mix and its count in the fused psgf_mix kernel
    use_pallas_mix: bool = False
    streaming_windows: bool = False
    participation: Optional[float] = None

    def participation_size(self) -> int:
        """The per-round cohort size S: ``participation`` as a count, as a
        fraction of ``num_clients`` (``max(1, round(K * f))``), or
        ``num_clients`` when ``None``."""
        if self.participation is None:
            return self.num_clients
        if isinstance(self.participation, float):
            return max(1, int(round(self.num_clients * self.participation)))
        return int(self.participation)

    def __post_init__(self):
        if self.comm_bits not in (8, 16, 32):
            raise ValueError(
                f"FLConfig.comm_bits: unsupported payload width: "
                f"{self.comm_bits} bits (choose 8, 16 or 32)")
        if self.client_chunk is not None and self.client_chunk <= 0:
            raise ValueError(
                f"client_chunk must be a positive client count or None, got "
                f"{self.client_chunk}")
        if self.participation is None:
            return
        p = self.participation
        ok_int = (isinstance(p, (int, np.integer))
                  and not isinstance(p, bool)
                  and 1 <= p <= self.num_clients)
        ok_frac = (isinstance(p, float) and 0.0 < p <= 1.0)
        if not (ok_int or ok_frac):
            raise ValueError(
                f"participation must be an int cohort size in [1, "
                f"num_clients={self.num_clients}] or a float fraction in "
                f"(0, 1], got {p!r}")
        S = self.participation_size()
        if self.client_chunk is not None and self.client_chunk > S:
            raise ValueError(
                f"client_chunk={self.client_chunk} exceeds the per-round "
                f"cohort size {S} (participation={p!r}): LocalUpdate only ever "
                f"sees the cohort, so the chunk can never fill — lower "
                f"client_chunk to <= {S} or raise participation")


# ---------------------------------------------------------------------------
# gate/aggregate/distribute core
# ---------------------------------------------------------------------------


def mix_down(client_tree, global_tree, gates):
    """Clients receive ``gate * global + (1 - gate) * local`` (eqs. 3/4/6).
    Client leaves are ``(K, *s)``, global leaves ``(*s)``; gate leaves
    broadcast against the client leaves."""
    return pt.tree_map(lambda l, g, m: m * g[None] + (1.0 - m) * l,
                       client_tree, global_tree, gates)


def aggregate(client_tree, global_tree, up_gates, selected):
    """Server update (eqs. 3/5): per leaf ``sum_k(up_k * w_k + (sel_k -
    up_k) * g) / C`` over the ``C`` selected clients. With NO client
    selected the global model is kept as it is."""
    num_sel = selected.sum()
    C = num_sel.clamp_min(1).to(torch.float32)

    def per_leaf(l, g, m):
        sel = selected.reshape((selected.shape[0],) + (1,) * (l.dim() - 1))
        contrib = m * l + (sel.to(torch.float32) - m) * g[None]
        return torch.where(num_sel > 0, contrib.sum(dim=0) / C, g)

    return pt.tree_map(per_leaf, client_tree, global_tree, up_gates)


def _gate_scale(gate_leaf, client_leaf) -> int:
    """Elements of a client leaf covered by ONE gate entry."""
    g = max(math.prod(gate_leaf.shape[1:]), 1)
    return math.prod(client_leaf.shape[1:]) // g


def gate_count(gates, client_tree):
    """Number of parameters crossing the wire given realized gates."""
    total = None
    for g, l in zip(pt.leaves(gates), pt.leaves(client_tree)):
        s = torch.sum(g, dtype=ACCOUNTING_DTYPE)
        scale = _gate_scale(g, l)
        s = s if scale == 1 else s * scale
        total = s if total is None else total + s
    return total


def _payload_clients(gate_leaf):
    """Per-client: does this client exchange >= 1 element of the leaf?"""
    return (gate_leaf.reshape(gate_leaf.shape[0], -1) != 0).any(dim=1)


def wire_scale_count(gates):
    """Per-payload fp32 scale headers an int8 wire carries: one per
    (client, gated leaf) payload."""
    return sum(_payload_clients(g).to(ACCOUNTING_DTYPE).sum()
               for g in pt.leaves(gates))


def gate_bytes(gates, client_tree, comm_bits: Optional[int] = None):
    """Bytes crossing the wire given realized gates: each client leaf's
    itemsize by default, else ``comm_bits / 8`` per element, plus the int8
    wire's fp32 scale headers at ``comm_bits=8``."""
    total = None
    for g, l in zip(pt.leaves(gates), pt.leaves(client_tree)):
        width = l.element_size() if comm_bits is None else comm_bits / 8.0
        s = torch.sum(g, dtype=ACCOUNTING_DTYPE) * (_gate_scale(g, l) * width)
        total = s if total is None else total + s
    if comm_bits == 8:
        total = total + wire_scale_count(gates) * 4.0
    return total


def quantize_wire_vec(vec, meta, comm_bits: int, key=None):
    """Wire round-trip of flat ``(..., D)`` payloads at ``comm_bits``: 16 is
    the bf16 round-trip; 8 is int8 with one fp32 absmax scale per param leaf
    per payload (``checkpoint.quantize_tree(bits=8)`` applied to each row,
    leaf ``i`` stochastically rounded with ``uniform(fold_in(key, i))``).
    ``key`` has the payloads' leading shape plus ``(2,)`` (one key per
    payload, as the reference's vmap over uploaders); ``None`` rounds to
    nearest."""
    if comm_bits == 32:
        return vec
    if comm_bits == 16:
        return vec.to(torch.bfloat16).to(torch.float32)
    if comm_bits != 8:
        raise ValueError(f"FLConfig.comm_bits: unsupported payload width: "
                         f"{comm_bits} bits (choose 8, 16 or 32)")
    lead = vec.dim() - 1
    parts = []
    for i, seg in enumerate(torch.split(vec, meta.sizes, dim=-1)):
        noise = None if key is None else R.uniform(R.fold_in(key, i),
                                                   (seg.shape[-1],))
        parts.append(int8_roundtrip(seg, noise, batch_dims=lead))
    return torch.cat(parts, dim=-1)


def mix_down_count(client_tree, global_tree, gates, *, use_pallas: bool = False):
    """Fused downlink: ``(mix_down(...), gate_count(...))``.

    On the element-granularity path — ONE float32 ``(K, D)`` client leaf
    with dense ``(K, D)`` gates — ``use_pallas=True`` runs the fused
    ``psgf_mix_batch`` kernel (mix and count in one pass over the mask; the
    CUDA kernel for CUDA tensors, which raises rather than fall back). The
    mix is bitwise ``mix_down``; the count is bitwise ``gate_count`` for 0/1
    gates under 2^24 per round. Other calls take the two-pass path, as in
    the reference (``engine.py:335-337`` there)."""
    cl, gl, gt = pt.leaves(client_tree), pt.leaves(global_tree), pt.leaves(gates)
    if (use_pallas and len(cl) == 1 and len(gl) == 1 and len(gt) == 1
            and cl[0].dim() == 2 and gl[0].dim() == 1
            and tuple(gt[0].shape) == tuple(cl[0].shape)
            and cl[0].dtype == torch.float32):
        from repro_torch.kernels.psgf_mix.ops import psgf_mix_batch

        mixed, count = psgf_mix_batch(gl[0], cl[0], gt[0])
        if isinstance(client_tree, torch.Tensor):
            return mixed, count.to(ACCOUNTING_DTYPE)
        return (pt.tree_map(lambda _: mixed, client_tree),
                count.to(ACCOUNTING_DTYPE))
    return (mix_down(client_tree, global_tree, gates),
            gate_count(gates, client_tree))


def sync_round(local, global_, key, policy, select_ratio: float):
    """Train-free gate/aggregate/distribute cycle over client-stacked trees
    (``psgf_dp.psgf_sync``'s core): select clients, aggregate the uplink
    into the global model, mix the fresh global back into every client.
    Returns ``(new_local, new_global, stats)`` with exact wire-byte
    accounting (``stats``: ``wire_bytes``, ``num_selected``)."""
    num_clients = pt.leaves(local)[0].shape[0]
    k_sel, k_share, k_fwd = R.split(key, 3)
    selected = M.select_clients(k_sel, num_clients, select_ratio)

    down = policy.downlink_gates((k_share, k_fwd), global_, local, selected)
    # k_share (not a fresh key) ties the uplink S-masks to the downlink ones:
    # the same leaf subset is aggregated and written back within one sync
    up = policy.uplink_gates(k_share, global_, local, selected)

    new_global = aggregate(local, global_, up, selected)
    new_local = mix_down(local, new_global, down)
    stats = {"wire_bytes": gate_bytes(down, local) + gate_bytes(up, local),
             "num_selected": selected.sum()}
    return new_local, new_global, stats


# ---------------------------------------------------------------------------
# flat client space: state init + LocalUpdate
# ---------------------------------------------------------------------------


def init_fl_state(model_cfg: forecast.ForecastConfig, fl_cfg: FLConfig, key,
                  init_params=None, device=DEFAULT_DEVICE):
    """State on ``device``: global vector, per-client vectors, per-client
    Adam moments and the round/comm counters. Returns ``(state, meta)``.

    A fresh init draws the params from ``key`` as the reference does
    (``models.spec.init_params_from_key``: equal up to ``erfinv``'s last
    ulps). ``init_params`` (a params tree of tensors) WARM-STARTS the run
    instead, as the reference's flywheel does; Adam moments start at zero
    either way."""
    dev = resolve_device(device)
    vec, meta = _init_vector(model_cfg, key, init_params, dev)
    server = _server_state(vec, fl_cfg)
    state = {"w_global": vec, **_client_rows(vec, fl_cfg.num_clients)}
    state.update((k, v) for k, v in server.items() if k != "w_global")
    return state, meta


def _init_vector(model_cfg, key, init_params, dev):
    """The flat float32 params on ``dev`` (drawn from ``key`` unless
    ``init_params`` is given) and their meta."""
    if init_params is None:
        init_params = S.init_params_from_key(forecast.model_spec(model_cfg),
                                             key, dev)
    vec, meta = pt.tree_flatten_to_vector(init_params)
    return vec.to(device=dev, dtype=torch.float32), meta


def _server_state(vec, fl_cfg):
    """The server side of a fresh state: the global vector and the counters."""
    zero = lambda dtype=ACCOUNTING_DTYPE: torch.zeros(  # noqa: E731
        (), dtype=dtype, device=vec.device)
    server = {"w_global": vec, "round": zero(torch.int32),
              "comm_down": zero(), "comm_up": zero()}
    if fl_cfg.comm_bits == 8:
        server["comm_scales"] = zero()
    return server


def _client_rows(vec, n: int):
    """``n`` fresh client rows: copies of ``vec``, zero Adam moments."""
    D = vec.shape[0]
    return {"w_clients": vec[None, :].repeat(n, 1),
            "adam_m": vec.new_zeros((n, D)), "adam_v": vec.new_zeros((n, D)),
            "adam_t": torch.zeros((n,), dtype=torch.int32, device=vec.device)}


def _num_windows(model_cfg, data) -> int:
    """Windows per client: materialized ``(K, n_win, L+T)`` or raw ``(K, T)``."""
    if data.dim() == 2:
        return data.shape[1] - (model_cfg.look_back + model_cfg.horizon) + 1
    return data.shape[1]


def _minibatch(model_cfg, data, idx):
    """``(K, batch, L+T)`` windows of each client at start indices ``idx``
    ``(K, batch)``: rows of the materialized windows, or gathered from the
    raw series (window ``i`` is ``data[k, i : i + L+T]``)."""
    rows = torch.arange(data.shape[0], device=data.device)[:, None]
    if data.dim() == 2:
        offs = torch.arange(model_cfg.look_back + model_cfg.horizon,
                            device=data.device)
        return data[rows[:, :, None], idx[:, :, None] + offs]
    return data[rows, idx]


def _client_grads(model_cfg, meta, w, x, y, client_chunk):
    """Per-client ``(grad, loss)`` of the MSE at the flat vectors ``w``
    ``(K, D)``: ``vmap(grad_and_value)`` over clients, in chunks of
    ``client_chunk`` clients so only that many clients' activations live at
    once."""
    def loss_vec(wv, xb, yb):
        return forecast.mse_loss(model_cfg, pt.tree_unflatten_from_vector(wv, meta),
                                 xb, yb)

    fn = torch.func.vmap(torch.func.grad_and_value(loss_vec))
    K = w.shape[0]
    step = K if client_chunk is None else min(client_chunk, K)
    outs = [fn(w[i:i + step], x[i:i + step], y[i:i + step])
            for i in range(0, K, step)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([g for g, _ in outs]), torch.cat([l for _, l in outs])


def _local_update_all(model_cfg, fl_cfg, meta, w, m, v, t, data, keys):
    """LocalUpdate of every client in ``w`` ``(K, D)``: ``local_steps`` Adam
    steps on minibatches drawn with ``randint(step_key, (batch,), 0,
    n_win)``, the step keys ``split(keys[k], local_steps)`` (the reference's
    ``lax.scan`` over split keys, vmapped over clients). Returns ``(w, m, v,
    t, mean loss per client)``."""
    Lb = model_cfg.look_back
    n_win = _num_windows(model_cfg, data)
    step_keys = R.split(keys, fl_cfg.local_steps)          # (K, steps, 2)
    b1, b2 = fl_cfg.adam_b1, fl_cfg.adam_b2
    losses = []
    for s in range(fl_cfg.local_steps):
        idx = R.randint(step_keys[:, s], (fl_cfg.batch_size,), 0, n_win)
        batch = _minibatch(model_cfg, data, idx)
        g, loss = _client_grads(model_cfg, meta, w, batch[:, :, :Lb],
                                batch[:, :, Lb:], fl_cfg.client_chunk)
        t = t + 1
        tf = t.to(torch.float32)[:, None]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / (1 - torch.pow(b1, tf))
        vhat = v / (1 - torch.pow(b2, tf))
        w = w - fl_cfg.lr * mhat / (torch.sqrt(vhat) + fl_cfg.adam_eps)
        losses.append(loss)
    return w, m, v, t, torch.stack(losses, dim=1).mean(dim=1)


def _local_update(model_cfg, fl_cfg, meta, w, m, v, t, data, key):
    """LocalUpdate of ONE client (the reference's per-client function):
    :func:`_local_update_all` on a client axis of one. ``w``, ``m``, ``v``
    ``(D,)``, ``t`` 0-d, ``data`` the client's windows or raw series, ``key``
    ``(2,)``."""
    out = _local_update_all(model_cfg, fl_cfg, meta, w[None], m[None], v[None],
                            t[None], data[None], key[None])
    return tuple(o[0] for o in out)


# ---------------------------------------------------------------------------
# one round
# ---------------------------------------------------------------------------


def sample_cohort(key, num_clients: int, size: int):
    """The per-round participant cohort: the first ``size`` entries of a
    key-seeded permutation of ``arange(num_clients)``."""
    return R.permutation(key, num_clients)[:size]


def _round_down(state, key, fl_cfg, meta, policy):
    """Stage 1/3: selection, downlink gates, wire payload, downlink mix."""
    K = state["w_clients"].shape[0]
    with record_function("fl.rng"):
        k_sel, k_smask, k_fmask, k_upmask, k_local = R.split(key, 5).unbind(0)
        selected = M.select_clients(k_sel, K, fl_cfg.select_ratio)
        gates = policy.downlink_gates(
            (k_smask, k_fmask), state["w_global"], state["w_clients"], selected)
    down = {"selected": selected, "gates": gates,
            "k_upmask": k_upmask, "k_local": k_local}
    if fl_cfg.comm_bits == 8:
        # one stochastically rounded int8 payload of w_global for every
        # receiver; the wire key folds off the round key (split chain intact)
        k_wire = R.fold_in(key, 8)
        down["k_wire"] = k_wire
        w_wire = quantize_wire_vec(state["w_global"], meta, 8,
                                   key=R.fold_in(k_wire, 0))
    elif fl_cfg.comm_bits < 32:
        w_wire = state["w_global"].to(torch.bfloat16).to(torch.float32)
    else:
        w_wire = state["w_global"]
    use_pallas = (fl_cfg.use_pallas_mix
                  and getattr(policy, "granularity", "element") == "element")
    with record_function("fl.mix"):
        w_mixed, n_down = mix_down_count(state["w_clients"], w_wire, gates,
                                         use_pallas=use_pallas)
    down["w_mixed"] = w_mixed
    down["comm_down"] = state["comm_down"] + n_down
    return down


def _round_up(state, down, upd, fl_cfg, meta, policy):
    """Stage 3/3: merge LocalUpdate results, uplink gates and wire,
    aggregation and comm accounting."""
    K = state["w_clients"].shape[0]
    selected = down["selected"]
    trains = policy.train_mask(selected)
    w_new, m_new, v_new, t_new, losses = upd

    tr = trains[:, None].to(torch.float32)
    w_clients = tr * w_new + (1 - tr) * down["w_mixed"]
    adam_m = tr * m_new + (1 - tr) * state["adam_m"]
    adam_v = tr * v_new + (1 - tr) * state["adam_v"]
    adam_t = torch.where(trains, t_new, state["adam_t"])

    with record_function("fl.rng"):
        up_masks = policy.uplink_gates(down["k_upmask"], state["w_global"],
                                       w_clients, selected)
    if fl_cfg.comm_bits == 8:
        # each uploader quantizes its own row under its own rounding key
        keys = R.fold_in(down["k_wire"],
                         torch.arange(1, K + 1, device=w_clients.device))
        w_clients_wire = quantize_wire_vec(w_clients, meta, 8, key=keys)
    elif fl_cfg.comm_bits < 32:
        w_clients_wire = w_clients.to(torch.bfloat16).to(torch.float32)
    else:
        w_clients_wire = w_clients

    with record_function("fl.aggregate"):
        w_global = aggregate(w_clients_wire, state["w_global"], up_masks,
                             selected)
        comm_up = state["comm_up"] + gate_count(up_masks, w_clients)
    comm_down = down["comm_down"]
    new_state = {
        "w_global": w_global,
        "w_clients": w_clients,
        "adam_m": adam_m,
        "adam_v": adam_v,
        "adam_t": adam_t,
        "round": state["round"] + 1,
        "comm_down": comm_down,
        "comm_up": comm_up,
    }
    metrics = {
        "train_loss": (losses * trains).sum() / trains.sum().clamp_min(1),
        "num_selected": selected.sum(),
        "comm_total": comm_down + comm_up,
        "comm_bytes": (comm_down + comm_up) * (fl_cfg.comm_bits / 8.0),
    }
    if fl_cfg.comm_bits == 8:
        n_leaves = float(len(meta.sizes))
        scales = (state["comm_scales"]
                  + n_leaves * wire_scale_count(down["gates"])
                  + n_leaves * wire_scale_count(up_masks))
        new_state["comm_scales"] = scales
        metrics["comm_scales"] = scales
        metrics["comm_bytes"] = metrics["comm_bytes"] + scales * 4.0
    return new_state, metrics


def _round_body(state, data, key, model_cfg, fl_cfg, meta, policy):
    """One FL iteration over the clients present in ``state`` (the fleet or
    a gathered cohort): down, LocalUpdate, up."""
    K = state["w_clients"].shape[0]
    down = _round_down(state, key, fl_cfg, meta, policy)
    with record_function("fl.local_update"):
        upd = _local_update_all(model_cfg, fl_cfg, meta, down["w_mixed"],
                                state["adam_m"], state["adam_v"],
                                state["adam_t"], data,
                                R.split(down["k_local"], K))
    return _round_up(state, down, upd, fl_cfg, meta, policy)


_CLIENT_AXIS_KEYS = ("w_clients", "adam_m", "adam_v", "adam_t")


def _round(state, data, key, model_cfg, fl_cfg, meta, policy):
    """One FL iteration: the full fleet, or with ``participation`` a cohort
    sampled from ``split(key)[0]``, gathered, run with ``split(key)[1]`` and
    scattered back (bitwise the full round on the gathered cohort)."""
    K = fl_cfg.num_clients
    S = fl_cfg.participation_size()
    if S >= K:
        return _round_body(state, data, key, model_cfg, fl_cfg, meta, policy)
    k_cohort, k_round = R.split(key).unbind(0)
    cohort = sample_cohort(k_cohort, K, S)
    sub = dict(state)
    for name in _CLIENT_AXIS_KEYS:
        sub[name] = state[name][cohort]
    new_sub, metrics = _round_body(sub, data[cohort], k_round, model_cfg,
                                   fl_cfg, meta, policy)
    new_state = dict(new_sub)
    for name in _CLIENT_AXIS_KEYS:
        new_state[name] = state[name].index_copy(0, cohort, new_sub[name])
    return new_state, metrics


def _as_device(x, dev, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def fl_round(state, data, key, model_cfg: forecast.ForecastConfig,
             fl_cfg: FLConfig, meta, policy=None, device=DEFAULT_DEVICE):
    """One global FL iteration on ``device`` (state, data and key are moved
    there). ``policy=None`` resolves the element policy from
    ``fl_cfg.policy``. Returns ``(new_state, metrics)``; ``state`` is not
    modified."""
    dev = resolve_device(device)
    policy = pol.from_config(fl_cfg) if policy is None else policy
    state = {k: v.to(dev) for k, v in state.items()}
    return _round(state, _as_device(data, dev, torch.float32),
                  _as_device(key, dev, torch.int64), model_cfg, fl_cfg,
                  meta, policy)


# ---------------------------------------------------------------------------
# evaluation and multi-round drivers
# ---------------------------------------------------------------------------


def _rmse_device(model_cfg: forecast.ForecastConfig, w_vec, meta, data,
                 client_chunk: Optional[int] = None):
    """RMSE (0-d tensor) of the global model over every client's test
    windows: materialized ``(K, n_win, L+T)`` or raw ``(K, T)``
    (``streaming_windows``, stride-1 windows gathered on the device).
    ``client_chunk`` bounds the clients per forward."""
    params = pt.tree_unflatten_from_vector(w_vec, meta)
    Lb, H = model_cfg.look_back, model_cfg.horizon
    K = data.shape[0]
    if data.dim() == 2:
        n = data.shape[1] - (Lb + H) + 1
        widx = (torch.arange(n, device=data.device)[:, None]
                + torch.arange(Lb + H, device=data.device)[None, :])
        windows = lambda lo, hi: data[lo:hi][:, widx]            # noqa: E731
    else:
        n = data.shape[1]
        windows = lambda lo, hi: data[lo:hi]                     # noqa: E731
    step = K if client_chunk is None else min(client_chunk, K)
    sq = []
    with torch.no_grad():
        for lo in range(0, K, step):
            win = windows(lo, lo + step)
            pred = forecast.forward(model_cfg, params,
                                    win[:, :, :Lb].reshape(-1, Lb))
            sq.append(torch.square(pred - win[:, :, Lb:].reshape(-1, H)))
        return torch.sqrt(torch.mean(torch.cat(sq)))


def evaluate_rmse(model_cfg: forecast.ForecastConfig, w_vec, meta, data,
                  client_chunk: Optional[int] = None) -> float:
    """RMSE of the global model over all clients' test windows (see
    :func:`_rmse_device`); runs where ``w_vec`` lies."""
    data = _as_device(data, w_vec.device, torch.float32)
    return float(_rmse_device(model_cfg, w_vec, meta, data, client_chunk))


def _improved(loss, best) -> bool:
    """Convergence test in FLOAT32 arithmetic, as the reference's."""
    return bool(np.float32(loss) < np.float32(best) - np.float32(1e-5))


def _run_chunk(state, key, data, model_cfg, fl_cfg, meta, policy,
               num_rounds: int):
    """``num_rounds`` rounds through :func:`_round`, each on the next key of
    the chain (``key, rk = split(key)``): the body of every multi-round
    driver. Returns ``(state, key, {"train_loss", "comm_total"})``, the
    per-round metrics stacked ``(num_rounds,)``."""
    losses, comms = [], []
    for _ in range(num_rounds):
        key, rk = R.split(key).unbind(0)
        state, metrics = _round(state, data, rk, model_cfg, fl_cfg, meta,
                                policy)
        losses.append(metrics["train_loss"])
        comms.append(metrics["comm_total"])
    return state, key, {"train_loss": torch.stack(losses),
                        "comm_total": torch.stack(comms)}


def _while_chunk(state, flags, num_rounds: int, train_data, test_data,
                 model_cfg, fl_cfg, meta, policy, max_rounds: int,
                 patience: int):
    """One chunk of the while driver, every step on the device (the body of
    the reference's ``_run_while_impl`` loop): ``num_rounds`` rounds through
    :func:`_run_chunk`; the scan driver's patience test after each round,
    in float32 (an improvement is ``loss < best - 1e-5``; once ``stop``
    fires, ``best`` and ``stall`` freeze, and the chunk's remaining rounds
    still run and count); the losses and comm totals written at the round
    counter ``r``, the new global model's RMSE at the chunk counter ``c``.

    A chunk that starts with the run over (``stop`` set, or ``r`` at
    ``max_rounds``) changes nothing: each tensor is masked back once, at the
    end. Returns the new ``(state, flags)``."""
    done = flags["stop"] | (flags["r"] >= max_rounds)
    new_state, key, ms = _run_chunk(state, flags["key"], train_data,
                                    model_cfg, fl_cfg, meta, policy, num_rounds)
    best, stall, stop = flags["best"], flags["stall"], flags["stop"]
    for loss in ms["train_loss"].unbind(0):
        best, stall, stop = _patience_step(best, stall, stop, loss, patience)
    # a chunk past the end writes at 0, never past the buffers, and is
    # masked back below
    r0 = torch.where(done, 0, flags["r"])
    rows = r0 + torch.arange(num_rounds, device=r0.device)
    c0 = torch.where(done, 0, flags["c"]).reshape(1)
    rmse = _rmse_device(model_cfg, new_state["w_global"], meta, test_data,
                        fl_cfg.client_chunk)
    new_flags = {
        "key": key, "best": best, "stall": stall, "stop": stop,
        "r": flags["r"] + num_rounds, "c": flags["c"] + 1,
        "loss_buf": flags["loss_buf"].index_copy(0, rows, ms["train_loss"]),
        "comm_buf": flags["comm_buf"].index_copy(0, rows, ms["comm_total"]),
        "rmse_buf": flags["rmse_buf"].index_copy(0, c0, rmse.reshape(1)),
    }
    return ({k: torch.where(done, v, new_state[k]) for k, v in state.items()},
            {k: torch.where(done, v, new_flags[k]) for k, v in flags.items()})


def _patience_step(best, stall, stop, loss, patience: int):
    """One round of the scan driver's patience test on the device, in
    float32: an improvement is ``loss < best - 1e-5``; once ``stop`` is set,
    ``best`` and ``stall`` freeze. Returns the new ``(best, stall, stop)``."""
    improved = loss < best - 1e-5
    nstall = torch.where(improved, 0, stall + 1)
    return (torch.where(stop, best, torch.where(improved, loss, best)),
            torch.where(stop, stall, nstall), stop | (nstall >= patience))


def _while_flags(key, n_chunks: int, eval_every: int) -> dict:
    """The while driver's device-side run state: the key chain, the
    patience state, the round and chunk counters and the history buffers
    of ``n_chunks`` chunks."""
    dev = key.device
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                             device=dev)
    return {
        "key": key.clone(),
        "best": torch.full((), math.inf, dtype=torch.float32, device=dev),
        "stall": zeros((), torch.int32),
        "stop": zeros((), torch.bool),
        "r": zeros((), torch.int64),
        "c": zeros((), torch.int64),
        "loss_buf": zeros(n_chunks * eval_every, torch.float32),
        "comm_buf": zeros(n_chunks * eval_every, ACCOUNTING_DTYPE),
        "rmse_buf": zeros(n_chunks, torch.float32),
    }


def _read_while(flags):
    """The one blocking read of a while run: ``(rounds_run, chunks_run,
    losses, comm totals, RMSE per chunk)`` as Python lists."""
    host = {k: flags[k].cpu()
            for k in ("r", "c", "loss_buf", "comm_buf", "rmse_buf")}
    rounds, chunks = int(host["r"]), int(host["c"])
    return (rounds, chunks, host["loss_buf"][:rounds].tolist(),
            host["comm_buf"][:rounds].tolist(),
            host["rmse_buf"][:chunks].tolist())


def _chunk_history(rounds_run, losses, comms, rmses, eval_every: int,
                   max_rounds: int, verbose: bool) -> dict:
    """``run_fl``'s history of a run read back at its end (an RMSE at each
    chunk's last round)."""
    history = {"round": list(range(rounds_run)), "train_loss": losses,
               "comm": comms, "rmse": []}
    for i, rmse in enumerate(rmses):
        r_end = min((i + 1) * eval_every, max_rounds) - 1
        history["rmse"].append((r_end, rmse))
        if verbose:
            print(f"round {r_end:4d}  loss {losses[r_end]:.4f}  "
                  f"rmse {rmse:.4f}  comm {comms[r_end]:.3e}")
    return history


@contextlib.contextmanager
def _capture_graph(graph, pool, stream):
    """Capture the work this thread enqueues in the block into ``graph`` on
    ``stream`` (which must not be the legacy default stream), allocating
    from ``pool``. The capture is in ``thread_local`` error mode: only this
    thread's unsafe calls break it, so other threads may go on with their
    own device work meanwhile (a server's forwards, its pinned copies and
    allocations). Unlike ``torch.cuda.graph`` it neither synchronizes the
    card nor empties the allocator's cache before it starts, which would
    wait for, and take the cached memory of, the other threads' work."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass      # the capture is void; the body's error says why
            raise
        graph.capture_end()


class _WhileRun:
    """One run of the while driver (the reference's ``_run_while_impl``):
    chunks of ``eval_every`` rounds, the last of ``max_rounds % eval_every``
    when that is not 0, with the patience state, both counters and the
    history buffers on the device (:func:`_while_chunk`).

    On the CPU each chunk runs eagerly. On the card each chunk length is
    captured once as a ``torch.cuda.CUDAGraph`` that reads and writes the
    static tensors ``state`` and ``flags``; one warm-up round on copies, on
    a side stream, comes first (it builds the kernels and allocates
    psgf_mix's ticket counter, neither of which may happen under capture),
    and a failed capture or replay raises: there is no eager fallback on the
    card. The set-up waits on its own streams only and captures in
    ``thread_local`` mode (:func:`_capture_graph`), so it may run while
    another thread serves on the same card. :meth:`launch` enqueues the chunks, :meth:`read` is the run's one
    blocking read. ``warmup_s`` and ``capture_s`` (capture and instantiate)
    time the set-up, ``replay_s`` the first replay to the end of
    :meth:`read`; ``replays`` counts the replays of each chunk length, and
    ``graphs`` holds one graph per length."""

    def __init__(self, state, key, train_data, test_data, model_cfg, fl_cfg,
                 meta, policy, max_rounds: int, eval_every: int,
                 patience: int):
        dev = key.device
        full, rem = divmod(max_rounds, eval_every)
        self.lengths = [eval_every] * full + ([rem] if rem else [])
        self.state = state
        self.flags = _while_flags(key, len(self.lengths), eval_every)
        self._chunk = lambda st, fl, rounds: _while_chunk(  # noqa: E731
            st, fl, rounds, train_data, test_data, model_cfg, fl_cfg, meta,
            policy, max_rounds, patience)
        self.graphs = {}
        self.replays = {length: 0 for length in self.lengths}
        self.warmup_s = self.capture_s = self.replay_s = 0.0
        self._t0 = None
        if dev.type == "cuda":
            self._capture()

    def _capture(self):
        dev = self.flags["key"].device
        current = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._chunk({k: v.clone() for k, v in self.state.items()},
                        {k: v.clone() for k, v in self.flags.items()}, 1)
        side.synchronize()      # this run's streams only, not the card
        t1 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(side)
        pool = None
        for length in sorted(set(self.lengths), reverse=True):
            graph = torch.cuda.CUDAGraph()
            with _capture_graph(graph, pool, stream):
                state, flags = self._chunk(self.state, self.flags, length)
                for k, v in state.items():
                    self.state[k].copy_(v)
                for k, v in flags.items():
                    self.flags[k].copy_(v)
            del state, flags      # lets the next capture reuse the pool
            pool = graph.pool()   # graphs replay in turn, never at once
            self.graphs[length] = graph
        current.wait_stream(stream)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def launch(self):
        """Enqueue the chunks in order. Before it enqueues chunk ``c`` the
        host reads chunk ``c - 2``'s stop flag, copied into pinned memory
        behind an event, and ends the run if it is set: chunk ``c - 1`` is
        already queued, so the card never waits on the host and at most one
        chunk runs past the stop, masked. No call in the loop waits for the
        card, other than on the event of a chunk older than the one in
        flight."""
        cuda = bool(self.graphs)
        stops = [torch.zeros((), dtype=torch.bool, pin_memory=cuda)
                 for _ in self.lengths]
        events = []
        self._t0 = time.perf_counter()
        for c, length in enumerate(self.lengths):
            if c >= 2:
                if cuda:
                    events[c - 2].synchronize()
                if stops[c - 2]:
                    break
            if cuda:
                self.graphs[length].replay()
            else:
                self.state, self.flags = self._chunk(self.state, self.flags,
                                                     length)
            self.replays[length] += 1
            stops[c].copy_(self.flags["stop"], non_blocking=cuda)
            if cuda:
                events.append(torch.cuda.Event())
                events[-1].record()

    def read(self):
        """The run's one blocking read: ``(rounds_run, chunks_run, losses,
        comm totals, RMSE per chunk)`` as Python lists of the rounds and
        chunks run."""
        out = _read_while(self.flags)
        if self._t0 is not None:
            self.replay_s = time.perf_counter() - self._t0
        return out


def run_fl(
    model_cfg: forecast.ForecastConfig,
    fl_cfg: FLConfig,
    train_data,
    test_data,
    key,
    max_rounds: int = 300,
    patience: int = 10,
    eval_every: int = 10,
    verbose: bool = False,
    driver: str = "scan",
    policy=None,
    shard_clients: bool = False,
    client_mesh=None,
    checkpoint_dir: Optional[str] = None,
    init_params=None,
    device=DEFAULT_DEVICE,
):
    """Multi-round FL on ``device``. Returns the reference's history dict:
    per-round ``train_loss`` and cumulative ``comm``, ``rmse`` entries
    ``(round, rmse)``, ``final_rmse``, ``final_comm``,
    ``final_comm_bytes``, ``final_scale_bytes``, ``rounds_run``, the final
    ``state`` and ``meta``.

    ``train_data``/``test_data`` (numpy arrays or tensors) are the
    materialized ``(K, n_win, L+T)`` windows, or with
    ``fl_cfg.streaming_windows`` the raw ``(K, T)`` split slices.

    Drivers, the same rounds from the same key:

    * ``"loop"`` checks patience after every round;
    * ``"scan"`` (default) runs ``eval_every`` rounds per chunk and checks
      patience and evaluates at chunk boundaries only, so its
      ``rounds_run`` equals the reference's scan and while drivers';
    * ``"while"`` stops where scan stops, with the patience test and the
      history on the device (:class:`_WhileRun`: CUDA-graph chunks on the
      card, no host read per chunk); ``history["while_run"]`` holds the
      chunk lengths captured, the replays of each, and the set-up and
      replay times;
    * ``"host"`` keeps the client state in host memory and moves each
      round's cohort only (:func:`repro_torch.core.fl.client_store.
      run_fl_host`; needs ``streaming_windows``; the loop driver's stop;
      ``history["client_store"]``); under an initialized process group each
      process holds one block of the store.

    ``client_mesh`` (``launch.mesh.make_client_mesh``) with ``"scan"`` or
    ``"while"``: across the processes of a ``multi_host=True`` mesh each
    holds its block of the client rows on its device
    (:func:`repro_torch.core.fl.partition.run_fl_mesh`: ``state`` holds
    those rows, ``history["owned_rows"]`` says which, ``history
    ["exchange"]`` the bytes and seconds of each exchange). A mesh of
    several devices of this process (``shard_clients=True``: every local
    GPU; a device may repeat) runs one shard a device, each on its own
    stream, in this process: ``state`` holds the whole client axis on the
    mesh's first device (``device`` must be that device), ``history
    ["mesh_run"]`` the shards, their devices and ``sharded``: False when
    the shards do not divide K or the cohort, and the run is then the
    unsharded one there (the reference's replicated leaves). Bit for bit
    the unsharded run under ``partition.validate_partition``; otherwise
    (``client_chunk``) its RMSE within the reference's ``rtol=1e-5``. On
    one device either is the unsharded run. Across processes with several
    devices in each (``make_client_mesh(multi_host=True)`` where a process
    has several local GPUs, or ``Mesh(axis, devices, index, count,
    backend)``), each process runs one shard a device of its own and
    ``state`` holds its block of the client rows.

    ``init_params`` warm-starts from a params tree. ``checkpoint_dir`` saves
    the final global model with ``save_forecaster`` (process 0 alone across
    processes).
    """
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if driver not in ("loop", "scan", "while", "host"):
        raise ValueError(f"unknown driver: {driver!r}")
    if client_mesh is not None and driver not in ("while", "scan"):
        raise ValueError(
            f"client_mesh applies to driver='while'|'scan' (got {driver!r}); "
            f"driver='host' spans processes through the ClientStore's own "
            f"partition mode (automatic under an initialized process group)")
    if driver == "host":
        # before any (K, D) allocation on the device: that is what it avoids
        from repro_torch.core.fl.client_store import run_fl_host

        return run_fl_host(model_cfg, fl_cfg, train_data, test_data, key,
                           max_rounds=max_rounds, patience=patience,
                           eval_every=eval_every, verbose=verbose,
                           policy=policy, checkpoint_dir=checkpoint_dir,
                           init_params=init_params, device=device)
    dev = resolve_device(device)
    _check_layout(model_cfg, fl_cfg, train_data, test_data)
    mesh_record = None
    if shard_clients or client_mesh is not None:
        from repro_torch.launch.mesh import make_client_mesh

        mesh = client_mesh if client_mesh is not None else make_client_mesh(
            device=dev)
        n = len(mesh.devices)
        if mesh.count > 1 or n > 1:
            if normalized(dev) != normalized(mesh.device):
                raise ValueError(f"run_fl(device={device!r}) but the mesh's "
                                 f"first device is {mesh.device}")
            K, S = fl_cfg.num_clients, fl_cfg.participation_size()
            if mesh.count > 1 or not (K % n or S % n):
                from repro_torch.core.fl.partition import run_fl_mesh

                return run_fl_mesh(model_cfg, fl_cfg, train_data, test_data,
                                   key, mesh, driver=driver,
                                   max_rounds=max_rounds, patience=patience,
                                   eval_every=eval_every, verbose=verbose,
                                   policy=policy,
                                   checkpoint_dir=checkpoint_dir,
                                   init_params=init_params)
            # the reference's rule (client_state_shardings): a client axis
            # that the devices do not divide stays replicated, which is the
            # unsharded run below on the mesh's first device
            mesh_record = {"processes": 1, "shards": n, "sharded": False,
                           "device": str(mesh.device),
                           "devices": [str(d) for d in mesh.devices]}
            dev = mesh.device
        # one process on one device: the unsharded run below, bit for bit
    train_data = _as_device(train_data, dev, torch.float32)
    test_data = _as_device(test_data, dev, torch.float32)
    policy = pol.from_config(fl_cfg) if policy is None else policy
    key = _as_device(key, dev, torch.int64)
    key, init_key = R.split(key).unbind(0)
    state, meta = init_fl_state(model_cfg, fl_cfg, init_key,
                                init_params=init_params, device=dev)

    history = {"round": [], "train_loss": [], "comm": [], "rmse": []}
    comm_total = 0.0

    def rmse_now():
        return float(_rmse_device(model_cfg, state["w_global"], meta,
                                  test_data, fl_cfg.client_chunk))

    if driver == "while":
        run = _WhileRun(state, key, train_data, test_data, model_cfg, fl_cfg,
                        meta, policy, max_rounds, eval_every, patience)
        run.launch()
        rounds_run, _, losses, comms, rmses = run.read()
        state = run.state
        history = _chunk_history(rounds_run, losses, comms, rmses, eval_every,
                                 max_rounds, verbose)
        comm_total = comms[-1] if comms else 0.0
        # the run's record, not the run: its graphs and their memory pool
        # go with it, and nothing replays into the returned state again
        history["while_run"] = {
            "captured": sorted(run.graphs), "replays": dict(run.replays),
            "warmup_s": run.warmup_s, "capture_s": run.capture_s,
            "replay_s": run.replay_s}
        del run
    else:
        best_loss, stall = math.inf, 0
        r, stop = 0, False
        while r < max_rounds and not stop:
            # loop: one round per chunk; scan: eval_every rounds, one read
            n = 1 if driver == "loop" else min(eval_every, max_rounds - r)
            state, key, ms = _run_chunk(state, key, train_data, model_cfg,
                                        fl_cfg, meta, policy, n)
            losses = ms["train_loss"].cpu().tolist()
            comms = ms["comm_total"].cpu().tolist()
            history["round"].extend(range(r, r + n))
            history["train_loss"].extend(losses)
            history["comm"].extend(comms)
            comm_total = comms[-1]
            r += n
            if driver == "loop" and (r % eval_every == 0 or r == max_rounds):
                history["rmse"].append((r - 1, rmse_now()))
            for loss in losses:
                if _improved(loss, best_loss):
                    best_loss, stall = loss, 0
                else:
                    stall += 1
                    if stall >= patience:
                        stop = True
                        break
            if driver == "scan":
                history["rmse"].append((r - 1, rmse_now()))
            if verbose and history["rmse"] and history["rmse"][-1][0] == r - 1:
                print(f"round {r - 1:4d}  loss {losses[-1]:.4f}  "
                      f"rmse {history['rmse'][-1][1]:.4f}  comm {comm_total:.3e}")

    # the last chunk boundary evaluated the final state unless the loop
    # driver stopped between evaluations
    if history["rmse"] and history["rmse"][-1][0] == len(history["round"]) - 1:
        final_rmse = history["rmse"][-1][1]
    else:
        final_rmse = rmse_now()
    if mesh_record is not None:
        history["mesh_run"] = mesh_record
    return _finalize_history(history, state, meta, model_cfg, fl_cfg,
                             final_rmse, comm_total, checkpoint_dir)


def _check_layout(model_cfg, fl_cfg, train_data, test_data):
    """Raise unless the data's layout matches ``fl_cfg.streaming_windows``
    (and raw slices hold at least one window)."""
    want = 2 if fl_cfg.streaming_windows else 3
    if train_data.ndim != want or test_data.ndim != want:
        raise ValueError(
            f"streaming_windows={fl_cfg.streaming_windows} expects "
            f"{want}-D train/test data "
            f"({'raw (K, T) series slices' if want == 2 else 'materialized (K, n_win, L+T) windows'}), "
            f"got ndim {train_data.ndim}/{test_data.ndim} — build the inputs "
            f"with repro_torch.data.windowing."
            f"{'client_series_datasets' if want == 2 else 'client_datasets'}")
    if fl_cfg.streaming_windows:
        W = model_cfg.look_back + model_cfg.horizon
        if min(train_data.shape[1], test_data.shape[1]) < W:
            raise ValueError(
                f"raw series slices too short for look_back+horizon={W}: "
                f"train T={train_data.shape[1]}, test T={test_data.shape[1]}")


def _finalize_history(history, state, meta, model_cfg, fl_cfg, final_rmse,
                      comm_total, checkpoint_dir):
    """Summary fields, and with ``checkpoint_dir`` the trained GLOBAL model
    in ``load_forecaster`` format (what ``ForecastServer`` restores)."""
    history["final_rmse"] = final_rmse
    history["final_comm"] = comm_total
    scale_count = (float(state["comm_scales"])
                   if "comm_scales" in state else 0.0)
    history["final_scale_bytes"] = scale_count * 4.0
    history["final_comm_bytes"] = (comm_total * (fl_cfg.comm_bits / 8.0)
                                   + scale_count * 4.0)
    history["rounds_run"] = len(history["round"])
    history["state"] = state
    history["meta"] = meta
    if checkpoint_dir is not None:
        from repro_torch.core.forecaster import Forecaster, save_forecaster

        params = pt.tree_unflatten_from_vector(state["w_global"], meta)
        history["checkpoint"] = save_forecaster(
            checkpoint_dir, Forecaster(model_cfg), params,
            step=history["rounds_run"],
            extra={"final_rmse": final_rmse, "final_comm": comm_total,
                   "policy": fl_cfg.policy, "num_clients": fl_cfg.num_clients})
    return history
