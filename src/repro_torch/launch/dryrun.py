"""Dry run of the model zoo: for each (architecture x input shape x mesh)
combination, account what one step costs on the production meshes
(counterpart of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod/--single-pod]
Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``DRYRUN_OUT`` overrides the directory).

It needs no GPU: every tensor is on ``meta`` (shapes and dtypes, no
storage), so it runs anywhere, and it is the one entry point of the port
that does not default to the card. As the reference reads the
SPMD-compiled step, which is the per-device program, the step runs here
over DTensors laid out by the train or serve rules on a ``fake`` process
group of 512 ranks (``launch.mesh.accounting_group``, opened once per
process; this process plays rank 0), and every number but the global
FLOPs is counted on rank 0's local shards by one pass of
``launch.cost.account``. A record (:func:`account_combo`) holds:

  * ``status`` (``ok`` or ``skipped`` with the reason, per
    ``launch.shapes.shape_supported``) and ``mesh_shape``;
  * ``memory``, the reference's ``memory_summary`` per device:
    ``argument_size_in_bytes`` (exact, from the shard shapes of
    ``sharding.rules``; ``argument_bytes`` breaks it down),
    ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs in an
    argument's storage: the train step's params and moments, decode's
    cache, which the reference donates), ``temp_size_in_bytes`` (the peak
    less the arguments), ``peak_bytes`` with ``peak_by_phase`` (forward,
    backward, and ``after``: the optimizer), ``fits_hbm`` (the peak within
    ``common.hw.HBM_BYTES``); with ``peak=True`` a train shape's record
    also holds ``peak_one_device``, the whole step on one card;
  * ``cost``, the reference's ``cost_summary`` per device: ``flops``
    (matmul FLOPs of the local products), ``bytes_accessed`` (each eager
    op's operands and results: an upper bound of XLA's fused count) and
    ``transcendentals``; beside them ``flops_global``, the whole step's
    matmul FLOPs on one device's meta tensors, and ``flops_note``;
  * ``roofline``: seconds per device against ``common.hw``'s H100 peaks,
    the FLOPs at the bf16 tensor-core rate and the bytes accessed at the
    HBM rate, and which of the two bounds it;
  * ``collectives``: the reference's ``collective_bytes`` dict of the step
    (with ``cross_pod`` on two pods of 256 ranks): DTensor's choice of
    collectives, not XLA's, which differs between torch versions
    (``torch`` names the one that counted them);
  * ``dropped_shardings``, and for an extrapolated step ``extrapolated``.

Where a step cannot run over DTensors, ``memory``, ``cost`` and
``collectives`` hold the ``error``, naming the op; the status stays ``ok``.

The kernel wrappers' forwards on meta tensors allocate what the kernels
allocate and count by formula (``kernels._meta``): flash attention counts
the full S x S products, where the kernel skips the blocks its mask drops
(``flops_note`` says so). Each step is counted whole at the config's depth
and length, which takes seconds; a peak is not a sum over ops, so only a
whole count gives it exactly. Where a pass loops over the sequence in
Python (:func:`extrapolated`: the xLSTM cells, ssm_scan's backward in a
hybrid's train step, MLA's blocks in a long prefill) the count is fitted
over depth instead, through :data:`FIT_DEPTHS` at the shape's own length,
and for the xLSTM, too slow at that length, over length as well, through
:data:`FIT_LENGTHS` (a fit over length can miss a peak that only long
sequences reach, as hymba's ssm_scan backward's (B, S, D, N) states), each
number on its own: exact for FLOPs, bytes,
transcendentals, argument, output and alias bytes and the collectives (the
decoders hold every layer's input to one layout, so each layer issues the
same collectives), and for the forward's peak; a train step's update is
counted whole (:func:`update_counts`); the backward's fitted peak is at
most its count, where the op that peaks changes with the depth. The global
FLOPs are fitted through depths 1 and 2 (:data:`COUNT_DEPTHS`), exact for
a stack of identical layers, as the reference's roofline extrapolates.

Dropped from the reference: its first lines, which set ``XLA_FLAGS`` for
512 placeholder host devices (the fake process group plays them), its
``lower_s`` / ``compile_s``, and ``memory_summary``'s
``generated_code_size_in_bytes`` and ``host_argument_size_in_bytes``:
nothing is lowered or compiled, so there is no program to time or size,
and every argument lives on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import traceback
from fractions import Fraction

import torch

from repro_torch.common import hw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cost
from repro_torch.launch.api import distribute_structs, input_structs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, InputShape, shape_supported, shape_variant
from repro_torch.launch.steps import (abstract_opt_state, build_prefill_step,
                                      build_serve_step, build_train_step,
                                      make_optimizer, sharded_serve_inputs,
                                      sharded_train_inputs)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import make_rules

OUT_DIR = os.environ.get(
    "DRYRUN_OUT",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                 "dryrun_torch"))

# families with a pass that loops over positions in Python
LOOPED_FAMILIES = ("ssm", "hybrid")
# the depths and lengths the global FLOPs are extrapolated from
COUNT_DEPTHS = (1, 2)
COUNT_LENGTHS = (16, 32, 48)
# the lengths an xLSTM step's per-device counts are fitted through (its
# cells loop over positions, forward and backward, too slowly for a count
# at the shape's length: hymba's is counted there): from 32 tokens on each
# layer issues the same collectives with bytes linear in the length
# (hymba-1.5b train_4k on 16 x 16: 93 at 32 to 192 tokens), where at 16 a
# sequence as short as a mesh axis gets others (103)
FIT_LENGTHS = (64, 128, 192)
# the depths a per-device count is extrapolated from: at depth 1 the
# forward's peak lacks a 4-byte scalar that every deeper step holds, so a
# fit through depth 1 is 4 bytes a layer off
FIT_DEPTHS = (2, 3)
# MLA's prefill past this many tokens runs ``flash_mha``'s blocks in a
# Python loop too long to count whole (deepseek-v2's 60 layers at 32,768)
MLA_DIRECT_TOKENS = 4096
FLOPS_NOTE = ("matmul FLOPs of the plain versions: flash attention's full "
              "S x S products (the kernel skips masked blocks); a train step "
              "includes its backward and the remat recompute")


def _depth_fields(cfg: ModelConfig) -> tuple:
    return ("enc_layers", "dec_layers") if cfg.family == "audio" else ("num_layers",)


def _depths(cfg: ModelConfig) -> tuple:
    if cfg.family == "audio":
        return (cfg.encdec.enc_layers, cfg.encdec.dec_layers)
    return (cfg.num_layers,)


def _at_depths(cfg: ModelConfig, depths) -> ModelConfig:
    if cfg.family == "audio":
        return dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, enc_layers=depths[0], dec_layers=depths[1]))
    return dataclasses.replace(cfg, num_layers=depths[0])


def step_inputs(cfg: ModelConfig, shape: InputShape, mesh=None, optimizer=None):
    """``(fn, args)`` of one step of ``shape.kind`` for ``cfg`` on ``meta``
    tensors: a train step (forward, backward, optimizer), a prefill, or one
    decode step with a cache of ``shape.seq_len``. Without ``mesh`` the
    one-device step on whole tensors; with ``mesh`` (an ``AbstractMesh``)
    the step over DTensors laid out by the train or serve rules on the
    accounting group (:func:`accounting_mesh`). ``optimizer``: the train
    step's (default ``make_optimizer(cfg)``)."""
    dm = None if mesh is None else accounting_mesh(mesh)
    if shape.kind == "train":
        optimizer = optimizer or make_optimizer(cfg)
        fn, api, _ = build_train_step(cfg, optimizer, "meta", mesh=dm)
        if mesh is None:
            args = (api.abstract_params(), abstract_opt_state(api, optimizer),
                    input_structs(cfg, shape))
        else:
            args = sharded_train_inputs(cfg, shape, make_rules(mesh, "train"), optimizer)
    elif shape.kind == "prefill":
        fn, api, rules = build_prefill_step(cfg, "meta", mesh=dm)
        args = ((api.abstract_params(torch.bfloat16), input_structs(cfg, shape))
                if mesh is None else sharded_serve_inputs(cfg, shape, rules))
    else:
        fn, api, rules = build_serve_step(cfg, "meta", mesh=dm)
        if mesh is None:
            params, rest = api.abstract_params(torch.bfloat16), input_structs(cfg, shape)
        else:
            params, rest = sharded_serve_inputs(cfg, shape, rules)
        args = (params, rest["cache"], rest["token"], shape.seq_len - 1)
    if dm is not None:
        args = tuple(a if isinstance(a, int) else distribute_structs(a, dm)
                     for a in args)
    return fn, args


def step_flops(cfg: ModelConfig, shape: InputShape) -> int:
    """Global matmul FLOPs of one step of ``shape.kind`` for ``cfg``,
    counted directly on the one-device step (:func:`step_inputs`)."""
    fn, args = step_inputs(cfg, shape)
    with torch.inference_mode(shape.kind != "train"):
        return cost.cost_summary(fn, *args)["flops"]


# the per-device counts of a step (``launch.cost.account``) that are fitted
# over depth, each on its own; the peak is kept per phase (``peak_forward``
# ...) and the collectives' dict under ``collectives/``
COUNT_KEYS = ("flops", "bytes_accessed", "transcendentals", "argument_bytes",
              "output_bytes", "alias_bytes")


def _pod_size(mesh):
    return mesh.size // mesh.shape["pod"] if "pod" in mesh.shape else None


def step_counts(cfg: ModelConfig, shape: InputShape, mesh, optimizer=None,
                keep=None, whole=True) -> dict:
    """One device's counts of one step on ``mesh`` (an ``AbstractMesh``),
    counted directly (:func:`step_inputs`, ``launch.cost.account``) and
    flat: :data:`COUNT_KEYS`, ``peak_<phase>``, and ``collectives/<key>``
    (``cross_pod`` when the mesh has a ``pod`` axis, a pod being the ranks
    of one ``pod`` index). With ``whole=False`` a train step is counted up
    to its gradients (``fn.gradients``, the optimizer's state live
    throughout; ``output_bytes`` the metrics', ``alias_bytes`` 0), which
    :func:`count_step` completes with :func:`update_counts`. ``keep`` (a
    dict) receives the result."""
    fn, args = step_inputs(cfg, shape, mesh, optimizer)
    run, split = fn, shape.kind == "train" and not whole
    if split:
        run = lambda params, opt_state, batch: fn.gradients(params, batch)  # noqa: E731
    keep = {} if keep is None else keep
    with torch.set_grad_enabled(shape.kind == "train"):
        got = cost.account(run, *args, pod_size=_pod_size(mesh), keep=keep)
    flat = {k: got[k] for k in COUNT_KEYS}
    if split:
        flat.update(output_bytes=cost.local_bytes(keep["result"][1]), alias_bytes=0)
    flat.update({f"peak_{p}": v for p, v in got["peak_by_phase"].items()})
    flat.update({f"collectives/{k}": v for k, v in got["collectives"].items()})
    return flat


def update_counts(cfg: ModelConfig, shape: InputShape, mesh, optimizer,
                  grads) -> dict:
    """One device's count of a train step's update at ``cfg``'s depth,
    counted directly: ``fn.apply_gradients`` over the params and moments of
    ``shape``'s inputs and gradients laid out as ``grads`` (a tree of
    DTensors from a shallower step: the same placements, each leaf at its
    full shape). Its arguments are the params, the moments and the
    gradients; the rest of what the step holds then (the batch, the
    metrics) is added by the caller."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.common import pytree_utils as pt

    fn, (params, opt_state, _) = step_inputs(cfg, shape, mesh, optimizer)
    dm = accounting_mesh(mesh)
    placed = dict(pt.flatten_with_paths(grads))

    def grad_like(path, p):
        # the shallow gradient's placements, and its dimensions' order in
        # memory (a tied embedding's gradient comes transposed)
        g = placed[path]
        local, _ = compute_local_shape_and_global_offset(p.shape, dm, g.placements)
        shard = torch.empty(local, dtype=p.dtype, device="meta")
        stride, step = [0] * p.dim(), 1
        for d in sorted(range(p.dim()), key=lambda d: (g.stride()[d], d)):
            stride[d], step = step, step * p.shape[d]
        return DTensor.from_local(shard, dm, g.placements, run_check=False,
                                  shape=p.shape, stride=tuple(stride))

    full = pt.unflatten([(path, grad_like(path, p))
                         for path, p in pt.flatten_with_paths(params)])
    return cost.account(fn.apply_gradients, params, full, opt_state,
                        pod_size=_pod_size(mesh))


def step_collectives(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """The reference's ``collective_bytes`` dict of one step on ``mesh``,
    counted directly (:func:`step_counts`)."""
    return {k.split("/", 1)[1]: v for k, v in step_counts(cfg, shape, mesh).items()
            if k.startswith("collectives/")}


def _solve(rows, rhs):
    """Exact solution of the square system ``rows @ x = rhs`` (Fractions)."""
    n = len(rows)
    a = [[Fraction(v) for v in row] + [Fraction(b)] for row, b in zip(rows, rhs)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col] / a[col][col]
                a[r] = [x - f * y for x, y in zip(a[r], a[col])]
    return [a[r][n] / a[r][r] for r in range(n)]


def _basis(depths, length):
    """Terms of the model: (1, each depth) times (1, S, S^2) if a length is
    fitted."""
    lin = [1] + list(depths)
    if length is None:
        return lin
    return [t * length ** j for j in range(3) for t in lin]


def _extrapolate(cfg: ModelConfig, shape: InputShape, lengths, count, nest=None,
                 depths=COUNT_DEPTHS):
    """``count(cfg', shape')`` (a dict of integers) at ``depths[0]`` and
    with each depth field at ``depths[1]``, and, given ``lengths`` (three),
    at each of those sequence lengths; each key's exact fit of ``(1 +
    depths) x (1, S, S^2)`` through them, evaluated at ``cfg``'s depths and
    ``shape.seq_len``. Returns ``(fitted, points)``, each point's counts
    under ``nest`` (or merged into it)."""
    fields = _depth_fields(cfg)
    depth_points = [(depths[0],) * len(fields)] + [
        tuple(depths[1] if i == j else depths[0]
              for i in range(len(fields))) for j in range(len(fields))]
    points, rows, counted = [], [], []
    for length in (lengths or (None,)):
        at = shape if length is None else dataclasses.replace(shape, seq_len=length)
        for point_depths in depth_points:
            got = count(_at_depths(cfg, point_depths), at)
            point = {"depths": dict(zip(fields, point_depths)), "seq_len": at.seq_len}
            point.update({nest: got} if nest else got)
            points.append(point)
            rows.append(_basis(point_depths, length))
            counted.append(got)
    target = _basis(_depths(cfg), None if lengths is None else shape.seq_len)
    keys = sorted({k for got in counted for k in got})
    fitted = {}
    for key in keys:
        value = sum(c * t for c, t in zip(
            _solve(rows, [int(got.get(key, 0)) for got in counted]), target))
        if value.denominator != 1:
            raise ArithmeticError(f"extrapolated {key} {value} is not an integer")
        fitted[key] = int(value)
    return fitted, points


def extrapolated_flops(cfg: ModelConfig, shape: InputShape, lengths=None):
    """``(flops, points)``: :func:`step_flops` extrapolated over depth (and,
    given ``lengths``, over length) by :func:`_extrapolate`."""
    fitted, points = _extrapolate(
        cfg, shape, lengths, lambda c, s: {"flops": step_flops(c, s)})
    return fitted["flops"], points


# the production meshes' largest size: the accounting group's world
ACCOUNTING_WORLD = 512
_ACCOUNTING = {}


def accounting_mesh(mesh):
    """``mesh`` (an ``AbstractMesh`` of at most :data:`ACCOUNTING_WORLD`
    ranks) as a ``DeviceMesh`` on the accounting group
    (``launch.mesh.accounting_group``), which the first call opens for the
    rest of the process."""
    import atexit
    import contextlib

    from repro_torch.launch import mesh as M

    if "stack" not in _ACCOUNTING:
        stack = contextlib.ExitStack()
        stack.enter_context(M.accounting_group(ACCOUNTING_WORLD))
        atexit.register(stack.close)
        _ACCOUNTING["stack"] = stack
    key = (mesh.axis_names, mesh.axis_sizes)
    if key not in _ACCOUNTING:
        _ACCOUNTING[key] = M.device_mesh(mesh)
    return _ACCOUNTING[key]


def extrapolated(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether :func:`count_step` extrapolates a step rather than counting
    it whole: where a pass loops over the sequence in Python, whose length
    the count's time follows: the xLSTM cells' positions (a train step or a
    prefill), ssm_scan's backward's positions (a hybrid's train step), and
    MLA's ``flash_mha`` blocks past :data:`MLA_DIRECT_TOKENS` (a prefill):
    those take minutes whole on a CPU core, every other step seconds to
    two minutes (deepseek-v2's train_4k, its blocks at 4,096 tokens)."""
    if shape.kind == "decode":
        return False
    if cfg.family == "ssm" or (cfg.family == "hybrid" and shape.kind == "train"):
        return True
    return cfg.mla is not None and shape.kind == "prefill" and (
        shape.seq_len > MLA_DIRECT_TOKENS)


def _add_collectives(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _unflatten_counts(flat: dict) -> dict:
    out = {k: flat[k] for k in COUNT_KEYS}
    out["peak_by_phase"] = {p: flat[f"peak_{p}"] for p in cost.PHASES
                            if f"peak_{p}" in flat}
    out["collectives"] = {k.split("/", 1)[1]: v for k, v in flat.items()
                          if k.startswith("collectives/")}
    return out


@functools.lru_cache(maxsize=None)
def count_step(cfg: ModelConfig, shape: InputShape, mesh, optimizer=None,
               extrapolate=None) -> dict:
    """One device's counts of one step on ``mesh``, a train step's
    optimizer the full config's (its moments' type follows the model's
    size). A step is counted whole (:func:`step_counts`) unless
    :func:`extrapolated`; then over depth, at :data:`FIT_DEPTHS` and the
    shape's own length (an xLSTM's over length too, at
    :data:`FIT_LENGTHS`), each number fitted on its own, the peak per
    phase (a peak is not a sum over ops: each phase's is fitted, and the
    largest taken), and a train step's update counted directly at the full
    depth (:func:`update_counts`), since its temporaries follow each leaf's
    size and the optimizer's slices, not the depth; its peak is the
    ``after`` phase's. Returns :data:`COUNT_KEYS`, ``peak_by_phase``,
    ``peak_bytes`` (the largest phase), the ``collectives`` dict (zeros
    left out but ``total``, ``count`` and ``cross_pod``), and for an
    extrapolated step ``extrapolated`` (the counted points).
    ``optimizer``: a train step's (default ``make_optimizer(cfg)``);
    ``extrapolate`` overrides :func:`extrapolated`."""
    train = shape.kind == "train"
    if train:
        optimizer = optimizer or make_optimizer(cfg)
    if extrapolate is None:
        extrapolate = extrapolated(cfg, shape)
    if not extrapolate:
        out = _unflatten_counts(step_counts(cfg, shape, mesh, optimizer))
    else:
        lengths = FIT_LENGTHS if cfg.family == "ssm" else None
        kept = {}
        fitted, points = _extrapolate(
            cfg, shape, lengths,
            lambda c, s: step_counts(c, s, mesh, optimizer, kept, whole=False),
            nest="counts", depths=FIT_DEPTHS)
        out = _unflatten_counts(fitted)
        if train:
            update = update_counts(cfg, shape, mesh, optimizer, kept["result"][0])
            for k in ("flops", "bytes_accessed", "transcendentals"):
                out[k] += update[k]
            batch = cost.argument_bytes(batch=sharded_train_inputs(
                cfg, shape, make_rules(mesh, "train"), optimizer)[2])["total"]
            metrics = out["output_bytes"]
            out["peak_by_phase"]["after"] = update["peak_bytes"] + batch + metrics
            out["output_bytes"] = update["output_bytes"] + metrics
            out["alias_bytes"] = update["alias_bytes"]
            out["collectives"] = _add_collectives(out["collectives"],
                                                  update["collectives"])
        out["extrapolated"] = {"depths": list(FIT_DEPTHS), "points": points}
        if lengths:
            out["extrapolated"]["lengths"] = list(lengths)
    out["peak_bytes"] = max(out["peak_by_phase"].values())
    out["collectives"] = {k: v for k, v in out["collectives"].items()
                          if v or k in ("total", "count", "cross_pod")}
    return out


@functools.lru_cache(maxsize=None)
def count_flops(cfg: ModelConfig, shape: InputShape) -> dict:
    """Global matmul FLOPs of one step: extrapolated over depth, and for a
    looped family's train / prefill step over length too (``extrapolated``
    then lists the counted points)."""
    looped = shape.kind != "decode" and cfg.family in LOOPED_FAMILIES
    flops, points = extrapolated_flops(cfg, shape, COUNT_LENGTHS if looped else None)
    out = {"flops": flops, "depth_extrapolated": True, "flops_note": FLOPS_NOTE}
    if looped:
        out["extrapolated"] = {"lengths": list(COUNT_LENGTHS), "points": points}
    return out


def roofline(flops_per_device: float, bytes_per_device: float) -> dict:
    """Seconds per device against ``common.hw``: the FLOPs at the bf16
    tensor-core rate and the bytes accessed at the HBM rate."""
    times = {"operations": flops_per_device / hw.BF16_FLOP_PER_S,
             "bytes": bytes_per_device / hw.HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return {"compute_s": times["operations"], "memory_s": times["bytes"],
            "roofline_s": times[by], "bound_by": by}


def _train_peak_args(cfg, shape, optimizer, pods):
    """A one-device train step and its meta arguments; for ``pods`` > 1
    PSGF-DP's local step over pod-stacked params and then a sync, with the
    global model held beside the pods."""
    from repro_torch import random as R
    from repro_torch.core import psgf_dp as P

    fn, api, optimizer = build_train_step(cfg, optimizer, "meta")
    params = api.abstract_params()
    batch = input_structs(cfg, shape)
    if pods == 1:
        return fn, (params, optimizer.init(params), batch)
    local = P.stack_for_pods(params, pods)
    stacked = {k: v[None].repeat(pods, *(1,) * v.dim()) for k, v in batch.items()}
    step = P.make_local_train_step(api.loss_fn, optimizer)
    dp = P.PSGFDPConfig()

    def step_and_sync(glob, local, opt, batch, key):
        local, opt, _ = step(local, opt, batch)
        return P.psgf_sync(local, glob, key, dp, pods)

    return step_and_sync, (params, local, P.init_pod_opt_state(optimizer, local),
                           stacked, R.PRNGKey(0, device="meta"))


def one_device_peak(cfg: ModelConfig, batch: int, seq: int, pods: int = 1) -> dict:
    """One device's estimated peak bytes while ``launch.train`` takes a
    step of ``cfg`` at ``batch`` x ``seq`` tokens (a ``vlm`` model's patches
    come on top): ``train``'s step, or for ``pods`` > 1 ``train_psgf``'s
    local step and a sync. Adam with float32 moments, as the trainers use.
    Returns ``cost.peak_bytes``' record."""
    from repro_torch.optim import Adam, one_cycle

    total = seq + (cfg.vlm.num_patches if cfg.family == "vlm" else 0)
    shape = InputShape("one_device", total, batch, "train")
    fn, args = _train_peak_args(cfg, shape, Adam(lr=one_cycle(3e-4, 10)), pods)
    return cost.peak_bytes(fn, *args)


def account_step(cfg: ModelConfig, shape: InputShape, mesh, per_device: bool = True,
                 optimizer=None) -> dict:
    """The record's accounting of one step of ``shape`` for ``cfg`` (its
    shape variant) on ``mesh`` (an ``AbstractMesh``): ``memory``, ``cost``,
    ``roofline``, ``collectives`` and ``dropped_shardings``, per device
    (the module docstring). Without ``per_device`` only what needs no
    process group: the argument bytes and the global FLOPs. Where the step
    cannot run over DTensors, ``memory``, ``cost`` and ``collectives``
    hold the ``error``, naming the op, and there is no ``roofline``."""
    if shape.kind == "train":
        optimizer = optimizer or make_optimizer(cfg)
        rules = make_rules(mesh, "train")
        params, opt, batch = sharded_train_inputs(cfg, shape, rules, optimizer)
        arguments = {"params": params, "opt_state": opt, "batch": batch}
    else:
        rules = make_rules(mesh, "serve")
        params, rest = sharded_serve_inputs(cfg, shape, rules)
        arguments = {"params": params, ("batch" if shape.kind == "prefill"
                                        else "cache_token_pos"): rest}
    arguments = cost.argument_bytes(**arguments)
    memory = {"argument_size_in_bytes": arguments["total"], "argument_bytes": arguments}
    flops = count_flops(cfg, shape)
    counted_cost = {"flops_global": flops["flops"], "flops_note": FLOPS_NOTE}
    if "extrapolated" in flops:
        counted_cost["flops_global_extrapolated"] = flops["extrapolated"]
    rec = {"memory": memory, "cost": counted_cost,
           "dropped_shardings": sorted(str(d) for d in rules.dropped)}
    if not per_device:
        return rec
    try:
        counted = count_step(cfg, shape, mesh, optimizer)
    except Exception as e:  # noqa: BLE001  (recorded: the op DTensor could not place)
        traceback.print_exc()
        error = {"error": f"{type(e).__name__}: {e}"[:2000]}
        memory.update(error)
        counted_cost.update(error)
        rec["collectives"] = dict(error, torch=torch.__version__)
        return rec
    peak = counted["peak_bytes"]
    memory.update(output_size_in_bytes=counted["output_bytes"],
                  temp_size_in_bytes=peak - arguments["total"],
                  alias_size_in_bytes=counted["alias_bytes"], peak_bytes=peak,
                  peak_by_phase=counted["peak_by_phase"],
                  fits_hbm=peak <= hw.HBM_BYTES)
    counted_cost.update({k: counted[k] for k in ("flops", "bytes_accessed",
                                                 "transcendentals")})
    rec["roofline"] = {**roofline(counted["flops"], counted["bytes_accessed"]),
                       "hw": "H100 SXM"}
    # DTensor's choice of collectives differs between torch versions
    rec["collectives"] = dict(counted["collectives"], torch=torch.__version__)
    if "extrapolated" in counted:
        rec["extrapolated"] = counted["extrapolated"]
    return rec


def account_combo(arch_id: str, shape_name: str, multi_pod: bool,
                  cfg_override=None, peak: bool = False,
                  per_device: bool = True) -> dict:
    """Account one combo on the production mesh; returns the record
    (:func:`account_step`). With ``peak``, a train shape's record also
    holds one device's estimated peak for the whole step (the whole model
    and global batch on one card). ``per_device`` (default) counts on the
    accounting group, which this process then holds as its default process
    group; without it the record holds the argument bytes and the global
    FLOPs alone."""
    shape = SHAPES[shape_name]
    cfg = cfg_override or get_config(arch_id)
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    cfg = shape_variant(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": dict(mesh.shape), "status": "ok", "kind": shape.kind}
    optimizer = make_optimizer(cfg)
    rec.update(account_step(cfg, shape, mesh, per_device, optimizer))
    if peak and shape.kind == "train":
        fn, args = _train_peak_args(cfg, shape, optimizer, 1)
        rec["memory"]["peak_one_device"] = cost.peak_bytes(fn, *args)
    return rec


def save(rec) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return fname


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or args.all:
        meshes.append(True)

    failures = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                fname = f"{arch}__{shp}__{'multi' if mp else 'single'}.json"
                if args.skip_existing and os.path.exists(os.path.join(OUT_DIR, fname)):
                    print(f"SKIP(existing) {fname}")
                    continue
                print(f"=== dryrun {arch} x {shp} x {'multi' if mp else 'single'} ===",
                      flush=True)
                try:
                    rec = account_combo(arch, shp, mp)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shp,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                save(rec)
                if "roofline" in rec:
                    print(json.dumps(rec["roofline"]), flush=True)
                print(f"-> {rec['status']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
