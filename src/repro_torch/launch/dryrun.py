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
that does not default to the card. A record (:func:`account_combo`) holds:

  * ``status`` (``ok`` or ``skipped`` with the reason, per
    ``launch.shapes.shape_supported``) and ``mesh_shape``;
  * ``memory``: the exact per-device bytes of the step's arguments from
    their shard shapes (``sharding.rules``), and with ``peak=True`` one
    device's estimated peak while the step runs (``launch.cost``);
  * ``cost``: the step's global matmul FLOPs, counted on meta tensors, and
    the FLOPs per device as global / chips (``ideal``: perfect sharding);
  * ``roofline``: seconds per device against ``common.hw``'s H100 peaks,
    the FLOPs at the bf16 tensor-core rate and the argument bytes (each read
    once) at the HBM rate, and which of the two bounds it;
  * ``collectives``: the reference's ``collective_bytes`` dict of the step
    on the production mesh (``launch.cost.collective_bytes``, with
    ``cross_pod`` on two pods of 256 ranks): the step runs over
    DTensors laid out by the rules on a ``fake`` process group of 512 ranks
    (``launch.mesh.accounting_group``, opened once per process), so the
    bytes are DTensor's choice of collectives, not XLA's, and differ
    between torch versions (``torch`` names the one that counted them).
    Where a step cannot run there, ``collectives`` holds the ``error`` and
    the op;
  * ``dropped_shardings``.

The kernel wrappers run their plain versions' arithmetic on meta tensors:
flash attention counts the full S x S products, where the kernel skips the
blocks its mask drops (``flops_note`` says so). Counting runs every
operation through Python, so a stack of layers is counted at depths 1 and
2 and extrapolated linearly to its depth, which is exact for a stack of
identical layers (the reference's roofline extrapolates over depth too).
Where a pass loops over positions in Python (the xLSTM cells, the plain
ssm_scan), it is counted at three short lengths as well and extrapolated
as a quadratic in length (attention's S x S term); such a record says
``extrapolated``. The collectives are counted and fitted the same way,
each of their numbers on its own (the decoders hold every layer's input to
one layout, so each layer issues the same collectives), a looped family's
at :data:`COLLECTIVE_LENGTHS`.

Dropped from the reference: its first lines, which set ``XLA_FLAGS`` for
512 placeholder host devices (the fake process group plays them), its
``lower_s`` / ``compile_s`` (there is no XLA compile) and the compiled
``memory_analysis`` (replaced by the argument bytes and the peak
estimate).
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
# the depths and lengths a count is extrapolated from
COUNT_DEPTHS = (1, 2)
COUNT_LENGTHS = (16, 32, 48)
# the lengths a looped family's collectives are counted at: from 32 tokens
# on each layer issues the same collectives with bytes linear in the length
# (hymba-1.5b train_4k on 16 x 16: 93 at 32 to 192 tokens), where at 16 a
# sequence as short as a mesh axis gets others (103)
COLLECTIVE_LENGTHS = (64, 128, 192)
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


def step_flops(cfg: ModelConfig, shape: InputShape) -> int:
    """Matmul FLOPs of one step of ``shape.kind`` for ``cfg``, counted
    directly on meta tensors: a train step (forward, backward, optimizer),
    a prefill, or one decode step with a cache of ``shape.seq_len``."""
    if shape.kind == "train":
        fn, api, optimizer = build_train_step(cfg, make_optimizer(cfg), "meta")
        args = (api.abstract_params(), abstract_opt_state(api, optimizer),
                input_structs(cfg, shape))
    elif shape.kind == "prefill":
        fn, api, _ = build_prefill_step(cfg, "meta")
        args = (api.abstract_params(torch.bfloat16), input_structs(cfg, shape))
    else:
        fn, api, _ = build_serve_step(cfg, "meta")
        rest = input_structs(cfg, shape)
        args = (api.abstract_params(torch.bfloat16), rest["cache"], rest["token"],
                shape.seq_len - 1)
    with torch.inference_mode(shape.kind != "train"):
        return cost.cost_summary(fn, *args)["flops"]


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


def _extrapolate(cfg: ModelConfig, shape: InputShape, lengths, count, nest=None):
    """``count(cfg', shape')`` (a dict of integers) at depth 1 and with each
    depth field at 2, and, given ``lengths`` (three), at each of those
    sequence lengths; each key's exact fit of ``(1 + depths) x (1, S,
    S^2)`` through them, evaluated at ``cfg``'s depths and
    ``shape.seq_len``. Returns ``(fitted, points)``, each point's counts
    under ``nest`` (or merged into it)."""
    fields = _depth_fields(cfg)
    depth_points = [(COUNT_DEPTHS[0],) * len(fields)] + [
        tuple(COUNT_DEPTHS[1] if i == j else COUNT_DEPTHS[0]
              for i in range(len(fields))) for j in range(len(fields))]
    points, rows, counted = [], [], []
    for length in (lengths or (None,)):
        at = shape if length is None else dataclasses.replace(shape, seq_len=length)
        for depths in depth_points:
            got = count(_at_depths(cfg, depths), at)
            point = {"depths": dict(zip(fields, depths)), "seq_len": at.seq_len}
            point.update({nest: got} if nest else got)
            points.append(point)
            rows.append(_basis(depths, length))
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


def step_collectives(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """The reference's ``collective_bytes`` dict of one step of
    ``shape.kind`` for ``cfg`` on ``mesh`` (an ``AbstractMesh``), counted
    directly: the step over DTensors laid out by the train or serve rules,
    on the accounting group; ``cross_pod`` when the mesh has a ``pod``
    axis (a pod being the ranks of one ``pod`` index)."""
    dm = accounting_mesh(mesh)
    if shape.kind == "train":
        optimizer = make_optimizer(cfg)
        fn, api, _ = build_train_step(cfg, optimizer, "meta", mesh=dm)
        args = sharded_train_inputs(cfg, shape, make_rules(mesh, "train"), optimizer)
    elif shape.kind == "prefill":
        fn, api, rules = build_prefill_step(cfg, "meta", mesh=dm)
        args = sharded_serve_inputs(cfg, shape, rules)
    else:
        fn, api, rules = build_serve_step(cfg, "meta", mesh=dm)
        params, rest = sharded_serve_inputs(cfg, shape, rules)
        args = (params, rest["cache"], rest["token"], shape.seq_len - 1)
    args = tuple(a if isinstance(a, int) else distribute_structs(a, dm)
                 for a in args)
    pod_size = mesh.size // mesh.shape["pod"] if "pod" in mesh.shape else None
    with torch.set_grad_enabled(shape.kind == "train"):
        return cost.collective_bytes(fn, *args, pod_size=pod_size)


@functools.lru_cache(maxsize=None)
def count_collectives(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """:func:`step_collectives` extrapolated over depth (and for a looped
    family's train / prefill step over length, at
    :data:`COLLECTIVE_LENGTHS`) as :func:`count_flops` does, each number
    fitted on its own; ``extrapolated`` lists the counted points."""
    looped = shape.kind != "decode" and cfg.family in LOOPED_FAMILIES
    lengths = COLLECTIVE_LENGTHS if looped else None
    fitted, points = _extrapolate(
        cfg, shape, lengths, lambda c, s: step_collectives(c, s, mesh),
        nest="collectives")
    out = {k: v for k, v in fitted.items()
           if v or k in ("total", "count", "cross_pod")}
    out["extrapolated"] = {"depths": list(COUNT_DEPTHS), "points": points}
    if looped:
        out["extrapolated"]["lengths"] = list(lengths)
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
    tensor-core rate and the argument bytes at the HBM rate."""
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


def account_combo(arch_id: str, shape_name: str, multi_pod: bool,
                  cfg_override=None, peak: bool = False,
                  collectives: bool = True) -> dict:
    """Account one combo on the production mesh; returns the record. With
    ``peak``, a train shape's record also holds one device's estimated peak
    for the whole step (the whole model and global batch on one card).
    ``collectives`` (default) counts the step's collectives on the
    accounting group (:func:`count_collectives`), which this process then
    holds as its default process group; where the step cannot run over
    DTensors the record's ``collectives`` is ``{"error": ...}`` naming the
    op, and its status stays ``ok``."""
    shape = SHAPES[shape_name]
    cfg = cfg_override or get_config(arch_id)
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    cfg = shape_variant(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    optimizer = make_optimizer(cfg)
    if shape.kind == "train":
        rules = make_rules(mesh, "train")
        params, opt, batch = sharded_train_inputs(cfg, shape, rules, optimizer)
        arguments = {"params": params, "opt_state": opt, "batch": batch}
    else:
        rules = make_rules(mesh, "serve")
        params, rest = sharded_serve_inputs(cfg, shape, rules)
        arguments = {"params": params, ("batch" if shape.kind == "prefill"
                                        else "cache_token_pos"): rest}
    memory = {"argument_bytes_per_device": cost.argument_bytes(**arguments)}
    if peak and shape.kind == "train":
        fn, args = _train_peak_args(cfg, shape, optimizer, 1)
        memory["peak_one_device"] = cost.peak_bytes(fn, *args)
    counted = count_flops(cfg, shape)
    chips = mesh.size
    per_device = counted["flops"] / chips
    arg_bytes = memory["argument_bytes_per_device"]["total"]
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": dict(mesh.shape), "status": "ok", "kind": shape.kind,
        "memory": memory,
        "cost": {**counted, "flops_per_device": per_device,
                 "flops_per_device_ideal": True},
        "roofline": {**roofline(per_device, arg_bytes), "hw": "H100 SXM"},
        "dropped_shardings": sorted(str(d) for d in rules.dropped),
    }
    if collectives:
        try:
            counted = dict(count_collectives(cfg, shape, mesh))
        except Exception as e:  # noqa: BLE001  (recorded: the op DTensor could not place)
            traceback.print_exc()
            counted = {"error": f"{type(e).__name__}: {e}"[:2000]}
        # DTensor's choice of collectives differs between torch versions
        rec["collectives"] = dict(counted, torch=torch.__version__)
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
                if rec["status"] == "ok":
                    print(json.dumps(rec["roofline"]), flush=True)
                print(f"-> {rec['status']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
