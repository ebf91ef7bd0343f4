#!/usr/bin/env python3
"""The dry run's fit of a step against a whole count of the same step, per
device (accounting on meta tensors, CPU; no GPU).

    PYTHONPATH=src python3 tools/dryrun_fit_check.py --arch hymba-1.5b --shape train_4k
    PYTHONPATH=src python3 tools/dryrun_fit_check.py --arch xlstm-125m --shape train_4k --seq 512

It counts one step of the shape (its sequence cut to ``--seq`` where
given) on the production mesh twice: by ``launch.dryrun.count_step``'s
fit (over depth, and for the xLSTM over length too, whether or not the
dry run would extrapolate the step) and whole, in one pass of
``launch.cost.account``; and prints one JSON line: the seconds of each
and every number of the record's ``memory`` and ``cost`` in which the two
differ, and the collectives' dict where it differs (none where the fit
is exact).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch import cost
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, shape_variant
from repro_torch.launch.steps import make_optimizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--seq", type=int, default=None, help="cut the sequence to this")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    shape = SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    cfg = shape_variant(get_config(args.arch), shape)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    optimizer = make_optimizer(cfg) if shape.kind == "train" else None
    t0 = time.perf_counter()
    fit = DR.count_step(cfg, shape, mesh, optimizer, extrapolate=True)
    fit_s = time.perf_counter() - t0
    fn, inputs = DR.step_inputs(cfg, shape, mesh, optimizer)
    t0 = time.perf_counter()
    with torch.set_grad_enabled(shape.kind == "train"):
        whole = cost.account(fn, *inputs, pod_size=DR._pod_size(mesh))
    whole_s = time.perf_counter() - t0
    differ = {k: [fit[k], whole[k]] for k in DR.COUNT_KEYS + ("peak_bytes",)
              if fit[k] != whole[k]}
    kept = {k: v for k, v in whole["collectives"].items()
            if v or k in ("total", "count", "cross_pod")}
    if fit["collectives"] != kept:
        differ["collectives"] = [fit["collectives"], kept]
    phases = set(fit["peak_by_phase"]) | set(whole["peak_by_phase"])
    differ.update({f"peak_{p}": [fit["peak_by_phase"].get(p), whole["peak_by_phase"].get(p)]
                   for p in sorted(phases)
                   if fit["peak_by_phase"].get(p) != whole["peak_by_phase"].get(p)})
    print(json.dumps({"arch": args.arch, "shape": args.shape, "seq_len": shape.seq_len,
                      "mesh": dict(mesh.shape), "fit_s": fit_s, "whole_s": whole_s,
                      "peak_bytes": whole["peak_bytes"], "differ": differ}))


if __name__ == "__main__":
    main()
