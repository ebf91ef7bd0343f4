"""One run of one cell: find its files by name, set up, measure the window,
read the trace, check the output against the reference, and build the
result line.

Everything a cell needs is found from ``BENCHMARK.json`` by name: the
workload's configuration file, ``bench/traffic/<traffic>.json`` (which
names the loop in ``bench/loops/`` that runs it, and its parameters),
``bench/limits/<workload>.json`` (the limit of each number the check
compares) and, for each per-layer metric, ``bench/metrics/<metric>.py``
(a ``read(ctx)`` that returns the value, or None where it finds nothing to
read). A new cell, traffic mix or metric is new files and entries; no file
here changes.
"""
from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def banned_modules(modules=None):
    """Top-level names in ``sys.modules`` that the benchmark must not load
    (the JAX package and JAX), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = {name.split(".")[0] for name in (modules or sys.modules)}
    return sorted(names & set(BANNED_MODULES))


class Context(SimpleNamespace):
    """What a loop and the metric readers share for one run."""

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def window_started(self, t0: float):
        self.setup_s = t0 - self.t_start


def cell(root: Path, workload: str) -> Context:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    traffic = load_json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    return Context(
        spec=spec, workload=entry, config=load_json(root / cfg_entry["file"]),
        traffic=traffic,
        limits=load_json(root / "bench" / "limits" / f"{workload}.json"),
        loop=importlib.import_module(f"bench.loops.{traffic['loop']}"), st={})


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metric(name: str, ctx):
    mod = importlib.import_module(f"bench.metrics.{name}")
    value = mod.read(ctx)
    return None if value is None or not math.isfinite(value) else float(value)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run; returns the result (without the chip checks that
    ``bench/run.py`` makes before it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = cell(root, workload)
    ctx.seed, ctx.device = int(seed), torch.device(device)
    ctx.t_start = time.perf_counter() if t_start is None else t_start
    cuda = ctx.device.type == "cuda"

    ctx.loop.setup(ctx)
    ctx.sync()
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.window = ctx.loop.window(ctx, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    ctx.trace, ctx.calls = None, {}
    if trace:
        ctx.trace, ctx.calls = ctx.loop.profile(ctx)
    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": max(setup_peak, peak) if cuda else 0,
              "power_limit_w": power_limit_w() if cuda else None}
    end_to_end = {"setup_s": ctx.setup_s,
                  "train_windows_per_s": ctx.window["windows"] / ctx.window["seconds"],
                  "peak_mem_gib": peak / 2 ** 30 if cuda else None}

    metrics, breakdown = {}, None
    if trace:
        for m in ctx.spec["per_layer"]:
            if _applies(m, workload):
                value = read_metric(m["name"], ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if cuda and ctx.trace is not None:
            device["busy_s"] = ctx.trace.busy_s()
            device["window_s"] = ctx.trace.window_s
            breakdown = ctx.trace.breakdown()
    else:
        for m in ctx.spec["end_to_end"]:
            if _applies(m, workload) and end_to_end.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": end_to_end[m["name"]],
                                      "unit": m["unit"]}
    ctx.trace = None
    ctx.st.pop("step", None)
    ctx.st.pop("batch", None)
    if cuda:
        torch.cuda.empty_cache()
    gaps = ctx.loop.check(ctx)
    # a number that is not finite (an output missing) fails, printed as null
    checks = {name: {"value": gaps[name] if math.isfinite(gaps[name]) else None,
                     "limit": limit} for name, limit in ctx.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": ctx.window["attempted"],
              "failed": ctx.window["failed"], "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
