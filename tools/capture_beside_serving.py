#!/usr/bin/env python3
"""Serving beside a while-driver retrain on one GPU, four ways.

    python3 tools/capture_beside_serving.py            # every mode, one process each
    python3 tools/capture_beside_serving.py --mode thread_local+stream

The while driver (``run_fl(driver="while")``) captures its rounds as CUDA
graphs. A server that answers requests from another thread meanwhile shares
the card with that capture. This script runs one such retrain under a
serving thread in each of four combinations:

  * capture ``global``: as the port did before it had a flywheel, through
    ``torch.cuda.graph`` in PyTorch's default global error mode, after a
    device-wide synchronize (the context manager also synchronizes the card
    and empties the allocator's cache); ``thread_local``: as it does now
    (``engine._capture_graph``);
  * serving ``pageable``: the engine's step as it was before, pageable
    copies on the calling thread's current stream and a synchronizing copy
    back; ``stream``: the engine's step now (the server's own stream,
    pinned staging buffers, an event wait).

Each mode runs in its own process (a failed capture can leave the process's
CUDA state unusable): a full-width LoGTST server of two clusters (random
weights from a seed, flash attention on) warmed at one channel; the same
retrain run alone first; then a thread that keeps submitting requests while
the retrain runs again. It prints one JSON line per mode: whether the
retrain raised, the requests served and failed (with the first error), the
serving latency during the retrain, and whether the retrained model is
bitwise the one trained alone. It needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("global+pageable", "global+stream", "thread_local+pageable",
         "thread_local+stream")
SEED = 0


def pageable_run_padded(self, x, rows):
    """The engine's step before the server had its own stream: pageable
    copies on the thread's current stream, the output buffer allocated at
    the first step of each shape, a synchronizing copy back."""
    from repro_torch.core.forecast import forward_multivariate

    bucket, M, _ = x.shape
    key = (bucket, M)
    outs = self.__dict__.setdefault("_pageable_out", {})
    with torch.inference_mode():
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        out = outs.pop(key, None)
        if out is None:
            out = torch.empty((bucket, M, self.forecaster.cfg.horizon),
                              dtype=torch.float32, device=self.device)
        out.copy_(forward_multivariate(self.forecaster.cfg, self.params, xt))
        result = out[:rows].to("cpu", copy=True).numpy()
    outs[key] = out
    return result


@contextlib.contextmanager
def global_capture(graph, pool, stream):
    """The earlier capture design: a device-wide synchronize, then
    ``torch.cuda.graph`` in global error mode on its own stream."""
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, pool=pool):
        yield


def run_mode(mode: str) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.core.forecaster import get_forecaster, save_forecaster
    from repro_torch.core.tasks import get_task, write_routing_manifest
    from repro_torch.launch import serve_forecast as S

    capture, serving = mode.split("+")
    torch.backends.cuda.matmul.allow_tf32 = False
    task = get_task("ev", quick=False)
    fc = get_forecaster("logtst", look_back=task.look_back,
                        horizon=task.horizon, use_flash_attn=True)
    root = os.path.join(ROOT, "build", "capture_beside_serving", mode)
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator().manual_seed(SEED)
    for c in (0, 1):
        save_forecaster(os.path.join(root, f"psgf_c{c}"), fc,
                        fc.init_params(gen, device="cuda"))
    series = task.series()
    write_routing_manifest(root, task, fc, np.arange(task.num_clients) % 2,
                           [{"policy": "psgf", "cluster": c} for c in (0, 1)])
    if serving == "pageable":
        S._ClusterEngine.run_padded = pageable_run_padded
    if capture == "global":
        E._capture_graph = global_capture
    server = S.ForecastServer.from_manifest(root, device="cuda", max_batch=32,
                                            max_wait_ms=0.5)
    server.warmup(channels=1)

    tr, _, te, _ = task.client_data(series, np.arange(27))
    fl = E.FLConfig(policy="psgf", num_clients=27, select_ratio=0.5,
                    local_steps=4, batch_size=32, share_ratio=0.3,
                    forward_ratio=0.2, use_pallas_mix=True)
    kw = dict(max_rounds=4, eval_every=2, patience=10, driver="while",
              device="cuda")
    alone = E.run_fl(fc.cfg, fl, tr, te, R.PRNGKey(SEED), **kw)
    torch.cuda.synchronize()

    server.start()
    stop, records, errors = threading.Event(), [], []
    x = np.random.default_rng(SEED).standard_normal(
        (1, task.look_back)).astype(np.float32)

    def traffic():
        while not stop.is_set():
            t0 = time.perf_counter()
            futs = [server.submit(x, cluster=i % 2) for i in range(8)]
            for f in futs:
                try:
                    f.result(timeout=60)
                    records.append(time.perf_counter() - t0)
                except Exception as exc:       # the mode's finding
                    errors.append(repr(exc))

    thread = threading.Thread(target=traffic, daemon=True)
    thread.start()
    time.sleep(0.5)
    served_before = len(records)
    out = {"mode": mode, "retrain_error": None}
    t0 = time.perf_counter()
    try:
        loaded = E.run_fl(fc.cfg, fl, tr, te, R.PRNGKey(SEED), **kw)
        out["bitwise_vs_alone"] = torch.equal(
            loaded["state"]["w_global"], alone["state"]["w_global"])
        out["while_run"] = loaded["while_run"]
    except Exception as exc:                   # the mode's finding
        out["retrain_error"] = repr(exc)[:400]
    out["retrain_s"] = time.perf_counter() - t0
    served = records[served_before:]
    time.sleep(0.5)
    stop.set()
    thread.join(timeout=120)
    server.close()
    out.update({
        "served_during_retrain": len(served),
        "failed": len(errors), "first_error": errors[0][:400] if errors else None,
        "latency_s_p50": float(np.quantile(served, 0.5)) if served else None,
        "latency_s_p99": float(np.quantile(served, 0.99)) if served else None,
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capture_beside_serving: no CUDA GPU available", file=sys.stderr)
        return 2
    if args.mode is not None:
        print(json.dumps(run_mode(args.mode)), flush=True)
        return 0
    results = []
    for mode in MODES:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--mode", mode], capture_output=True, text=True,
                              timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = (json.loads(lines[-1]) if lines else
               {"mode": mode, "process_rc": proc.returncode,
                "stderr_tail": proc.stderr[-600:]})
        results.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps({"capture_beside_serving": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
