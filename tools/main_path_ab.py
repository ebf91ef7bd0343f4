#!/usr/bin/env python3
"""The plain main path's step times, for one tree or two trees side by side.

    python3 tools/main_path_ab.py                       # this checkout
    python3 tools/main_path_ab.py --baseline DIR        # DIR's src/ against this one

It times, on one GPU, what a user of the one-card port calls: the zoo's
``launch.train.train`` of qwen2-1.5b at full width (4 x 2,048, remat,
random fp32 weights from ``PRNGKey(0)``: ``chip_smoke.py`` phase 9's
``train`` cell) and ``launch.serve.serve`` of internvl2-2b at full width
(4 x (256 patches + 1,792 tokens), 32 tokens decoded: phase 11's cell,
whose decode is host-bound). Each tree runs in its own process, which
builds that tree's kernels first. With ``--baseline`` the two trees run in
the order baseline, this, this, baseline, so that a drift of the card's
clocks over the call falls on both alike. It prints one JSON line per run
and a last line with every run's warm ms per train step and decode ms per
token, and the card's name and power limit. It needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = dict(arch="qwen2-1.5b", steps=6, batch=4, seq=2048)
WARM_FROM = 2            # the first steps build kernels and warm the allocator
SERVE = dict(arch="internvl2-2b", batch=4, prompt_len=1792, gen=32)


def run_tree(src: str) -> dict:
    """One tree's times, in this process (``--child``)."""
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TR

    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise RuntimeError(f"repro_torch from {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    history = {}
    losses = TR.train(TRAIN["arch"], steps=TRAIN["steps"], batch=TRAIN["batch"],
                      seq=TRAIN["seq"], reduced=False, log_every=100,
                      device="cuda", history=history)
    step_ms = [s * 1e3 for s in history["step_s"]]
    torch.cuda.empty_cache()
    served = SV.serve(SERVE["arch"], batch=SERVE["batch"],
                      prompt_len=SERVE["prompt_len"], gen=SERVE["gen"],
                      reduced=False, device="cuda")
    return {"src": src, "train_losses": [float(x) for x in losses],
            "train_ms_per_step": step_ms,
            "train_warm_ms": statistics.median(step_ms[WARM_FROM:]),
            "prefill_ms": served["prefill_ms"],
            "decode_ms_per_token": served["decode_ms_per_token"]}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="a tree to time before and after this one")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_tree(os.path.abspath(args.child))))
        return 0
    this = os.path.join(ROOT, "src")
    order = [this] if not args.baseline else [
        os.path.join(os.path.abspath(args.baseline), "src"), this, this,
        os.path.join(os.path.abspath(args.baseline), "src")]
    runs = []
    for src in order:
        env = dict(os.environ, PYTHONPATH=src)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", src], env=env, capture_output=True,
                              text=True, cwd=os.path.dirname(src))
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print(json.dumps({"card": card(), "order": [
        "baseline" if r["src"] != this else "this" for r in runs],
        "train_warm_ms": [r["train_warm_ms"] for r in runs],
        "decode_ms_per_token": [r["decode_ms_per_token"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
