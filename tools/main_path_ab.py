#!/usr/bin/env python3
"""The plain main path's step times, for one tree or two trees side by side.

    python3 tools/main_path_ab.py                       # this checkout
    python3 tools/main_path_ab.py --baseline DIR        # DIR's src/ against this one
    python3 tools/main_path_ab.py --kernels --baseline DIR   # and flash's calls

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

With ``--kernels`` each child first times its own tree's ``flash_attention``
at the ten tensor-core calls the main paths make and at the two float32
prefill calls of the general route (``KERNEL_CALLS``: ten shapes,
seamless's encoder and decoder apart), beside the
``scaled_dot_product_attention`` calls that compute the same function
(``chip_smoke.sdpa_calls``: with the mask as a tensor and, where no window
cuts the keys, with ``is_causal`` and no mask), on the same inputs from a
fixed seed, and holds each output against its tree's plain version
(``chip_smoke.flash_case``); then it times the float32 prefills that make
the general route's calls (``FP32_PREFILLS``: ``ModelApi.prefill`` at 4 x
2,048, full width, ``dtype="float32"``). Each call's bound comes from this
checkout's ``kernels/flash_attention/bound.py`` (the same for both trees).
Each run's line also holds its tree's ``-Xptxas -v`` registers and spills
of the two flash kernels it compares (``ptxas``).
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
# the flash calls of the main paths: name, (B, S, H, KV, hd), causal,
# window, dtype (bfloat16: the tensor-core route; float32: the general one)
KERNEL_CALLS = (
    ("qwen2-1.5b train", (4, 2048, 12, 2, 128), True, None, "bfloat16"),
    ("internvl2-2b prefill", (4, 2048, 16, 8, 128), True, None, "bfloat16"),
    ("qwen2-1.5b train_psgf", (8, 64, 12, 2, 128), True, None, "bfloat16"),
    ("seamless-m4t train encoder", (4, 512, 16, 16, 64), False, None, "bfloat16"),
    ("seamless-m4t train decoder", (4, 512, 16, 16, 64), True, None, "bfloat16"),
    ("seamless-m4t prefill encoder", (4, 2048, 16, 16, 64), False, None, "bfloat16"),
    ("seamless-m4t prefill decoder", (4, 2048, 16, 16, 64), True, None, "bfloat16"),
    ("hymba-1.5b prefill", (4, 2048, 25, 5, 64), True, 1024, "bfloat16"),
    ("phi3.5-moe prefill", (4, 2048, 32, 8, 128), True, None, "bfloat16"),
    ("phi3.5-moe train_psgf", (4, 512, 32, 8, 128), True, None, "bfloat16"),
    ("hymba-1.5b float32 prefill", (4, 2048, 25, 5, 64), True, 1024, "float32"),
    ("qwen2-1.5b float32 prefill", (4, 2048, 12, 2, 128), True, None, "float32"),
)
FP32_PREFILLS = ("hymba-1.5b", "qwen2-1.5b")
FP32_PREFILL = dict(batch=4, prompt_len=2048)


def time_kernels() -> dict:
    """The tree's ``flash_attention`` at ``KERNEL_CALLS``, held against its
    plain version and timed beside SDPA (``chip_smoke.flash_times``)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import ops, ref

    out = {}
    for name, (B, S, H, KV, hd), causal, window, dtype in KERNEL_CALLS:
        gen = torch.Generator().manual_seed(0)
        dt = getattr(torch, dtype)
        q, k, v = CS.attention_inputs(gen, B, S, S, H, KV, hd, dt)
        _, err, ratio = CS.flash_case(ops, ref, name, q, k, v, causal, window,
                                      None, CS.FLASH_HYMBA_TOL[dt])
        out[name] = {"shape": [B, S, H, KV, hd], "causal": causal,
                     "window": window, "dtype": dtype,
                     "route": CS.route_of(ops, q, k), "max_abs_err": err,
                     "bound_ratio": ratio,
                     **CS.flash_times(ops, ref, q, k, v, window, causal,
                                      bound=False)}
        del q, k, v
    return out


def time_fp32_prefills() -> dict:
    """Warm ms (median of 3) of the tree's ``ModelApi.prefill`` of each of
    ``FP32_PREFILLS`` in float32 at full width, random weights from
    ``PRNGKey(0)``."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi

    B, S = FP32_PREFILL["batch"], FP32_PREFILL["prompt_len"]
    out = {}
    for arch in FP32_PREFILLS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        api = ModelApi(cfg, "cuda")
        params = api.init_params(R.PRNGKey(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S))).cuda()
        with torch.inference_mode():
            fn = lambda: api.prefill(params, {"tokens": tokens}, cache_len=S)  # noqa: E731
            fn()
            runs = [CS.host_ms(fn) for _ in range(3)]
        out[arch] = {"prefill_ms": statistics.median(runs), "prefill_ms_runs": runs}
        del params, api
        gc.collect()
        torch.cuda.empty_cache()
    return out


def add_bounds(flash: dict) -> dict:
    """Each call's bound from this checkout's ``bound.attention_bound``."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention.bound import attention_bound

    for name, (B, S, H, KV, hd), causal, window, dtype in KERNEL_CALLS:
        b = attention_bound((B, S, H, hd), (B, S, KV, hd), getattr(torch, dtype),
                            causal=causal, window=window)
        flash[name].update(bound_ms=b["ms"], bound_by=b["bound_by"],
                           bound_operations_by=b["operations_by"])
    return flash


def run_tree(src: str, kernels: bool) -> dict:
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
    # registers and spills of each flash kernel entry (``-Xptxas -v``)
    ptxas = {lib: _build.parse_ptxas(_build.build_log(lib))
             for lib in ("flash_attention", "flash_attention_tc")}
    flash = time_kernels() if kernels else None
    torch.cuda.empty_cache()
    fp32_prefills = time_fp32_prefills() if kernels else None
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
            "decode_ms_per_token": served["decode_ms_per_token"],
            "ptxas": ptxas,
            **({"flash": flash, "fp32_prefills": fp32_prefills}
               if kernels else {})}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="a tree to time before and after this one")
    ap.add_argument("--kernels", action="store_true",
                    help="also time each tree's flash calls (KERNEL_CALLS)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_tree(os.path.abspath(args.child), args.kernels)))
        return 0
    this = os.path.join(ROOT, "src")
    order = [this] if not args.baseline else [
        os.path.join(os.path.abspath(args.baseline), "src"), this, this,
        os.path.join(os.path.abspath(args.baseline), "src")]
    runs = []
    for src in order:
        env = dict(os.environ, PYTHONPATH=src)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", src]
                              + (["--kernels"] if args.kernels else []),
                              env=env, capture_output=True, text=True,
                              cwd=os.path.dirname(src))
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        if args.kernels:
            add_bounds(runs[-1]["flash"])
        print(json.dumps(runs[-1]))
    summary = {"card": card(), "order": [
        "baseline" if r["src"] != this else "this" for r in runs],
        "train_warm_ms": [r["train_warm_ms"] for r in runs],
        "prefill_ms": [r["prefill_ms"] for r in runs],
        "decode_ms_per_token": [r["decode_ms_per_token"] for r in runs]}
    if args.kernels:
        summary["flash_ms"] = {name: [r["flash"][name]["ms"] for r in runs]
                               for name, *_ in KERNEL_CALLS}
        summary["flash_library_ms"] = {
            name: [r["flash"][name]["library_ms"] for r in runs]
            for name, *_ in KERNEL_CALLS}
        summary["flash_bound_ms"] = {name: runs[0]["flash"][name]["bound_ms"]
                                     for name, *_ in KERNEL_CALLS}
        summary["fp32_prefill_ms"] = {
            arch: [r["fp32_prefills"][arch]["prefill_ms"] for r in runs]
            for arch in FP32_PREFILLS}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
