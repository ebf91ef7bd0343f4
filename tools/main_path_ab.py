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
at the ten tensor-core calls the main paths make (``KERNEL_CALLS``: eight
shapes, seamless's encoder and decoder apart), beside the
``scaled_dot_product_attention`` calls that compute the same function
(``chip_smoke.sdpa_calls``: with the mask as a tensor and, where no window
cuts the keys, with ``is_causal`` and no mask), on the same inputs from a
fixed seed, and holds each output against its tree's plain version
(``chip_smoke.flash_case``).
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
# the tensor-core flash calls of the main paths: name, (B, S, H, KV, hd),
# causal, window
KERNEL_CALLS = (
    ("qwen2-1.5b train", (4, 2048, 12, 2, 128), True, None),
    ("internvl2-2b prefill", (4, 2048, 16, 8, 128), True, None),
    ("qwen2-1.5b train_psgf", (8, 64, 12, 2, 128), True, None),
    ("seamless-m4t train encoder", (4, 512, 16, 16, 64), False, None),
    ("seamless-m4t train decoder", (4, 512, 16, 16, 64), True, None),
    ("seamless-m4t prefill encoder", (4, 2048, 16, 16, 64), False, None),
    ("seamless-m4t prefill decoder", (4, 2048, 16, 16, 64), True, None),
    ("hymba-1.5b prefill", (4, 2048, 25, 5, 64), True, 1024),
    ("phi3.5-moe prefill", (4, 2048, 32, 8, 128), True, None),
    ("phi3.5-moe train_psgf", (4, 512, 32, 8, 128), True, None),
)


def time_kernels() -> dict:
    """The tree's ``flash_attention`` at ``KERNEL_CALLS``, held against its
    plain version and timed beside SDPA (``chip_smoke.tensor_core_times``)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import ops, ref

    out = {}
    for name, (B, S, H, KV, hd), causal, window in KERNEL_CALLS:
        gen = torch.Generator().manual_seed(0)
        q, k, v = CS.attention_inputs(gen, B, S, S, H, KV, hd, torch.bfloat16)
        _, err, ratio = CS.flash_case(ops, ref, name, q, k, v, causal, window,
                                      None, CS.BF16_TOL)
        out[name] = {"shape": [B, S, H, KV, hd], "causal": causal,
                     "window": window, "max_abs_err": err, "bound_ratio": ratio,
                     **CS.tensor_core_times(ops, ref, q, k, v, window, causal)}
        del q, k, v
    return out


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
    flash = time_kernels() if kernels else None
    torch.cuda.empty_cache()
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
            **({"flash": flash} if kernels else {})}


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
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
