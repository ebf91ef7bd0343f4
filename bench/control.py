"""Readings that set the upper end of each limit: the reference put in the
program's place, computed in TF32 (the control) or with a fault planted,
against the reference in float32, at a cell's own size.

    python3 bench/control.py --workload <name> --seeds 1 2 3 [--device cuda]
        [--faults state_unchanged half_batch ...]

One JSON line a seed (the faults named, or every fault of the cell's loop): ``{"seed", "control": {number: gap}, "faults":
{fault: {number: gap}}}``. The benchmark's own runs never run this; the
lower end of each limit comes from their ``checks``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def readings(root: Path, workload: str, seed: int, device: str,
             faults=None) -> dict:
    import torch

    from bench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = harness.cell(root, workload)
    ctx.seed, ctx.device = int(seed), torch.device(device)
    ctx.t_start = time.perf_counter()
    ctx.loop.setup(ctx)
    out = {"seed": seed,
           "control": ctx.loop.reference_readings(ctx, "tf32"),
           "faults": {f: ctx.loop.reference_readings(ctx, "fp32", (f,))
                      for f in (faults or ctx.loop.FAULTS)}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", nargs="*")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, args.device,
                                  args.faults)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
