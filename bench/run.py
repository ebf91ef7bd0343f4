"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m bench.run`` works too), from the root of a checkout. It
measures the PyTorch/CUDA port in ``src/repro_torch`` on the card and
fails, printing no result, without a CUDA device, with fewer devices than
the cell asks for, or when JAX or the JAX package got loaded. The last line
of standard output is the result's JSON; the last lines of standard error
are the numbers the check compared, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

# the program builds its kernels with nvcc into build/repro_torch_kernels/
# of the checkout; the driver's JIT cache goes beside it, at a fixed path
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "bench_cache" / "nv_compute")
os.environ["USE_FLAX"] = "0"
# A federated job caches its eager warm-up round's blocks, which no graph
# capture may free; growable segments keep that cache unfragmented, so the
# capture (and, in a traced run, the profiler's own buffers) still fits.
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
