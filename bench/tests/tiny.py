"""A copy of the benchmark's data files at a tiny size, for CPU runs."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"d_model": 16, "num_heads": 4, "d_ff": 32}
TINY_TRAFFIC = {
    "fleet2048": {"stations": 16, "cohort": 4, "days": 120, "rounds": 6,
                  "eval_every": 3},
    "ev58-paper": {"stations": 6, "days": 120, "rounds": 6, "eval_every": 3},
    "weather-train": {"channels": 3, "length": 800, "samples": 8,
                      "profile_steps": 2},
}


def _update(path: Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def tiny_root(dst: Path, code: bool = False) -> Path:
    """``dst`` with ``BENCHMARK.json`` and the benchmark's data files, cut
    to a tiny size; with ``code`` the whole ``bench`` package too."""
    ignore = shutil.ignore_patterns("__pycache__")
    if code:
        shutil.copytree(ROOT / "bench", dst / "bench", ignore=ignore)
    else:
        for sub in ("configs", "traffic", "limits"):
            shutil.copytree(ROOT / "bench" / sub, dst / "bench" / sub, ignore=ignore)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for cfg in spec["configs"]:
        def shrink(c, patch="patchtst" in cfg["name"]):
            c["model"].update(TINY_MODEL)
            c["model"].update({"look_back": 64, "horizon": 8} if patch
                              else {"look_back": 32})
        _update(dst / cfg["file"], shrink)
    for name, sizes in TINY_TRAFFIC.items():
        _update(dst / "bench" / "traffic" / f"{name}.json",
                lambda t, s=sizes: t.update(s))
    return dst


def workloads():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]
