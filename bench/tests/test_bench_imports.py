"""Nothing the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the program), and
the reference loads nothing of the program."""
import json
import subprocess
import sys

import pytest

from bench import harness
from bench.tests.tiny import ROOT, tiny_root


def _modules_after(code: str, cwd) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_banned_names_compare_whole():
    assert harness.banned_modules(["repro_torch.core", "bench.run", "torch"]) == []
    assert harness.banned_modules(["repro.core.fl", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "repro"]


def test_a_whole_run_loads_no_jax_and_no_reference_package(tmp_path):
    root = tiny_root(tmp_path)
    code = ("import importlib, pathlib\n"
            "from bench import run, harness\n"
            "spec = harness.load_json(pathlib.Path('BENCHMARK.json'))\n"
            "for m in spec['per_layer']: importlib.import_module('bench.metrics.' + m['name'])\n"
            "for w in spec['workloads']:\n"
            "    harness.run_cell(pathlib.Path('.'), w['name'], 3, 0.05, True, 'cpu')\n")
    names = _modules_after(code, root)
    assert "repro_torch" in names and "bench" in names
    assert not set(names) & set(harness.BANNED_MODULES)


def test_reference_loads_nothing_of_the_program(tmp_path):
    code = ("import bench.reference.model, bench.reference.fl, "
            "bench.reference.train, bench.reference.compare, bench.reference.rng")
    names = _modules_after(code, tmp_path)
    assert "repro_torch" not in names and "repro" not in names
