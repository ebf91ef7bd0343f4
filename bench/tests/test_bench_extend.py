"""A later change adds a cell, a traffic mix and a metric as new files and a
new ``BENCHMARK.json`` entry, edits no file that is there, and the new cell
runs."""
import hashlib
import json
import subprocess
import sys

from bench.tests.tiny import ROOT, tiny_root


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_traffic_and_metric_are_files_only(tmp_path):
    root = tiny_root(tmp_path, code=True)
    before = _digests(root)
    (root / "bench" / "traffic" / "fleet24-small.json").write_text(json.dumps({
        "loop": "fl_jobs", "stations": 5, "days": 110,
        "cohort": 3, "streaming_windows": True, "rounds": 2, "eval_every": 2}))
    (root / "bench" / "limits" / "fl-fleet24-small.json").write_text(json.dumps(
        json.loads((root / "bench" / "limits" / "fl-fleet2048.json").read_text())))
    (root / "bench" / "metrics" / "jobs_done.py").write_text(
        '"""Jobs the window ran."""\n\n\ndef read(ctx):\n'
        '    return float(ctx.window["attempted"])\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "fl-fleet24-small", "config": "logtst-psgf",
                              "traffic": "fleet24-small", "chips": 1,
                              "why": "a tiny fleet"})
    spec["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                              "source": "program_counter", "layer": "Device",
                              "moves": "train_windows_per_s",
                              "workloads": ["fl-fleet24-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    code = ("import json, pathlib\nfrom bench import harness\n"
            "r = harness.run_cell(pathlib.Path('.'), 'fl-fleet24-small', 5, 0.05, "
            "True, 'cpu')\nprint(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                              "PYTHONPATH": f"{root}:{ROOT / 'src'}"})
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["jobs_done"]["value"] >= 1
