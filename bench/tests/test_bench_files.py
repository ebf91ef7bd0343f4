"""Every configuration, traffic mix, limit file and metric reader is found
and parsed by name, and ``BENCHMARK.json`` keeps the contract's shape."""
import importlib
import json
import re

import pytest

from bench.tests.tiny import ROOT, workloads

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("bench/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    from bench.reference.model import num_params
    assert num_params(data["model"]) == data["num_params"]


@pytest.mark.parametrize("name", workloads())
def test_cell_files(name):
    w = next(x for x in SPEC["workloads"] if x["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    loop = importlib.import_module(f"bench.loops.{traffic['loop']}")
    for fn in ("setup", "window", "profile", "check", "reference_readings"):
        assert callable(getattr(loop, fn))
    limits = json.loads((ROOT / "bench" / "limits" / f"{name}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] == "train_windows_per_s"
        assert set(metric["workloads"]) <= set(workloads())
        mod = importlib.import_module(f"bench.metrics.{metric['name']}")
        assert callable(mod.read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for name in workloads():
        layer = [m for m in SPEC["per_layer"] if name in m["workloads"]]
        assert layer
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s", "train_windows_per_s"}
