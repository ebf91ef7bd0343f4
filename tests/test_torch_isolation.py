"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, neither does ``chip_smoke.py``, and its entry points demand the GPU
unless the caller asks for the CPU."""
import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.common.device import resolve_device  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG_DIR = os.path.join(ROOT, "src", "repro_torch")

_CHILD = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    rep = json.loads(out.strip().splitlines()[-1])
    assert "repro_torch.launch.serve_forecast" in rep["modules"]
    assert "repro_torch.kernels.flash_attention.ops" in rep["modules"]
    for name in ("repro_torch.random", "repro_torch.core.fl.engine",
                 "repro_torch.core.fl.masks", "repro_torch.core.fl.policies",
                 "repro_torch.core.fl.client_store",
                 "repro_torch.core.fl.flywheel",
                 "repro_torch.launch.gateway",
                 "repro_torch.core.fl.simulator",
                 "repro_torch.core.fl.strategies",
                 "repro_torch.data.clustering",
                 "repro_torch.kernels.psgf_mix.ops",
                 "repro_torch.kernels.ssm_scan.ops",
                 "repro_torch.kernels.ssm_scan.ref",
                 "repro_torch.models.config", "repro_torch.models.layers",
                 "repro_torch.models.decoder", "repro_torch.configs",
                 "repro_torch.configs.hymba_1_5b", "repro_torch.launch.api",
                 "repro_torch.launch.serve", "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.optim", "repro_torch.optim.adam",
                 "repro_torch.optim.schedules", "repro_torch.core.psgf_dp",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.configs.phi3_5_moe_42b",
                 "repro_torch.configs.deepseek_v2_236b",
                 "repro_torch.configs.internvl2_2b",
                 "repro_torch.configs.mistral_large_123b",
                 "repro_torch.configs.command_r_plus_104b",
                 "repro_torch.configs.qwen2_72b",
                 "repro_torch.configs.xlstm_125m",
                 "repro_torch.configs.seamless_m4t_large_v2",
                 "repro_torch.models.encdec", "repro_torch.common.hw",
                 "repro_torch.launch.shapes", "repro_torch.sharding",
                 "repro_torch.sharding.rules", "repro_torch.launch.cost",
                 "repro_torch.launch.dryrun", "repro_torch.kernels._sharded",
                 "repro_torch.launch.mesh"):
        assert name in rep["modules"]
    assert rep["bad"] == []


def test_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = [m for m in _imports(path) if _forbidden(m)]
        assert bad == [], (path, bad)


def test_package_walk_finds_every_source_file():
    found = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for dirpath, _, names in os.walk(PKG_DIR):
        rel = os.path.relpath(dirpath, os.path.dirname(PKG_DIR))
        for n in names:
            if n.endswith(".py") and n != "__init__.py":
                assert ".".join(rel.split(os.sep) + [n[:-3]]) in found


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            resolve_device("cuda:0")


def test_entry_points_demand_the_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.core import forecast
    from repro_torch.core.forecaster import (get_forecaster, load_forecaster,
                                             params_from_numpy, save_forecaster)
    from repro_torch.core.tasks import get_task, write_routing_manifest
    from repro_torch.launch.serve_forecast import ForecastServer, main

    fc = get_forecaster("logtst", look_back=16, horizon=2, d_model=8,
                        num_heads=2, d_ff=8, patch_len=8, stride=4)
    gen = torch.Generator().manual_seed(0)
    params = fc.init_params(gen, device="cpu")
    ckpt = str(tmp_path / "psgf_c0")
    save_forecaster(ckpt, fc, params)
    write_routing_manifest(str(tmp_path), get_task("ev"), fc, np.zeros(3),
                           [{"policy": "psgf", "cluster": 0}])
    calls = [
        lambda: fc.init_params(gen),
        lambda: forecast.init_params(fc.cfg, gen),
        lambda: load_forecaster(ckpt),
        lambda: params_from_numpy({"w": np.ones(2, np.float32)}),
        lambda: ForecastServer(fc, params),
        lambda: ForecastServer.from_checkpoint(ckpt),
        lambda: ForecastServer.from_manifest(str(tmp_path)),
        lambda: main(["--manifest", str(tmp_path), "--requests", "1"]),
    ]
    from repro_torch import random as R
    from repro_torch.core import tasks as T
    from repro_torch.core.fl import engine as E
    from repro_torch.data.clustering import cluster_clients

    from repro_torch.core.fl.client_store import ClientStore

    fl = E.FLConfig(num_clients=2, batch_size=2, local_steps=1)
    sfl = E.FLConfig(num_clients=4, batch_size=2, local_steps=1,
                     streaming_windows=True)
    state, meta = E.init_fl_state(fc.cfg, fl, R.PRNGKey(0), device="cpu")
    windows = np.zeros((2, 4, 18), np.float32)
    series = np.random.default_rng(0).standard_normal((4, 70))
    spec = T.ExperimentSpec(task=T.get_task("ev", num_clients=4, num_days=60,
                                            look_back=16), model=fc,
                            max_rounds=1)
    calls += [
        lambda: E.init_fl_state(fc.cfg, fl, R.PRNGKey(0)),
        lambda: E.fl_round(state, windows, R.PRNGKey(1), fc.cfg, fl, meta),
        lambda: E.run_fl(fc.cfg, fl, windows, windows, R.PRNGKey(0)),
        lambda: E.run_fl(fc.cfg, fl, windows, windows, R.PRNGKey(0),
                         driver="while"),
        lambda: E.run_fl(fc.cfg, sfl, series, series, R.PRNGKey(0),
                         driver="host"),
        lambda: ClientStore(fc.cfg, sfl, series, series, R.PRNGKey(0)),
        lambda: cluster_clients(series, 2),
        lambda: T.run_experiment(spec),
        lambda: T.main(["--rounds", "1"]),
    ]
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as llm_serve
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder

    hymba = get_config("hymba-1.5b").reduced()
    calls += [
        lambda: llm_serve.serve("hymba-1.5b"),
        lambda: llm_serve.serve("internvl2-2b"),
        lambda: llm_serve.serve("phi3.5-moe-42b-a6.6b"),
        lambda: llm_serve.serve("deepseek-v2-236b"),
        lambda: decoder.init_cache(get_config("deepseek-v2-236b").reduced(), 1, 4),
        lambda: llm_serve.main(["--arch", "hymba-1.5b"]),
        lambda: ModelApi(hymba),
        lambda: decoder.init_params(hymba, R.PRNGKey(0)),
        lambda: decoder.init_cache(hymba, 1, 4),
        lambda: decoder.params_from_numpy({"w": np.ones(2, np.float32)}),
    ]
    from repro_torch.models import encdec

    xlstm = get_config("xlstm-125m").reduced()
    seamless = get_config("seamless-m4t-large-v2").reduced()
    calls += [
        lambda: llm_serve.serve("xlstm-125m"),
        lambda: llm_serve.serve("seamless-m4t-large-v2"),
        lambda: ModelApi(seamless),
        lambda: decoder.init_cache(xlstm, 1, 4),
        lambda: encdec.init_params(seamless, R.PRNGKey(0)),
        lambda: encdec.init_cache(seamless, 1, 4, src_len=2),
    ]
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as llm_train

    qwen2 = get_config("qwen2-1.5b").reduced()
    calls += [
        lambda: llm_train.train("qwen2-1.5b", steps=1),
        lambda: llm_train.train_psgf("qwen2-1.5b", steps=1),
        lambda: llm_train.main(["--arch", "qwen2-1.5b", "--steps", "1"]),
        lambda: llm_train.main(["--arch", "qwen2-1.5b", "--steps", "1",
                                "--sync", "psgf"]),
        lambda: llm_train.make_batch(qwen2, 0, 1, 4),
        lambda: llm_train.make_batch(get_config("internvl2-2b").reduced(), 0, 1, 4),
        lambda: llm_train.make_batch(seamless, 0, 1, 4),
        lambda: llm_train.train("xlstm-125m", steps=1),
        lambda: llm_train.train_psgf("seamless-m4t-large-v2", steps=1),
        lambda: train_steps.build_train_step(qwen2),
        lambda: decoder.init_params(qwen2, R.PRNGKey(0)),
    ]
    from repro_torch.core.fl.flywheel import RetrainController
    from repro_torch.launch import gateway

    root = str(tmp_path / "fly")
    write_routing_manifest(root, spec.task, fc, np.zeros(4),
                           [{"policy": "psgf-s30-f20", "cluster": 0}],
                           series=series)
    ctl = RetrainController(spec, root, series=series, labels=np.zeros(4),
                            device="cpu")
    ctl.device = "cuda"      # a controller made for the card, on this machine
    calls += [
        lambda: RetrainController(spec, root, series=series,
                                  labels=np.zeros(4)),
        lambda: RetrainController(spec, root),
        lambda: ctl.retrain([0]),
        lambda: gateway.main(["--manifest", str(tmp_path)]),
        lambda: gateway.main(["--manifest", str(tmp_path), "--port", "0"]),
    ]
    from repro_torch.launch import distributed as dist_launch
    from repro_torch.launch import mesh

    calls += [
        lambda: dist_launch.initialize_distributed("127.0.0.1:1", 2, 0),
        lambda: dist_launch.main(["--smoke"]),
        lambda: mesh.make_client_mesh(),
        lambda: mesh.make_batch_mesh(),
        lambda: mesh.make_host_mesh(),
        lambda: train_steps.build_prefill_step(qwen2),
        lambda: train_steps.build_serve_step(qwen2),
        lambda: train_steps.build_train_step(qwen2, mesh=None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    # with device="cpu" the same entry point runs
    assert ForecastServer(fc, params, device="cpu").predict(
        np.zeros((1, 1, 16), np.float32)).shape == (1, 1, 2)


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    """No card: exit != 0 and no result line, both from the checkout and
    from a directory that holds the script alone."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script],
                              cwd=os.path.dirname(script), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_dry_run_needs_no_gpu(tmp_path):
    """The dry run is the one entry point on ``meta``: it runs here, and its
    record holds the per-device memory and cost (argument bytes, peak,
    FLOPs, bytes accessed) and the H100 roofline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               DRYRUN_OUT=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                    "qwen2-1.5b", "--shape", "decode_32k"], env=env, check=True,
                   capture_output=True, text=True, timeout=120)
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["cost"]["flops"] > 0
    assert rec["cost"]["bytes_accessed"] > 0
    assert rec["memory"]["argument_bytes"]["total"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"]
    assert rec["roofline"]["bound_by"] in ("bytes", "operations")
    # counted on a fake group of the production mesh's 256 ranks, by this
    # torch's DTensor (its choice of collectives depends on the version)
    assert rec["collectives"]["total"] > 0 and rec["collectives"]["count"] > 0
    import torch

    assert rec["collectives"]["torch"] == torch.__version__
