"""One process a device: the zoo's ``train`` and ``serve`` on the reference's
host mesh across processes (``launch.mesh.make_host_mesh`` over an
initialized group, ``--processes N``), and the FL client mesh across
processes with several devices in each (``make_client_mesh(multi_host=True)``
over every local device of each process, or ``Mesh`` with a device
repeated; ``core.fl.partition.LocalExchange`` over an ``Exchange``).

Two children of one gloo group on the CPU (a file store in ``tmp_path``)
run, once for the module, in a thread while this process computes what
they are held to:

  * ``train`` (reduced qwen2-1.5b, float32, 2 steps, batch split over
    ``"data"``): losses within 1e-6 relative of the one-process ``train`` and
    within ``test_torch_train.py``'s tolerance of ``repro.launch.train``;
    the checkpoint process 0 writes reads back in one process, in the
    one-process format;
  * ``serve``: the same tokens as the one-process ``serve`` and the
    reference's loop, and its logits within 1e-6 relative;
  * the FL client mesh of two processes x two shards of the CPU, ``scan``
    and ``while``: bitwise the one-process scan (losses, comm, RMSE,
    ``w_global``, each process's rows), and within ``FL_PARITY_TOL`` of the
    JAX package's scan driver.

The card's version (one NCCL rank) is
``test_torch_zoo_training_cuda.py::test_train_on_one_nccl_rank_is_the_plain_train``
and ``chip_smoke.py`` phase 16.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fl import engine as JE  # noqa: E402
from repro.data.synthetic import nn5_synthetic  # noqa: E402
from repro.data.windowing import client_series_datasets  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from distributed_utils import child_env  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import serve_forecast as TS  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from test_torch_llm_serve import _jax_serve_loop  # noqa: E402
from test_torch_train import TRAIN_PARITY_TOL, _close  # noqa: E402
from torch_fl_utils import JCFG, TCFG, TINY, TOL, numpy_params  # noqa: E402

ARCH = "qwen2-1.5b"
TRAIN = dict(steps=2, batch=2, seq=16, lr=3e-4)
SERVE = dict(batch=2, prompt_len=16, gen=4)
K = 12
RUN = dict(max_rounds=4, patience=99, eval_every=2)
# four shards of the client axis (two processes x two): a cohort of 8, two
# rows a shard, in client_chunk 2 (partition.validate_partition)
HYBRID_FL = dict(policy="psgf", num_clients=K, local_steps=1, batch_size=4,
                 streaming_windows=True, participation=8, client_chunk=2)


def sha(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()


def f32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


_CHILD = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch
from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.configs import get_config
from repro_torch.core import forecast as F
from repro_torch.core.fl.engine import FLConfig, run_fl
from repro_torch.core.forecaster import params_from_numpy
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as S
from repro_torch.launch import train as T

out_dir, arch, train_kw, serve_kw, run, fl, tiny = sys.argv[1], sys.argv[2], *map(json.loads, sys.argv[3:8])
f32 = lambda a: dataclasses.replace(get_config(a), dtype="float32")
T.get_config = S.get_config = f32
assert D.join_group("cpu")
idx = D.process_index()
sha = lambda t: hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()
out = {"backend": D.backend(),
       "host_mesh": [list(M.make_host_mesh(model=m, device="cpu").axis_sizes)
                     for m in (1, 2, 4)]}
out["losses"] = T.train(arch, **train_kw, device="cpu", log_every=100,
                        ckpt_dir=out_dir + "/ckpt")
served = S.serve(arch, **serve_kw, device="cpu")
out["tokens"], out["logits"] = served["tokens"].tolist(), served["logits"].tolist()

z = np.load(out_dir + "/inputs.npz")
params = params_from_numpy(pt.unflatten(
    {k[2:]: z[k] for k in z.files if k.startswith("p/")}), device="cpu")
cpu = torch.device("cpu")
assert M.make_client_mesh(multi_host=True, device="cpu").devices == (cpu,)
mesh = M.Mesh("clients", (cpu, cpu), idx, D.process_count(), D.backend())
out["mesh"] = [mesh.index, mesh.count, mesh.backend, len(mesh.devices)]
for driver in ("scan", "while"):
    h = run_fl(F.logtst_config(**tiny), FLConfig(**fl), z["train"], z["test"],
               R.PRNGKey(0), init_params=params, device="cpu", driver=driver,
               client_mesh=mesh, **run)
    s = h["state"]
    np.savez(f"{out_dir}/{driver}_{idx}.npz", **{k: v.numpy() for k, v in s.items()})
    out[driver] = {"losses": h["train_loss"], "comm": h["comm"],
                   "rmse": [[int(r), float(v)] for r, v in h["rmse"]],
                   "final_rmse": h["final_rmse"],
                   "comm_bytes": h["final_comm_bytes"],
                   "rounds": h["rounds_run"], "w": sha(s["w_global"]),
                   "owned_rows": h["owned_rows"], "exchange": h["exchange"],
                   "mesh_run": h["mesh_run"]}
D.shutdown_distributed()
print(json.dumps(out))
"""


# ``python -m repro_torch.launch.serve --processes 2`` on the CPU, run beside
# the children
CLI = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
       "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen", "1",
       "--processes", "2"]


def _spawn(tmp, into: dict):
    try:
        cli = subprocess.Popen(CLI, env=child_env({"OMP_NUM_THREADS": "2"}), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        into["procs"] = D.spawn_processes(
            2, [sys.executable, "-c", _CHILD, str(tmp), ARCH,
                *map(json.dumps, (TRAIN, SERVE, RUN, HYBRID_FL, TINY))],
            env=child_env({"OMP_NUM_THREADS": "2"}), timeout=300, coordinator=f"file://{tmp / 'store'}")
        out, err = cli.communicate(timeout=240)
        into["cli"] = subprocess.CompletedProcess(CLI, cli.returncode, out, err)
    except Exception as e:           # raised again in the test's thread
        into["error"] = e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two children's reports and states, and what they are held to,
    computed here while they run."""
    tmp = tmp_path_factory.mktemp("host_mesh")
    series = nn5_synthetic(seed=0, num_clients=K, num_days=120)
    tr, _, te, _ = client_series_datasets(series, TINY["look_back"],
                                          TINY["horizon"])
    jparams, tparams = numpy_params(seed=3)
    flat = {f"p/{path}": t.numpy() for path, t in pt.flatten_with_paths(tparams)}
    np.savez(tmp / "inputs.npz", train=tr, test=te, **flat)
    spawned = {}
    thread = threading.Thread(target=_spawn, args=(tmp, spawned))
    thread.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # as each of the four children
    mp = pytest.MonkeyPatch()
    mp.setattr(train_mod, "get_config", f32(get_config))
    mp.setattr(serve_mod, "get_config", f32(get_config))
    mp.setattr(jax_train, "get_config", f32(jax_get_config))
    try:
        out = {"train": train_mod.train(ARCH, **TRAIN, device="cpu",
                                        log_every=100,
                                        ckpt_dir=str(tmp / "one")),
               "serve": serve_mod.serve(ARCH, **SERVE, device="cpu"),
               "jax_train": jax_train.train(ARCH, **TRAIN, log_every=100),
               "jax_serve": _jax_serve_loop(
                   f32(jax_get_config)(ARCH).reduced(), SERVE["batch"],
                   SERVE["prompt_len"], SERVE["gen"]),
               "scan": TE.run_fl(TCFG, TE.FLConfig(**HYBRID_FL), tr, te,
                                 R.PRNGKey(0), init_params=tparams,
                                 device="cpu", driver="scan", **RUN),
               "jax_scan": JE.run_fl(JCFG, JE.FLConfig(**HYBRID_FL), tr, te,
                                     jax.random.PRNGKey(0),
                                     init_params=jparams, driver="scan", **RUN),
               "root": tmp}
    finally:
        mp.undo()
        torch.set_num_threads(threads)
        thread.join()
    if "error" in spawned:
        raise spawned["error"]
    reps = []
    for i, r in enumerate(spawned["procs"]):
        assert r.returncode == 0, f"child {i} failed:\n{r.stderr[-4000:]}"
        reps.append(json.loads(r.stdout.strip().splitlines()[-1]))
    out["reps"], out["cli"] = reps, spawned["cli"]
    out["states"] = [{d: dict(np.load(tmp / f"{d}_{i}.npz"))
                      for d in ("scan", "while")} for i in range(2)]
    return out


# ---- the host mesh -----------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_host_mesh_is_the_reference_shape(monkeypatch, world):
    """``(n // model, model)`` over ``("data", "model")``, ``model`` clamped
    to ``n`` (``repro.launch.mesh.make_host_mesh``), ``n`` the group's
    world size; without a group ``n`` is 1."""
    import torch.distributed as dist

    for m in (1, 2, 4, 16):
        assert TM.make_host_mesh(model=m, device="cpu").axis_sizes == (1, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: world - 1)
    for m in (1, 2, 4, 16):
        mesh = TM.make_host_mesh(model=m, device="cpu")
        want = (world // min(m, world), min(m, world))
        assert mesh.axis_names == ("data", "model") and mesh.axis_sizes == want
        assert mesh.devices == (torch.device("cpu"),)
    if world > 2:
        with pytest.raises(ValueError, match="does not divide"):
            TM.make_host_mesh(model=3, device="cpu")


def test_host_mesh_over_two_ranks(runs):
    for i, rep in enumerate(runs["reps"]):
        assert rep["backend"] == "gloo"
        assert rep["host_mesh"] == [[2, 1], [1, 2], [1, 2]]


# ---- train and serve on two ranks ---------------------------------------------


def test_train_on_two_ranks_matches_one_process_and_the_reference(runs):
    one = runs["train"]
    for rep in runs["reps"]:
        assert len(rep["losses"]) == TRAIN["steps"]
        np.testing.assert_allclose(rep["losses"], one, rtol=1e-6, atol=0)
        _close(rep["losses"], runs["jax_train"], tol=TRAIN_PARITY_TOL)
    assert runs["reps"][0]["losses"] == runs["reps"][1]["losses"]


def test_train_checkpoint_of_two_ranks_reads_back_in_one_process(runs):
    """Process 0 alone writes it, whole tensors in the one-process format."""
    root = runs["root"]
    cfg = f32(get_config)(ARCH).reduced()
    template = {"params": TD.abstract_params(cfg)}      # meta, float32
    two, extra = load_checkpoint(str(root / "ckpt"), template)
    one, extra_one = load_checkpoint(str(root / "one"), template)
    assert extra == {"arch": ARCH, "final_loss": runs["reps"][0]["losses"][-1]}
    assert set(extra_one) == set(extra)
    assert os.listdir(root / "ckpt") == [f"step_{TRAIN['steps']:08d}"]
    with open(root / "ckpt" / os.listdir(root / "ckpt")[0] / "manifest.json") as f:
        keys2 = json.load(f)["keys"]
    with open(root / "one" / os.listdir(root / "one")[0] / "manifest.json") as f:
        assert json.load(f)["keys"] == keys2
    for (path, a), (_, b) in zip(pt.flatten_with_paths(two),
                                 pt.flatten_with_paths(one)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def test_serve_on_two_ranks_gives_the_one_process_tokens(runs):
    one = runs["serve"]
    for rep in runs["reps"]:
        np.testing.assert_array_equal(rep["tokens"], one["tokens"])
        np.testing.assert_array_equal(rep["tokens"], runs["jax_serve"])
        assert np.shape(rep["logits"]) == (SERVE["batch"], SERVE["gen"] + 1, 512)
        np.testing.assert_allclose(rep["logits"], one["logits"].numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert runs["reps"][0]["logits"] == runs["reps"][1]["logits"]


# ---- the FL client mesh: two processes x two shards ----------------------------


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_hybrid_client_mesh_is_bitwise_the_one_process_scan(runs, driver):
    h = runs["scan"]
    for i, rep in enumerate(runs["reps"]):
        assert rep["mesh"] == [i, 2, "gloo", 2]
        got = rep[driver]
        lo, hi = got["owned_rows"]
        assert (lo, hi) == (6 * i, 6 * i + 6)
        assert got["losses"] == h["train_loss"] and got["comm"] == h["comm"]
        assert got["rmse"] == [[int(r), float(v)] for r, v in h["rmse"]]
        assert got["final_rmse"] == h["final_rmse"]
        assert got["comm_bytes"] == h["final_comm_bytes"]
        assert got["rounds"] == h["rounds_run"]
        assert got["w"] == sha(h["state"]["w_global"])
        for k, v in h["state"].items():
            want = v.numpy()[lo:hi] if k in TE._CLIENT_AXIS_KEYS else v.numpy()
            np.testing.assert_array_equal(runs["states"][i][driver][k], want,
                                          err_msg=k)
        run = got["mesh_run"]
        assert (run["processes"], run["shards"], run["backend"]) == (2, 2, "gloo")
        assert run["devices"] == ["cpu", "cpu"] and run["graphs"] == []


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_hybrid_client_mesh_exchanges_at_both_levels(runs, driver):
    """Per round one local merge and gather into the first shard and one
    of each across the processes: the full payload, two blocks of two
    rows locally, the process's four rows across."""
    tr = np.load(runs["root"] / "inputs.npz")["train"]
    S, T = HYBRID_FL["participation"], tr.shape[1]
    Dv = runs["scan"]["meta"].total
    rounds = runs["scan"]["rounds_run"]
    for rep in runs["reps"]:
        ex = rep[driver]["exchange"]
        assert (ex["backend"], ex["processes"], ex["shards"]) == ("local", 2, 2)
        assert ex["merge"]["bytes"] == [S * (3 * Dv + 1 + T) * 4] * rounds
        assert ex["gather"]["bytes"] == [S // 4 * (3 * Dv + 2) * 4] * rounds
        across = ex["across"]
        assert (across["backend"], across["processes"]) == ("gloo", 2)
        assert across["merge"]["bytes"] == [S * (3 * Dv + 1 + T) * 4] * rounds
        assert across["gather"]["bytes"] == [S // 2 * (3 * Dv + 2) * 4] * rounds
        assert len(across["merge"]["s"]) == len(across["gather"]["s"]) == rounds


def test_hybrid_client_mesh_matches_the_reference_scan(runs):
    """Against the JAX package's one-process scan driver: rounds, comm and
    counters exact, floats within FL_PARITY_TOL (``attn/bk`` left out)."""
    jh = runs["jax_scan"]
    keep = TE.bk_free(runs["scan"]["meta"]).numpy()
    js = {k: np.asarray(v) for k, v in jh["state"].items()}
    for rep, st in zip(runs["reps"], runs["states"]):
        got, st = rep["scan"], st["scan"]
        lo, hi = got["owned_rows"]
        assert got["rounds"] == jh["rounds_run"] and got["comm"] == jh["comm"]
        assert got["comm_bytes"] == jh["final_comm_bytes"]
        np.testing.assert_allclose(got["losses"], jh["train_loss"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose([v for _, v in got["rmse"]],
                                   [v for _, v in jh["rmse"]], rtol=TOL, atol=TOL)
        for k in ("round", "comm_down", "comm_up"):
            np.testing.assert_array_equal(st[k], js[k], err_msg=k)
        np.testing.assert_array_equal(st["adam_t"], js["adam_t"][lo:hi])
        np.testing.assert_allclose(st["w_global"][keep], js["w_global"][keep],
                                   rtol=TOL, atol=TOL)
        for k in ("w_clients", "adam_m", "adam_v"):
            np.testing.assert_allclose(st[k][:, keep], js[k][lo:hi][:, keep],
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("gpus,group_device,want", [
    (4, 1, (1, 3)), (5, 1, (1, 3)), (3, 1, (1,)), (4, 3, (3,)), (4, None, ())])
def test_multi_host_client_mesh_takes_every_local_device(monkeypatch, gpus,
                                                         group_device, want):
    """Process 1 of 2 on a host of ``gpus`` GPUs: the host's GPUs dealt over
    the processes, its group device first, as many in each process; its
    group device alone where it has no second one (or was given another
    than ``cuda:1``), or on the CPU."""
    dev = (torch.device("cpu") if group_device is None
           else torch.device("cuda", group_device))
    monkeypatch.setattr(D, "is_initialized", lambda: True)
    monkeypatch.setattr(D, "device", lambda: dev)
    monkeypatch.setattr(D, "process_index", lambda: 1)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "backend", lambda: "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    mesh = TM.make_client_mesh(multi_host=True)
    assert mesh.devices == (tuple(torch.device("cuda", i) for i in want)
                            or (dev,))
    assert (mesh.index, mesh.count, mesh.backend) == (1, 2, "nccl")


# ---- the launchers' flags -------------------------------------------------------


@pytest.mark.parametrize("main", [train_mod.main, serve_mod.main])
def test_more_processes_than_gpus_raise(main):
    """One GPU a rank under NCCL: no quiet sharing of a card under gloo."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="NCCL takes one GPU a rank"):
        main(["--arch", ARCH, "--device", "cuda", "--processes", str(have + 1)])
    with pytest.raises(ValueError, match="must be >= 1"):
        main(["--arch", ARCH, "--device", "cpu", "--processes", "0"])
    assert D._without_option(["--a", "1", "--processes", "2", "--processes=3",
                              "--b"], "--processes") == ["--a", "1", "--b"]


def test_shard_batch_flag_reaches_the_server(monkeypatch, tmp_path):
    from repro_torch.core import forecast
    from repro_torch.core.forecaster import get_forecaster, save_forecaster
    from repro_torch.models.spec import init_params_from_key

    fc = get_forecaster("logtst", **D.SMOKE_MODEL)
    params = init_params_from_key(forecast.model_spec(fc.cfg), R.PRNGKey(0),
                                  torch.device("cpu"))
    save_forecaster(str(tmp_path), fc, params, step=1)
    made = []
    real = TS.ForecastServer.__init__

    def recording(self, *args, **kw):
        made.append(kw.get("shard_batch"))
        real(self, *args, **kw)

    monkeypatch.setattr(TS.ForecastServer, "__init__", recording)
    common = ["--ckpt-dir", str(tmp_path), "--device", "cpu", "--requests", "4"]
    TS.main(common + ["--shard-batch"])
    TS.main(common)
    assert made == [True, False]


def test_cli_processes_on_the_cpu(runs):
    """``python -m repro_torch.launch.serve --processes 2`` on the CPU: two
    gloo ranks, process 0's output relayed, exit 0."""
    r = runs["cli"]
    assert r.returncode == 0, r.stderr[-4000:]
    assert "over 2 process(es)" in r.stdout and "generated" in r.stdout


def test_a_group_of_one_moves_the_exchanges_through_its_transport(tmp_path):
    """``initialize_distributed(min_processes=1)`` (what ``join_group`` and
    the smoke's ``--num-processes 1`` use) forms a group of one, whose
    ``merge_disjoint`` / ``allgather_blocks`` / ``sync`` still run their
    collectives, bit for bit (the card runs them under NCCL:
    ``chip_smoke.py`` phase 16 (d)); the default stays the no-op."""
    store = f"file://{tmp_path / 'store'}"
    assert D.initialize_distributed(store, 1, 0, device="cpu") is False
    assert D.initialize_distributed(store, 1, 0, device="cpu",
                                    min_processes=1) is True
    try:
        assert (D.backend(), D.process_count()) == ("gloo", 1)
        x = torch.tensor([[-0.0, 1.5]])
        merged = D.merge_disjoint(x)
        assert merged is not x and torch.equal(merged.view(torch.int32),
                                               x.view(torch.int32))
        assert D._smoke_exchange(torch.device("cpu"))
        D.sync("one")
    finally:
        D.shutdown_distributed()
    assert not D.is_initialized()
