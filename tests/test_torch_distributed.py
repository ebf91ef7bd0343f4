"""The port's multi-process path on the CPU over gloo
(``repro_torch.launch.distributed``, ``launch.mesh``, ``core.fl.partition``
and the host store's partition mode), held to the reference's own guards
(``tests/test_distributed.py``): a 2-process run equals the 1-process port
run bit for bit (per-round losses, comm, RMSE, ``w_global`` and each
process's block of ``w_clients``), and against the JAX package's 1-process
drivers the selection and comm counts are exact and floats within
``FL_PARITY_TOL`` (``attn/bk`` left out).

The 2-process runs spawn real children that meet through a file store in
``tmp_path`` (no port to collide on when files run in parallel); one module
fixture runs the cluster once (the host, scan and while drivers and the
exchange checks) and each test reads its part of the reports. The card's
versions are in ``test_torch_kernels_cuda.py``.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.fl import engine as JE  # noqa: E402
from repro.data.synthetic import nn5_synthetic  # noqa: E402
from repro.data.windowing import client_series_datasets  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core.fl import client_store as TCS  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from repro_torch.core.fl import partition as TP  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch.mesh import make_batch_mesh, make_client_mesh  # noqa: E402
from torch_fl_utils import JCFG, TCFG, TINY, TOL, numpy_params  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K = 12
RUN = dict(max_rounds=4, patience=99, eval_every=2)
# the reference's two cluster configurations (tests/test_distributed.py),
# with client_chunk dividing each process's cohort block (the port's rule)
HOST_FL = dict(policy="psgf", num_clients=K, local_steps=2, batch_size=4,
               streaming_windows=True, participation=8, client_chunk=2)
MESH_FL = dict(policy="psgf", num_clients=K, local_steps=1, batch_size=4,
               streaming_windows=True, participation=4, client_chunk=2)
STATE = ("w_global", "w_clients", "adam_m", "adam_v", "adam_t", "comm_down",
         "comm_up", "round")


def sha(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()


def child_env():
    """``src`` on the path; two threads a child (two children that each
    take every core run twice as long)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def run_cluster(code, tmp_path, *args, timeout=240):
    """``python -c code args`` in 2 processes of one gloo group; their JSON
    reports (last stdout line) in process order."""
    procs = D.spawn_processes(
        2, [sys.executable, "-c", code, *map(str, args)], env=child_env(),
        timeout=timeout, coordinator=f"file://{tmp_path / 'store'}")
    reports = []
    for i, r in enumerate(procs):
        assert r.returncode == 0, f"child {i} failed:\n{r.stderr[-4000:]}"
        reports.append(json.loads(r.stdout.strip().splitlines()[-1]))
    return reports


def report(h, state_rows):
    """What a run is held to: its history and hashes of its state."""
    return {"losses": h["train_loss"], "comm": h["comm"],
            "rmse": [[int(r), float(v)] for r, v in h["rmse"]],
            "final_rmse": h["final_rmse"], "comm_bytes": h["final_comm_bytes"],
            "rounds": h["rounds_run"], "w": sha(h["state"]["w_global"]),
            "wc": sha(state_rows)}


_CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.core import forecast as F
from repro_torch.core.fl.engine import FLConfig, run_fl
from repro_torch.core.forecaster import params_from_numpy
from repro_torch.launch import distributed as D
from repro_torch.launch.mesh import make_client_mesh

out_dir, run, host_fl, mesh_fl, tiny = sys.argv[1], *map(json.loads, sys.argv[2:6])
assert D.initialize_distributed(device="cpu")
idx, cnt = D.process_index(), D.process_count()
sha = lambda t: hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()
z = np.load(out_dir + "/inputs.npz")
params = params_from_numpy(pt.unflatten(
    {k[2:]: z[k] for k in z.files if k.startswith("p/")}), device="cpu")
cfg = F.logtst_config(**tiny)
out = {"backend": D.backend(), "device": str(D.device())}
mesh = make_client_mesh(multi_host=True)
out["mesh"] = [mesh.index, mesh.count, mesh.backend, str(mesh.device)]
for name, fl, kw in (("host", host_fl, dict(driver="host")),
                     ("scan", mesh_fl, dict(driver="scan", client_mesh=mesh)),
                     ("while", mesh_fl, dict(driver="while", client_mesh=mesh))):
    h = run_fl(cfg, FLConfig(**fl), z["train"], z["test"], R.PRNGKey(0),
               init_params=params, device="cpu", **run, **kw)
    s = h["state"]
    np.savez(f"{out_dir}/{name}_{idx}.npz",
             **{k: v.numpy() for k, v in s.items()})
    out[name] = {"losses": h["train_loss"], "comm": h["comm"],
                 "rmse": [[int(r), float(v)] for r, v in h["rmse"]],
                 "final_rmse": h["final_rmse"],
                 "comm_bytes": h["final_comm_bytes"],
                 "rounds": h["rounds_run"], "w": sha(s["w_global"]),
                 "wc": sha(s["w_clients"]), "owned_rows": h["owned_rows"],
                 "exchange": h["exchange"], "mesh_run": h.get("mesh_run")}

# the exchange primitives: pure bit transport, -0.0 included
rng = np.random.default_rng(7)
full = rng.standard_normal((8, 3)).astype(np.float32)
full[0, 0] = -0.0
lo, hi = D.block_range(8)
mine = np.zeros_like(full)
mine[lo:hi] = full[lo:hi]
merged = D.merge_disjoint(torch.from_numpy(mine)).numpy()
ints = np.arange(12, dtype=np.int32).reshape(4, 3) * (idx + 1)
gathered = D.allgather_blocks(full[lo:hi], 8).numpy()
both = D.merge_disjoint(mine, np.where(np.arange(4)[:, None] // 2 == idx, ints, 0).astype(np.int32))
errors = []
for bad in (lambda: D.allgather_blocks(full[:3], 8), lambda: D.allgather_blocks(full[:3], 7)):
    try:
        bad()
    except ValueError as e:
        errors.append(str(e))
out["exchange"] = {
    "merge_exact": bool((merged.view(np.int32) == full.view(np.int32)).all()),
    "neg_zero": bool(np.signbit(merged[0, 0])),
    "gather_exact": bool((gathered.view(np.int32) == full.view(np.int32)).all()),
    "pair_exact": bool((both[0].numpy().view(np.int32) == full.view(np.int32)).all()),
    "int_merge": both[1].tolist(), "errors": errors}
D.sync("done")
D.shutdown_distributed()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def inputs():
    series = nn5_synthetic(seed=0, num_clients=K, num_days=120)
    tr, _, te, _ = client_series_datasets(series, TINY["look_back"],
                                          TINY["horizon"])
    jparams, tparams = numpy_params(seed=3)
    return tr, te, jparams, tparams


@pytest.fixture(scope="module")
def cluster(inputs, tmp_path_factory):
    """The 2-process runs, once: reports and each process's state arrays."""
    tmp = tmp_path_factory.mktemp("cluster")
    tr, te, _, tparams = inputs
    flat = {f"p/{path}": t.numpy() for path, t in pt.flatten_with_paths(tparams)}
    np.savez(tmp / "inputs.npz", train=tr, test=te, **flat)
    reps = run_cluster(_CHILD, tmp, tmp, json.dumps(RUN), json.dumps(HOST_FL),
                       json.dumps(MESH_FL), json.dumps(TINY))
    states = [{name: dict(np.load(tmp / f"{name}_{i}.npz"))
               for name in ("host", "scan", "while")} for i in range(2)]
    return reps, states


@pytest.fixture(scope="module")
def one_process(inputs):
    """The 1-process port runs of the same configurations."""
    tr, te, _, tparams = inputs
    out = {}
    for name, fl, driver in (("host", HOST_FL, "host"), ("scan", MESH_FL, "scan"),
                             ("while", MESH_FL, "while")):
        out[name] = TE.run_fl(TCFG, TE.FLConfig(**fl), tr, te, R.PRNGKey(0),
                              init_params=tparams, device="cpu", driver=driver,
                              **RUN)
    return out


# ---- single-process units ---------------------------------------------------


def test_initialize_noop_without_cluster(monkeypatch):
    """No coordinator (or one process) -> the no-op returning False, so a
    launcher can call it unconditionally."""
    for var in (D.ENV_COORDINATOR, D.ENV_NUM_PROCESSES, D.ENV_PROCESS_ID,
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize_distributed(device="cpu") is False
    assert D.initialize_distributed("127.0.0.1:1", num_processes=1,
                                    device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize_distributed(device="cpu") is False
    assert (D.process_count(), D.process_index(), D.is_main()) == (1, 0, True)
    assert D.backend() is None and D.device() is None
    D.sync()                                     # no-op in one process
    x = torch.ones(2)
    assert D.fetch(x) is x


def test_block_range_partitions_exactly():
    blocks = [D.block_range(10, index=i, count=4) for i in range(4)]
    assert blocks[0][0] == 0 and blocks[-1][1] == 10
    for (_, hi), (lo, _) in zip(blocks, blocks[1:]):
        assert hi == lo                          # contiguous, disjoint, covering
    assert [hi - lo for lo, hi in blocks] == [2, 3, 2, 3]
    assert D.block_range(7) == (0, 7)            # one process owns all


def test_backend_is_picked_from_the_devices_and_never_silently():
    cpu, a, b = "cpu", "cuda/h/0", "cuda/h/1"
    assert D._pick_backend(None, [cpu, cpu]) == "gloo"
    assert D._pick_backend(None, [a, a]) == "gloo"      # two ranks, one GPU
    assert D._pick_backend(None, [a, b]) == "nccl"      # a GPU each
    assert D._pick_backend("gloo", [a, b]) == "gloo"
    for names in ([a, a], [cpu, cpu], [a, cpu]):
        with pytest.raises(ValueError, match="NCCL refuses two ranks"):
            D._pick_backend("nccl", names)
    with pytest.raises(ValueError, match="backend must be one of"):
        D._pick_backend("mpi", [cpu, cpu])
    assert D.process_device("cpu", 3) == torch.device("cpu")


def test_merge_and_gather_in_one_process_and_their_dtypes():
    x = torch.tensor([[-0.0, 1.5]], dtype=torch.float32)
    assert D.merge_disjoint(x) is x
    t = np.arange(4, dtype=np.int32)
    assert torch.equal(D.merge_disjoint(t), torch.from_numpy(t))
    for bad in (np.zeros((2, 2), np.float64), torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(TypeError, match="float32/int32"):
            D.merge_disjoint(bad)
    assert torch.equal(D.allgather_blocks(x, 1), x)
    with pytest.raises(ValueError, match="expected 2"):
        D.allgather_blocks(x, 2)


def test_meshes_without_a_group_are_one_process():
    for mesh in (make_client_mesh(device="cpu"),
                 make_client_mesh(multi_host=True, device="cpu"),
                 make_batch_mesh(device="cpu")):
        assert (mesh.index, mesh.count, mesh.backend) == (0, 1, None)
        assert mesh.devices == (torch.device("cpu"),)
        assert mesh.rows(12) == (0, 12)
    assert make_client_mesh(device="cpu").axis == "clients"
    assert make_batch_mesh(device="cpu").axis == "batch"


def test_client_store_partition_validation(inputs):
    tr, te, _, _ = inputs
    fl = TE.FLConfig(policy="psgf", num_clients=9, local_steps=1, batch_size=4,
                     streaming_windows=True)
    with pytest.raises(ValueError, match="divisible"):          # 9 % 2
        TCS.ClientStore(TCFG, fl, tr[:9], te[:9], R.PRNGKey(0),
                        partition=(0, 2), device="cpu")
    with pytest.raises(ValueError, match="partition"):          # index >= count
        TCS.ClientStore(TCFG, TE.FLConfig(**HOST_FL), tr, te, R.PRNGKey(0),
                        partition=(2, 2), device="cpu")


def test_run_fl_host_partition_rejects_thin_cohorts(inputs):
    """S must split evenly with >= 2 rows per process."""
    tr, te, _, _ = inputs
    for S in (5, 2):                     # odd split / 1-row blocks
        fl = TE.FLConfig(**{**HOST_FL, "participation": S, "client_chunk": 1})
        with pytest.raises(ValueError, match="participation"):
            TCS.run_fl_host(TCFG, fl, tr, te, R.PRNGKey(0), max_rounds=1,
                            partition=(0, 2), device="cpu")


@pytest.mark.parametrize("chunk", [None, 3])
def test_partition_needs_client_chunk_dividing_the_block(inputs, chunk):
    """The port's condition beyond the reference's (see the next test):
    each process runs the one-process run's own LocalUpdate chunks."""
    tr, te, _, _ = inputs
    fl = TE.FLConfig(**{**HOST_FL, "client_chunk": chunk})
    with pytest.raises(ValueError, match="client_chunk"):
        TCS.run_fl_host(TCFG, fl, tr, te, R.PRNGKey(0), max_rounds=1,
                        partition=(0, 2), device="cpu")
    with pytest.raises(ValueError, match="client_chunk"):
        TP.validate_partition(K, 8, 2, chunk)


def test_host_partition_needs_client_chunk_dividing_the_store_rows(inputs):
    """The host store streams its RMSE in ``client_chunk`` chunks of each
    process's ``K / count`` rows: the chunk must divide those too (here 4
    divides the cohort block of 4 but not the 6 store rows), while the mesh,
    which evaluates the replicated test series, does not need it."""
    tr, te, _, _ = inputs
    fl = TE.FLConfig(**{**HOST_FL, "client_chunk": 4})
    with pytest.raises(ValueError, match="6 store rows"):
        TCS.run_fl_host(TCFG, fl, tr, te, R.PRNGKey(0), max_rounds=1,
                        partition=(0, 2), device="cpu")
    TP.validate_partition(K, 8, 2, 4)
    with pytest.raises(ValueError, match="6 store rows"):
        TP.validate_partition(K, 8, 2, 4, streamed_eval=True)


def test_owned_rows_payload_and_scatter(inputs):
    """Stages 1 and 5 on a host store's rows (the mesh runs the same code
    on device rows): the payload holds the owned cohort positions' rows and
    exact ``+0.0`` elsewhere, the scatter writes back the owned rows only
    (the others land in the scratch row)."""
    tr, te, _, _ = inputs
    fl = TE.FLConfig(**HOST_FL)
    store = TCS.ClientStore(TCFG, fl, tr, te, R.PRNGKey(0), partition=(1, 2),
                            device="cpu")
    rows = store.rows
    assert (rows.lo, rows.n) == (6, 6)
    for k in TE._CLIENT_AXIS_KEYS:
        assert getattr(store, k).data_ptr() == rows.rows[k].data_ptr()
        assert rows.rows[k].shape[0] == 7                 # + the scratch row
    gen = torch.Generator().manual_seed(0)
    store.adam_m.copy_(-torch.rand(store.adam_m.shape, generator=gen))
    cohort = torch.tensor([7, 1, 11, 6, 0, 3, 8, 2])
    own = (cohort >= 6).numpy()
    out = [torch.full(s, 7.0).to(d) for s, d in
           TP.merge_specs(8, store.meta.total, store.train.shape[1:])]
    rows.cohort_payload(cohort, out)
    srcs = [getattr(store, k) for k in TE._CLIENT_AXIS_KEYS] + [store.train]
    for src, got in zip(srcs, out):
        want = torch.zeros_like(got)
        want[own] = src[cohort[own] - 6]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    before = {k: getattr(store, k).clone() for k in TE._CLIENT_AXIS_KEYS}
    sub = {k: torch.full_like(o, 5) for k, o in
           zip(TE._CLIENT_AXIS_KEYS, out)}
    rows.scatter_owned(cohort, sub)
    hit = np.zeros(6, bool)
    hit[cohort[own].numpy() - 6] = True
    for k, was in before.items():
        now = getattr(store, k)
        assert (now[hit] == 5).all() and torch.equal(now[~hit], was[~hit]), k


def test_client_grads_depend_on_the_vmap_width():
    """Why ``client_chunk`` must divide the block: with no chunk, one
    process would vmap all S clients where each of two vmaps S / 2, and at
    d_model 128 the CPU's gradients of the same clients then differ in the
    last bits (a difference from the reference, whose mesh test runs
    ``client_chunk=None``)."""
    from repro_torch.core import forecast as F
    from repro_torch.models.spec import init_params_from_key

    cfg = F.logtst_config(look_back=56, horizon=7, d_model=128, num_heads=16,
                          d_ff=256, patch_len=8, stride=4)
    params = init_params_from_key(F.model_spec(cfg), R.PRNGKey(0),
                                  torch.device("cpu"))
    vec, meta = pt.tree_flatten_to_vector(params)
    gen = torch.Generator().manual_seed(0)
    w = vec[None].repeat(4, 1) + 0.01 * torch.randn(4, vec.numel(), generator=gen)
    x = torch.randn(4, 32, 56, generator=gen)
    y = torch.randn(4, 32, 7, generator=gen)
    whole, _ = TE._client_grads(cfg, meta, w, x, y, None)
    halves = torch.cat([TE._client_grads(cfg, meta, w[i:i + 2], x[i:i + 2],
                                         y[i:i + 2], None)[0] for i in (0, 2)])
    chunked, _ = TE._client_grads(cfg, meta, w, x, y, 2)
    assert not torch.equal(whole, halves)
    assert torch.equal(chunked, halves)      # the same chunks: the same bits


def test_run_fl_rejects_client_mesh_on_host_driver(inputs):
    tr, te, _, _ = inputs
    with pytest.raises(ValueError, match="client_mesh"):
        TE.run_fl(TCFG, TE.FLConfig(**HOST_FL), tr, te, R.PRNGKey(0),
                  max_rounds=1, driver="host", device="cpu",
                  client_mesh=make_client_mesh(device="cpu"))


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_shard_clients_on_one_device_is_the_unsharded_run(inputs, driver):
    tr, te, _, tparams = inputs
    fl = TE.FLConfig(**MESH_FL)
    runs = [TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(0), init_params=tparams,
                      device="cpu", driver=driver, **RUN, **kw)
            for kw in ({}, dict(shard_clients=True),
                       dict(client_mesh=make_client_mesh(device="cpu")))]
    want = report(runs[0], runs[0]["state"]["w_clients"])
    for h in runs[1:]:
        assert report(h, h["state"]["w_clients"]) == want
        for k, v in runs[0]["state"].items():
            assert torch.equal(h["state"][k], v), k


# ---- 2-process gloo clusters: the bitwise guards ----------------------------


def test_exchange_primitives_two_process(cluster):
    """merge_disjoint / allgather_blocks are pure bit transport across the
    group: float32 payloads survive bit for bit (``-0.0`` included), int32
    payloads pass through, and a wrong block raises the reference's
    errors."""
    reps, _ = cluster
    for rep in reps:
        ex = rep["exchange"]
        assert ex["merge_exact"] and ex["neg_zero"] and ex["gather_exact"]
        assert ex["pair_exact"]
        assert ex["errors"][0].startswith("block has 3 rows, expected 4")
        assert "divisible by the process count, got 7 over 2" in ex["errors"][1]
    assert reps[0]["exchange"]["int_merge"] == reps[1]["exchange"]["int_merge"]
    assert reps[0]["exchange"]["int_merge"][2] == [12, 14, 16]


def test_group_backend_device_and_mesh(cluster):
    reps, _ = cluster
    for i, rep in enumerate(reps):
        assert (rep["backend"], rep["device"]) == ("gloo", "cpu")
        assert rep["mesh"] == [i, 2, "gloo", "cpu"]


@pytest.mark.parametrize("name", ["host", "scan", "while"])
def test_two_process_runs_equal_the_one_process_run(cluster, one_process, name):
    """THE tentpole guard: each driver over 2 processes is bitwise the
    1-process port run — per-round losses, comm, RMSE curve, wire bytes,
    ``w_global`` — and each process's client block is the 1-process run's
    rows ``[lo, hi)`` exactly."""
    reps, states = cluster
    h = one_process[name]
    for i, rep in enumerate(reps):
        got = dict(rep[name])
        lo, hi = got.pop("owned_rows")
        assert (lo, hi) == D.block_range(K, i, 2)
        for k in ("exchange", "mesh_run"):
            got.pop(k)
        assert got == report(h, h["state"]["w_clients"][lo:hi]), name
        for k in STATE:
            want = h["state"][k].numpy()
            want = want[lo:hi] if k in TE._CLIENT_AXIS_KEYS else want
            np.testing.assert_array_equal(states[i][name][k], want, err_msg=k)


@pytest.fixture(scope="module")
def reference(inputs):
    """The JAX package's 1-process runs: its host driver, and its scan
    driver for the mesh (its while equals its scan)."""
    tr, te, jparams, _ = inputs
    return {name: JE.run_fl(JCFG, JE.FLConfig(**fl), tr, te,
                            jax.random.PRNGKey(0), init_params=jparams,
                            driver=name, **RUN)
            for name, fl in (("host", HOST_FL), ("scan", MESH_FL))}


@pytest.mark.parametrize("name", ["host", "scan", "while"])
def test_two_process_runs_match_the_reference(cluster, reference, name):
    """Against the JAX package's 1-process driver: rounds, comm and wire
    bytes exact, each client's trained-round count (cohorts and selection)
    and the server counters exact, floats within FL_PARITY_TOL."""
    jh = reference["host" if name == "host" else "scan"]
    reps, states = cluster
    keep = TE.bk_free(_meta()).numpy()
    for rep, st in zip(reps, states):
        got = rep[name]
        lo, hi = got["owned_rows"]
        assert got["rounds"] == jh["rounds_run"]
        assert got["comm"] == jh["comm"]
        assert got["comm_bytes"] == jh["final_comm_bytes"]
        assert [r for r, _ in got["rmse"]] == [r for r, _ in jh["rmse"]]
        np.testing.assert_allclose(got["losses"], jh["train_loss"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose([v for _, v in got["rmse"]],
                                   [v for _, v in jh["rmse"]], rtol=TOL, atol=TOL)
        js = {k: np.asarray(v) for k, v in jh["state"].items()}
        for k in ("adam_t", "round", "comm_down", "comm_up"):
            want = js[k][lo:hi] if k == "adam_t" else js[k]
            np.testing.assert_array_equal(st[name][k], want, err_msg=k)
        np.testing.assert_allclose(st[name]["w_global"][keep],
                                   js["w_global"][keep], rtol=TOL, atol=TOL)
        for k in ("w_clients", "adam_m", "adam_v"):
            np.testing.assert_allclose(st[name][k][:, keep],
                                       js[k][lo:hi][:, keep], rtol=TOL,
                                       atol=TOL, err_msg=k)


def _meta():
    return pt.tree_flatten_to_vector(numpy_params(seed=3)[1])[1]


@pytest.mark.parametrize("name", ["host", "scan", "while"])
def test_exchange_history_counts_bytes_per_round(cluster, inputs, name):
    """``history["exchange"]``: one merge and one gather per round, each of
    the bytes the reference's exchange moves (the full-shape payload, a
    block of the cohort's LocalUpdate results)."""
    tr, _, _, _ = inputs
    reps, _ = cluster
    fl = HOST_FL if name == "host" else MESH_FL
    S, Dv, T = fl["participation"], _meta().total, tr.shape[1]
    for rep in reps:
        ex = rep[name]["exchange"]
        assert (ex["backend"], ex["processes"]) == ("gloo", 2)
        assert ex["merge"]["bytes"] == [S * (3 * Dv + 1 + T) * 4] * 4
        assert ex["gather"]["bytes"] == [S // 2 * (3 * Dv + 2) * 4] * 4
        assert len(ex["merge"]["s"]) == len(ex["gather"]["s"]) == 4
        assert len(ex["rmse"]["bytes"]) == (2 if name == "host" else 0)
        if name != "host":
            run = rep[name]["mesh_run"]
            assert (run["processes"], run["backend"]) == (2, "gloo")
            assert run["graphs"] == []           # the CPU runs the segments eagerly


def test_smoke_cli_two_process():
    """``python -m repro_torch.launch.distributed --smoke --device cpu``:
    two children (TCP store) against the parent's 1-process run, bitwise,
    and the process-sharded serving."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.distributed",
                        "--smoke", "--device", "cpu", "--timeout", "200"],
                       env=child_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("distributed smoke OK: 2 processes over gloo")
    summary = json.loads(lines[-2])
    assert summary["bitwise_to_one_process"] and summary["backend"] == "gloo"
    assert summary["devices"] == ["cpu", "cpu"]
    assert sorted(sum(summary["owned_clusters"], [])) == [0, 1]


def test_spawn_kills_the_group_when_a_child_fails(tmp_path):
    """A child that exits non-zero ends the others at once (a peer blocked
    in a collective would otherwise wait for its timeout)."""
    code = ("import os, sys, time\n"
            "if os.environ['REPRO_PROCESS_ID'] == '0': sys.exit(3)\n"
            "time.sleep(60)\n")
    procs = D.spawn_processes(2, [sys.executable, "-c", code], timeout=30,
                              coordinator=f"file://{tmp_path / 'store'}")
    assert procs[0].returncode == 3 and procs[1].returncode != 0
    with pytest.raises(subprocess.TimeoutExpired):
        D.spawn_processes(2, [sys.executable, "-c", "import time; time.sleep(60)"],
                          timeout=1, coordinator=f"file://{tmp_path / 's2'}")
