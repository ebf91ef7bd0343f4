"""The port's local mesh on the CPU: several shards of ONE process, here two
shards of one CPU device (the counterpart of the reference's
``--xla_force_host_platform_device_count=2`` virtual devices).

  * the FL client axis (``run_fl(client_mesh=Mesh("clients", (cpu, cpu)))``,
    ``core.fl.partition.MeshRun`` with a ``LocalExchange``): bitwise equal
    to the unsharded run where ``validate_partition`` holds, the unsharded
    run itself (``sharded: False``) where the shards do not divide K, the
    reference's RMSE contract (``rtol=1e-5``, ``tests/test_engine.py``)
    where only ``client_chunk`` fails, and within ``FL_PARITY_TOL`` of the
    JAX package's unsharded run (its sharded test is a reference caveat);
  * serving's batch axis (``ForecastServer(shard_batch=True)`` with
    ``launch.mesh.make_batch_mesh`` patched, as the reference's test sets
    ``XLA_FLAGS``): each block bitwise its own forward, the bucket within
    the served tolerance of the plain server and of the JAX server, a
    bucket the shards do not divide bitwise the plain server's, and a
    reload that builds every shard;
  * what keeps raising: the zoo's host mesh over several devices of one
    process (one process a GPU: ``--processes N``) and a mesh across
    processes without their group.

The card's versions are in ``test_torch_kernels_cuda.py``.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import forecaster as JFC  # noqa: E402
from repro.core import tasks as JT  # noqa: E402
from repro.core.fl import engine as JE  # noqa: E402
from repro.launch import serve_forecast as JS  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from repro_torch.core.fl import partition as TP  # noqa: E402
from repro_torch.launch import distributed as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import serve_forecast as TS  # noqa: E402
from torch_fl_utils import (JCFG, TCFG, TOL, configs, make_data,  # noqa: E402
                            same_state)

CPU = torch.device("cpu")
TWO = TM.Mesh("clients", (CPU, CPU))
RUN = dict(max_rounds=5, patience=99, eval_every=2, device="cpu")
# a cohort of 4 of the 6 stations, 2 a shard, in the unsharded run's chunks
MESH_FL = dict(policy="psgf", use_pallas_mix=True, participation=4,
               client_chunk=2)
# served forecasts: atol 1e-4 + rtol 1e-4 (PERF.md section 2)
SERVE_TOL = 1e-4
TINY = dict(look_back=16, horizon=2, d_model=16, num_heads=2, d_ff=16,
            patch_len=8, stride=4)


@pytest.fixture(scope="module")
def data():
    return make_data()


def _same_run(a, b):
    for k in ("rounds_run", "round", "train_loss", "comm", "rmse",
              "final_rmse", "final_comm_bytes"):
        assert a[k] == b[k], k
    assert set(a["state"]) == set(b["state"])
    for k, v in a["state"].items():
        assert torch.equal(b["state"][k], v), k


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_local_mesh_equals_the_unsharded_run(data, driver):
    tr, te = data[True]
    _, fl = configs(tr.shape[0], streaming_windows=True, **MESH_FL)
    plain = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(1), driver=driver, **RUN)
    h = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(1), driver=driver,
                  client_mesh=TWO, **RUN)
    _same_run(plain, h)
    assert h["state"]["w_clients"].shape[0] == tr.shape[0]   # the whole axis
    assert h["owned_rows"] == (0, tr.shape[0])
    run = h["mesh_run"]
    assert (run["shards"], run["sharded"], run["devices"]) == (
        2, True, ["cpu", "cpu"])
    assert run["processes"] == 1 and run["backend"] == "local"
    ex = h["exchange"]
    assert (ex["backend"], ex["shards"], ex["processes"]) == ("local", 2, 1)
    S, D = 4, h["meta"].total
    merge = sum(np.prod(s) * d.itemsize
                for s, d in TP.merge_specs(S, D, tr.shape[1:]))
    gather = sum(np.prod(s) * d.itemsize for s, d in TP.update_specs(S // 2, D))
    assert ex["merge"]["bytes"] == [merge] * h["rounds_run"]
    assert ex["gather"]["bytes"] == [gather] * h["rounds_run"]
    assert len(ex["merge"]["s"]) == len(ex["gather"]["s"]) == h["rounds_run"]
    assert ex["rmse"]["bytes"] == []


def test_local_mesh_leaves_an_undivided_client_axis_unsharded(data):
    tr, te = (a[:5] for a in data[True])
    _, fl = configs(5, streaming_windows=True, **MESH_FL)
    plain = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(2), **RUN)
    h = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(2), client_mesh=TWO, **RUN)
    _same_run(plain, h)
    assert h["mesh_run"]["sharded"] is False
    assert h["mesh_run"]["shards"] == 2 and "exchange" not in h


def test_local_mesh_without_client_chunk_holds_the_rmse(data):
    """Each shard's LocalUpdate is one vmap of 2 clients where the unsharded
    run's is one of 4: the reference's contract for this path, the final
    RMSE within ``rtol=1e-5``."""
    tr, te = data[True]
    _, fl = configs(tr.shape[0], streaming_windows=True,
                    **{**MESH_FL, "client_chunk": None})
    plain = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(3), **RUN)
    h = TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(3), client_mesh=TWO, **RUN)
    assert h["mesh_run"]["sharded"] is True
    assert h["rounds_run"] == plain["rounds_run"] and h["comm"] == plain["comm"]
    np.testing.assert_allclose(h["final_rmse"], plain["final_rmse"], rtol=1e-5)


def test_local_mesh_scan_matches_the_reference_unsharded_run(data):
    """Held against ``repro.core.fl.engine.run_fl(driver="scan")`` without
    sharding: the reference's own sharded test is a caveat (ROADMAP Queue
    C), and it asserts equality with this run."""
    tr, te = data[False]
    jfl, tfl = configs(tr.shape[0], **MESH_FL)
    kw = dict(max_rounds=4, patience=99, eval_every=2, driver="scan")
    jh = JE.run_fl(JCFG, jfl, jnp.asarray(tr), jnp.asarray(te),
                   jax.random.PRNGKey(4), **kw)
    th = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(4), device="cpu",
                   client_mesh=TWO, **kw)
    assert th["mesh_run"]["sharded"] is True
    assert th["rounds_run"] == jh["rounds_run"] and th["round"] == jh["round"]
    assert th["comm"] == jh["comm"]
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose([v for _, v in th["rmse"]],
                               [v for _, v in jh["rmse"]], rtol=TOL, atol=TOL)
    same_state(jh["state"], th["state"], th["meta"])


def test_mesh_keeps_raising_where_it_needs_a_process_a_gpu(data, monkeypatch):
    """A mesh across processes needs their group (one with two devices in
    each runs in ``test_torch_host_mesh.py``) and starts at this process's
    group device, and the zoo's host mesh over several local devices of one
    process names the launcher of one process a GPU."""
    tr, te = data[True]
    _, fl = configs(tr.shape[0], streaming_windows=True, **MESH_FL)
    across = TM.Mesh("clients", (CPU, CPU), index=0, count=2, backend="gloo")
    with pytest.raises(RuntimeError, match="initialized process group"):
        TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(0), client_mesh=across, **RUN)
    with monkeypatch.context() as mp:
        mp.setattr(TD, "process_count", lambda: 2)
        mp.setattr(TD, "process_index", lambda: 0)
        mp.setattr(TD, "device", lambda: torch.device("cuda", 1))
        with pytest.raises(ValueError, match="group device cuda:1, not at cpu"):
            TE.run_fl(TCFG, fl, tr, te, R.PRNGKey(0), client_mesh=across, **RUN)
    monkeypatch.setattr(TM, "_local_devices", lambda device: (CPU, CPU))
    with pytest.raises(NotImplementedError, match="--processes 2"):
        TM.make_host_mesh(device="cpu")
    assert TM.make_batch_mesh(device="cpu").devices == (CPU, CPU)


# ---- serving's batch axis ----------------------------------------------------


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded") / "ckpts")
    task = JT.get_task("ev", quick=True, clusters=2, num_clients=10,
                       num_days=150, look_back=16, horizon=2)
    fc = JFC.get_forecaster("logtst", use_flash_attn=True, **TINY)
    init = jax.jit(fc.init_params)
    for i, sub in enumerate(("psgf_c0", "psgf_c1", "psgf_c1_g1")):
        JFC.save_forecaster(os.path.join(root, sub), fc,
                            init(jax.random.PRNGKey(i)))
    JT.write_routing_manifest(root, task, fc, np.array([0, 1] * 5),
                              [{"policy": "psgf", "cluster": 0},
                               {"policy": "psgf", "cluster": 1}])
    return root


def _servers(root, monkeypatch):
    """The plain server and one whose batch mesh is two CPU shards."""
    plain = TS.ForecastServer.from_manifest(root, device="cpu", max_batch=8)
    monkeypatch.setattr(TM, "make_batch_mesh",
                        lambda axis="batch", device=None: TM.Mesh(axis, (CPU, CPU)))
    shard = TS.ForecastServer.from_manifest(root, device="cpu", max_batch=8,
                                            shard_batch=True)
    return plain, shard


def test_shard_batch_splits_a_divided_bucket(routed, monkeypatch):
    plain, shard = _servers(routed, monkeypatch)
    assert shard.batch_mesh.devices == (CPU, CPU) and plain.batch_mesh is None
    x = np.random.default_rng(0).standard_normal((8, 3, 16)).astype(np.float32)
    got = shard.predict(x, cluster=1)
    for i in range(2):                    # each block is its own forward
        np.testing.assert_array_equal(got[4 * i:4 * (i + 1)],
                                      plain.predict(x[4 * i:4 * (i + 1)],
                                                    cluster=1))
    want = plain.predict(x, cluster=1)
    np.testing.assert_allclose(got, want, atol=SERVE_TOL, rtol=SERVE_TOL)
    # on the CPU the whole bucket is bitwise too, as in the reference
    np.testing.assert_array_equal(got, want)
    jsrv = JS.ForecastServer.from_manifest(routed, max_batch=8)
    np.testing.assert_allclose(got, jsrv.predict(x, cluster=1),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    jsrv.close()
    # bucket 1: not divided by the shards, whole on the first
    np.testing.assert_array_equal(shard.predict(x[:1], cluster=0),
                                  plain.predict(x[:1], cluster=0))
    engine = shard.engines[1]
    assert sorted(engine._free) == [(4, 3), (4, 3, 1)]
    assert sorted(shard.engines[0]._free) == [(1, 3)]


def test_shard_batch_reload_builds_every_shard(routed, monkeypatch, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(routed, root)
    plain, shard = _servers(root, monkeypatch)
    shard.warmup(channels=3)
    TT.update_routing_manifest(root, "psgf", {1: "psgf_c1_g1"})
    old = shard.engines[1]
    assert shard.reload() is True and plain.reload() is True
    engine = shard.engines[1]
    assert engine is not old and len(engine.shards) == 2
    assert engine._params[1] is engine._params[0]     # one copy a device
    # the warm-up at 3 channels built both shards' buffers of every bucket
    assert sorted(engine._free) == sorted(
        [(b // 2, 3) for b in (2, 4, 8)] + [(b // 2, 3, 1) for b in (2, 4, 8)])
    x = np.random.default_rng(1).standard_normal((8, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(shard.predict(x, cluster=1),
                                  plain.predict(x, cluster=1))
