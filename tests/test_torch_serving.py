"""The port's routed serving path against the JAX package's, on the CPU.

A routed manifest is built cheaply with the JAX package (per-cluster
``save_forecaster`` on initial params, ``write_routing_manifest``, no
training); the port's ``ForecastServer`` (``device="cpu"``) must serve it as
the JAX server does: forecasts within ``PORT_PARITY_TOL``, and routing,
buckets and counters exactly. The last test goes the other way: a
port-written manifest served by the JAX server.
"""
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import forecaster as JFC  # noqa: E402
from repro.core import tasks as JT  # noqa: E402
from repro.launch import serve_forecast as JS  # noqa: E402
from repro_torch.core import forecaster as TFC  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core.forecast import PORT_PARITY_TOL  # noqa: E402
from repro_torch.launch import serve_forecast as TS  # noqa: E402
from repro_torch.launch.metrics import parse_exposition  # noqa: E402

TOL = PORT_PARITY_TOL
TINY = dict(look_back=16, horizon=2, d_model=16, num_heads=2, d_ff=16,
            patch_len=8, stride=4)
TASK = dict(quick=True, clusters=2, num_clients=10, num_days=150,
            look_back=16, horizon=2)
# station 8 maps to cluster 2, which has no checkpoint: unroutable
LABELS = np.array([0, 1, 0, 1, 0, 1, 0, 1, 2, 0])
KW = dict(max_batch=4, max_wait_ms=20.0)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("routed") / "ckpts")
    task = JT.get_task("ev", **TASK)
    fc = JFC.get_forecaster("logtst", use_flash_attn=True, **TINY)
    init = jax.jit(fc.init_params)
    for i, sub in enumerate(("psgf_c0", "psgf_c1", "psgf_c1_g1")):
        JFC.save_forecaster(os.path.join(root, sub), fc,
                            init(jax.random.PRNGKey(i)))
    series = task.series()
    JT.write_routing_manifest(root, task, fc, LABELS,
                              [{"policy": "psgf", "cluster": 0},
                               {"policy": "psgf", "cluster": 1}],
                              series=series)
    jsrv = JS.ForecastServer.from_manifest(root, **KW)
    jraw = JS.ForecastServer.from_manifest(root, denormalize=True, **KW)
    yield {"root": root, "series": series, "jax": jsrv, "jax_raw": jraw}
    jsrv.close()
    jraw.close()


def _port(root, **kw):
    return TS.ForecastServer.from_manifest(root, device="cpu", **{**KW, **kw})


def test_routed_predict_matches_jax(routed):
    srv, jsrv = _port(routed["root"]), routed["jax"]
    assert srv.station_cluster == jsrv.station_cluster == LABELS.tolist()
    assert srv.routable_stations() == jsrv.routable_stations()
    assert srv.buckets == jsrv.buckets == TS.batch_buckets(4) == (1, 2, 4)
    assert srv.forecaster.cfg.use_flash_attn is True
    x = np.random.default_rng(0).standard_normal((5, 2, 16)).astype(np.float32)
    base = dict(jsrv.stats)
    for c in (0, 1):
        _close(srv.predict(x, cluster=c), jsrv.predict(x, cluster=c))
    for s in srv.routable_stations():
        _close(srv.predict(x[s % 5], station=s), jsrv.predict(x[s % 5], station=s))
    for k in ("batches", "padded_slots", "series_served"):
        assert srv.stats[k] == jsrv.stats[k] - base[k], k
    with pytest.raises(KeyError, match="unknown station"):
        srv.resolve_cluster(station=99)
    with pytest.raises(ValueError, match="pass station= or cluster="):
        srv.predict(x)
    with pytest.raises(KeyError, match="unknown policy"):
        _port(routed["root"], policy="nope")


def test_queue_submit_and_unroutable_station(routed):
    srv, jsrv = _port(routed["root"]), routed["jax"]
    rng = np.random.default_rng(1)
    reqs = [rng.standard_normal((2, 16)).astype(np.float32) for _ in LABELS]
    srv.start()
    try:
        futs = [srv.submit(x, station=s) for s, x in enumerate(reqs)]
        bad_shape = srv.submit(np.zeros((2, 5), np.float32), station=0)
        for s, (x, f) in enumerate(zip(reqs, futs)):
            if s == 8:
                with pytest.raises(KeyError, match="no checkpoint for cluster 2"):
                    f.result(timeout=60)
            else:
                _close(f.result(timeout=60), jsrv.predict(x, station=s))
        with pytest.raises(ValueError, match="look_back=16"):
            bad_shape.result(timeout=60)
    finally:
        srv.stop()
    assert srv.cluster_stats[0]["requests"] == 5
    assert srv.cluster_stats[1]["requests"] == 4
    samples = parse_exposition(srv.metrics_text())
    assert samples[("forecast_rejected_total", (("kind", "unroutable"),))] == 1
    assert samples[("forecast_rejected_total", (("kind", "malformed"),))] == 1

    def families(text):
        return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
    assert families(srv.metrics_text()) == families(jsrv.metrics_text())


def test_denormalized_raw_requests_match_jax(routed):
    srv, jraw = _port(routed["root"], denormalize=True), routed["jax_raw"]
    series = routed["series"]
    for a, b in zip(srv.station_norm, jraw.station_norm):
        np.testing.assert_array_equal(a, b)
    s = srv.routable_stations()[1]
    x_raw = series[s, :16][None].astype(np.float32)
    y = srv.predict(x_raw, station=s)
    _close(y, jraw.predict(x_raw, station=s))
    srv.start()
    try:
        _close(srv.submit(x_raw, station=s).result(timeout=60), y)
    finally:
        srv.stop()
    # explicit cluster: normalized units, no station rescale
    c = srv.station_cluster[s]
    _close(srv.predict(x_raw, station=s, cluster=c),
           jraw.predict(x_raw, cluster=c))


def test_reload_swaps_and_drains_queued_futures(routed, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(routed["root"], root)
    srv = _port(root)
    x = np.random.default_rng(2).standard_normal((2, 16)).astype(np.float32)
    old_y = routed["jax"].predict(x, station=1)
    queued = [srv.submit(x, station=1) for _ in range(3)]   # worker not started
    gen, _ = TT.update_routing_manifest(root, "psgf", {1: "psgf_c1_g1"})
    engine0 = srv.engines[0]
    assert srv.reload() is True and srv.generation == gen == 1
    assert srv.engines[0] is engine0          # unchanged cluster kept its engine
    assert srv.reload() is False              # nothing newer on disk
    fresh = srv.submit(x, station=1)
    srv.start()
    try:
        for f in queued:                      # drained through generation 0
            _close(f.result(timeout=60), old_y)
        jnew = JS.ForecastServer.from_manifest(root, **KW)
        _close(fresh.result(timeout=60), jnew.predict(x, station=1))
        jnew.close()
    finally:
        srv.stop()
    assert srv.stats["reloads"] == 1


def test_process_shard_and_manifest_watcher(routed, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(routed["root"], root)
    for idx in (0, 1):
        mine = _port(root, process_shard=(idx, 2))
        theirs = JS.ForecastServer.from_manifest(root, process_shard=(idx, 2), **KW)
        assert sorted(mine.engines) == sorted(theirs.engines) == [idx]
        assert mine.station_cluster == theirs.station_cluster
        with pytest.raises(KeyError, match=f"no checkpoint for cluster {1 - idx}"):
            mine.resolve_cluster(cluster=1 - idx)
        theirs.close()
    srv = _port(root)
    srv.watch_manifest(interval_s=0.05)
    TT.update_routing_manifest(root, "psgf", {1: "psgf_c1_g1"})
    deadline = time.monotonic() + 30
    while srv.generation == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    srv.close()                               # also stops the poller
    assert srv.generation == 1 and srv._watch_thread is None


def test_close_fails_pending_futures(routed):
    srv = _port(routed["root"])
    x = np.zeros((1, 16), np.float32)
    pending = srv.submit(x, station=0)
    srv.close()
    with pytest.raises(RuntimeError, match="closed before this request"):
        pending.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(x, station=0).result(timeout=10)
    srv.close()                               # idempotent
    assert srv.predict(x, station=0).shape == (1, 2)


def test_stream_evaluate_rmse_matches_jax(routed):
    jtask = JT.get_task("ev", **TASK)
    ttask = TT.get_task("ev", **TASK)
    series = routed["series"]
    ev_t = TS.stream_evaluate(_port(routed["root"]), ttask, series=series,
                              max_windows=3)
    ev_j = JS.stream_evaluate(routed["jax"], jtask, series=series,
                              max_windows=3)
    for k in ("windows", "unroutable", "timed_out"):
        assert ev_t[k] == ev_j[k], k
    assert ev_t["unroutable"] == 3            # station 8, three windows
    assert sorted(ev_t["per_cluster"]) == sorted(ev_j["per_cluster"])
    np.testing.assert_allclose(ev_t["overall_rmse"], ev_j["overall_rmse"],
                               rtol=TOL)
    for c, v in ev_t["per_cluster"].items():
        assert v["windows"] == ev_j["per_cluster"][c]["windows"]
        np.testing.assert_allclose(v["rmse"], ev_j["per_cluster"][c]["rmse"],
                                   rtol=TOL)


def test_serve_requests_counters_match_jax(routed):
    srv, jsrv = _port(routed["root"]), routed["jax"]
    stations = srv.routable_stations()
    for use_queue in (False, True):
        a = TS.serve_requests(srv, 13, 2, use_queue=use_queue, stations=stations)
        b = JS.serve_requests(jsrv, 13, 2, use_queue=use_queue, stations=stations)
        assert a["requests"] == b["requests"] and a["routed"] is True
        if not use_queue:  # direct mode: batches are deterministic
            assert (a["batches"], a["padded_slots"]) == \
                (b["batches"], b["padded_slots"])


def test_port_written_manifest_served_by_jax(tmp_path):
    root = str(tmp_path / "port")
    task = TT.get_task("ev", **TASK)
    fc = TFC.get_forecaster("logtst", use_flash_attn=True, **TINY)
    gen = torch.Generator().manual_seed(0)
    for c in (0, 1):
        TFC.save_forecaster(os.path.join(root, f"psgf_c{c}"), fc,
                            fc.init_params(gen, device="cpu"))
    TT.write_routing_manifest(root, task, fc, LABELS,
                              [{"policy": "psgf", "cluster": 0},
                               {"policy": "psgf", "cluster": 1}],
                              series=task.series())
    jsrv = JS.ForecastServer.from_manifest(root, denormalize=True, **KW)
    srv = _port(root, denormalize=True)
    x = np.abs(np.random.default_rng(3).standard_normal((3, 2, 16))) \
        .astype(np.float32) * 20
    for s in (0, 1, 5):
        _close(srv.predict(x, station=s), jsrv.predict(x, station=s))
    jsrv.close()


def test_cli_and_unported_options(routed, capsys):
    TS.main(["--manifest", routed["root"], "--device", "cpu", "--requests",
             "8", "--channels", "1", "--max-batch", "4"])
    out = capsys.readouterr().out
    assert "restored 2 cluster models" in out and "8 requests" in out
    # shard_batch=True on one device is the unsharded server (the
    # reference's test_shard_batch_single_device_noop)
    x = np.random.default_rng(2).standard_normal((3, 2, 16)).astype(np.float32)
    one = _port(routed["root"], shard_batch=True)
    assert one.batch_mesh is None
    np.testing.assert_array_equal(one.predict(x, cluster=0),
                                  _port(routed["root"]).predict(x, cluster=0))
