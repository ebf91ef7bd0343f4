"""The port's train→serve flywheel against the JAX package's, on the CPU.

One generation-0 root (2 DTW clusters, ``ev`` quick at 10 stations and 150
days, look_back 32, d_model 16, 2 rounds) is trained once by the
reference's ``run_experiment``; every test works on copies of it. Both
controllers retrain from the same root, series, labels and reports.

Bitwise: drift decisions and thresholds, retrained clusters, generations,
the published manifests (subdirs, station table, norm ``mu``/``sd``),
``rounds`` and ``comm_params``, the generation key. Within
``FL_PARITY_TOL``: the retrained RMSE and parameters (``attn/bk`` left
out, see the constant's note). Then the port's own manifest and reload
cases, as the reference's ``tests/test_flywheel.py`` has them.
"""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import tasks as JT  # noqa: E402
from repro.core.fl import flywheel as JW  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core.fl import flywheel as TW  # noqa: E402
from repro_torch.core.fl.engine import FL_PARITY_TOL, bk_free  # noqa: E402
from repro_torch.core.forecaster import load_forecaster  # noqa: E402
from repro_torch.launch import serve_forecast as TS  # noqa: E402
from repro_torch.launch.metrics import parse_exposition, sum_samples  # noqa: E402

TOL = FL_PARITY_TOL
TASK = dict(quick=True, clusters=2, num_clients=10, num_days=150,
            look_back=32, horizon=2)
MODEL = dict(quick=True, d_model=16, num_heads=2, d_ff=32)
RUN = dict(grid=(("psgf", {}),), local_steps=2, batch_size=16, max_rounds=2,
           patience=10, eval_every=2)
POLICY = "psgf-s30-f20"


def make_specs(driver="scan", **kw):
    """The reference test's ``make_spec()`` in both packages."""
    out = []
    for T in (JT, TT):
        task = T.get_task("ev", **TASK)
        model = T.task_forecaster(task, "logtst", **MODEL)
        out.append(T.ExperimentSpec(task=task, model=model, driver=driver,
                                    **{**RUN, **kw}))
    return out


@pytest.fixture(scope="module")
def trained_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flywheel_ckpts"))
    jspec, _ = make_specs()
    series = jspec.task.series()
    JT.run_experiment(jspec, checkpoint_dir=root, series=series)
    return {"root": root, "series": series,
            "labels": np.asarray(jspec.task.cluster_labels(series))}


@pytest.fixture()
def roots(trained_root, tmp_path):
    """Private copies of the generation-0 root: ``jax`` and ``port``."""
    out = dict(trained_root)
    for name in ("jax", "port"):
        out[name] = str(tmp_path / name)
        shutil.copytree(trained_root["root"], out[name])
    return out


def _port_ctl(roots, spec=None, **kw):
    return TW.RetrainController(spec or make_specs()[1], roots["port"],
                                series=roots["series"].copy(),
                                labels=roots["labels"], device="cpu", **kw)


def _inject_drift(series, labels, cluster, t_new=40, scale=3.0, offset=5.0):
    """New columns where only ``cluster``'s stations step-change."""
    tail = series[:, -t_new:].copy()
    rows = labels == cluster
    tail[rows] = tail[rows] * scale + offset
    return tail


def _trained_vec(path):
    _, params, _ = load_forecaster(path, device="cpu")
    return pt.tree_flatten_to_vector(params)


# ---- the drift detector and the key ----------------------------------------


DETECTORS = [dict(), dict(window=8, quantile=0.9, tolerance=1.2, min_obs=3),
             dict(window=2, quantile=0.5, tolerance=1.05, min_obs=1),
             dict(window=5, quantile=1.0, tolerance=1.0, min_obs=4)]


@pytest.mark.parametrize("cfg", DETECTORS)
def test_drift_detector_decisions_match_reference(cfg):
    """Seeded RMSE streams over three clusters, with drift steps, NaN
    readings, a thin baseline and resets: every threshold and decision
    equal to the reference detector's, bitwise."""
    rng = np.random.default_rng(len(cfg))
    jd, td = JW.DriftDetector(**cfg), TW.DriftDetector(**cfg)
    for i in range(60):
        c = int(rng.integers(0, 3))
        v = float(rng.gamma(4.0, 0.25))
        if rng.random() < 0.1:
            v *= 3.0                          # a drift step
        if rng.random() < 0.05:
            v = float("nan")                  # an empty replay
        for d in (jd, td):
            d.record(c, v)
        if i % 17 == 16:
            for d in (jd, td):
                d.reset(c)                    # after a retrain
        for c in range(4):                    # cluster 3 never recorded
            assert td.threshold(c) == jd.threshold(c)
            assert td.drifted(c) == jd.drifted(c)
        assert td.drifted_clusters() == jd.drifted_clusters()


def test_drift_detector_warm_up_nan_and_argument_checks():
    det = TW.DriftDetector(min_obs=3)
    det.record(1, 1.0)
    det.record(1, 100.0)                     # huge, but baseline too thin
    assert not det.drifted(1)
    det.record(2, float("nan"))              # empty replay: not recorded
    assert det.threshold(2) is None
    for bad in (dict(quantile=1.5), dict(quantile=0.0), dict(window=1),
                dict(tolerance=0.0), dict(min_obs=0)):
        with pytest.raises(ValueError):
            JW.DriftDetector(**bad)
        with pytest.raises(ValueError):
            TW.DriftDetector(**bad)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_generation_key_is_jax_fold_in(seed):
    for generation in (1, 2, 3, 1000, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                             generation))
        got = R.fold_in(R.PRNGKey(seed), generation).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


# ---- the controller against the reference's ---------------------------------


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_step_retrains_the_drifted_cluster_as_the_reference(roots, driver):
    """Both controllers fed the same reports: the same decisions, clusters,
    generations and manifests; rows and retrained models within
    ``FL_PARITY_TOL``. The port's controller also hot-swaps its server, and
    the retrained model recovers the online RMSE on the drifted data."""
    jspec, tspec = make_specs(driver)
    det = dict(min_obs=2, tolerance=1.05)
    jctl = JW.RetrainController(jspec, roots["jax"],
                                series=roots["series"].copy(),
                                labels=roots["labels"],
                                detector=JW.DriftDetector(**det))
    server = TS.ForecastServer.from_manifest(roots["port"], max_batch=8,
                                             max_wait_ms=1.0, device="cpu")
    tctl = _port_ctl(roots, tspec, server=server,
                     detector=TW.DriftDetector(**det))
    try:
        rep = TS.stream_evaluate(server, tspec.task, series=tctl.series,
                                 max_windows=2)
        for _ in range(3):
            t, j = tctl.step(rep), jctl.step(rep)
            assert t == j == {"drifted": [], "retrained": {}, "generation": 0}
        tail = _inject_drift(tctl.series, tctl.labels, cluster=1)
        assert tctl.append_windows(tail) == jctl.append_windows(tail)
        np.testing.assert_array_equal(tctl.series, jctl.series)
        drifted = TS.stream_evaluate(server, tspec.task, series=tctl.series,
                                     max_windows=2)
        t, j = tctl.step(drifted), jctl.step(drifted)
        assert t["drifted"] == j["drifted"] == [1]
        assert sorted(t["retrained"]) == sorted(j["retrained"]) == [1]
        assert t["generation"] == j["generation"] == 1 == server.generation
        tr, jr = t["retrained"][1], j["retrained"][1]
        for k in ("policy", "cluster", "clients", "rounds", "comm_params",
                  "generation"):
            assert tr[k] == jr[k], k
        np.testing.assert_allclose(tr["rmse"], jr["rmse"], rtol=TOL, atol=TOL)
        assert ("while_run" in tr) == (driver == "while")
        # the manifests, as parsed JSON: equal, norm stats bitwise
        tgen, tman = TT.read_routing_manifest(roots["port"])
        jgen, jman = JT.read_routing_manifest(roots["jax"])
        assert tgen == jgen == 1 and tman == jman
        assert tman["policies"][POLICY] == {"0": f"{POLICY}_c0",
                                            "1": f"{POLICY}_c1_g1"}
        mu0 = np.asarray(TT.read_routing_manifest(roots["port"], 0)[1]
                         ["norm"]["mu"])
        moved = np.asarray(tman["norm"]["mu"]) != mu0
        assert moved[tctl.labels == 1].all()
        assert not moved[tctl.labels == 0].any()
        # the retrained global models
        sub = f"{POLICY}_c1_g1"
        tv, meta = _trained_vec(os.path.join(roots["port"], sub))
        jv, _ = _trained_vec(os.path.join(roots["jax"], sub))
        keep = bk_free(meta)
        np.testing.assert_allclose(tv[keep].numpy(), jv[keep].numpy(),
                                   rtol=TOL, atol=TOL)
        old, _ = _trained_vec(os.path.join(roots["port"], f"{POLICY}_c1"))
        assert not torch.equal(tv, old)
        recovered = TS.stream_evaluate(server, tspec.task, series=tctl.series,
                                       max_windows=2)
        assert (recovered["per_cluster"][1]["rmse"]
                < drifted["per_cluster"][1]["rmse"])
    finally:
        server.close()


def test_cold_start_retrain_matches_reference(roots):
    """``warm_start=False`` trains from the generation key's own init, as
    the reference does; the warm start begins at the live checkpoint, so
    the two differ."""
    jspec, tspec = make_specs()
    jctl = JW.RetrainController(jspec, roots["jax"], series=roots["series"],
                                labels=roots["labels"], warm_start=False)
    cold = _port_ctl(roots, tspec, warm_start=False)
    t, j = cold.retrain([0]), jctl.retrain([0])
    assert t["generation"] == j["generation"] == 1
    assert t["rows"][0]["comm_params"] == j["rows"][0]["comm_params"]
    sub = f"{POLICY}_c0_g1"
    tv, meta = _trained_vec(os.path.join(roots["port"], sub))
    jv, _ = _trained_vec(os.path.join(roots["jax"], sub))
    keep = bk_free(meta)
    np.testing.assert_allclose(tv[keep].numpy(), jv[keep].numpy(), rtol=TOL,
                               atol=TOL)
    warm = _port_ctl(roots, tspec).retrain([0])
    assert warm["generation"] == 2
    wv, _ = _trained_vec(os.path.join(roots["port"], f"{POLICY}_c0_g2"))
    assert not torch.allclose(wv, tv, atol=1e-3)


def test_retrain_validates_inputs(roots):
    ctl = _port_ctl(roots)
    with pytest.raises(ValueError, match="no clusters"):
        ctl.retrain([])
    with pytest.raises(ValueError, match="new observations"):
        ctl.append_windows(np.zeros(7))
    with pytest.raises(ValueError, match="new observations"):
        ctl.append_windows(np.zeros((3, 5)))
    with pytest.raises(KeyError, match="not in the spec grid"):
        _port_ctl(roots, policy="online")
    two = make_specs(grid=(("psgf", {}), ("online", {})))[1]
    with pytest.raises(ValueError, match="pass policy="):
        _port_ctl(roots, two)
    with pytest.raises(FileNotFoundError):
        TW.RetrainController(make_specs()[1], str(roots["port"]) + "_none",
                             series=roots["series"], labels=roots["labels"],
                             device="cpu")
    assert TT.read_routing_manifest(roots["port"])[0] == 0  # nothing published


def test_timer_trigger_periodically_republishes(roots):
    ctl = _port_ctl(roots)
    ctl.start_timer(0.05, clusters=[0])
    assert ctl.start_timer(0.05) is not None     # idempotent
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if TT.read_routing_manifest(roots["port"])[0] >= 1:
                break
            time.sleep(0.05)
    finally:
        ctl.stop_timer()
    gen, manifest = TT.read_routing_manifest(roots["port"])
    assert gen >= 1
    assert manifest["policies"][POLICY]["0"].endswith(f"_g{gen}")
    assert manifest["policies"][POLICY]["1"] == f"{POLICY}_c1"
    assert ctl._timer is None
    ctl.stop_timer()                             # no-op when stopped


# ---- manifests and hot swaps (the reference's cases, on the port) -----------


def test_corrupt_routing_json_falls_back_to_snapshot(roots):
    root = roots["port"]
    with open(os.path.join(root, "routing.json"), "w") as f:
        f.write('{"generation": 0, "torn')   # a legacy in-place torn write
    gen, manifest = TT.read_routing_manifest(root)
    assert gen == 0 and manifest["policies"]


def test_legacy_manifest_without_generation_reads_as_zero(roots):
    root = roots["port"]
    with open(os.path.join(root, "routing.json")) as f:
        manifest = json.load(f)
    del manifest["generation"]
    os.unlink(os.path.join(root, "routing.g000000.json"))
    with open(os.path.join(root, "routing.json"), "w") as f:
        json.dump(manifest, f)
    assert TT.read_routing_manifest(root)[0] == 0
    server = TS.ForecastServer.from_manifest(root, max_batch=4, device="cpu")
    assert server.generation == 0
    server.close()


def test_update_routing_manifest_moves_only_given_clusters(roots):
    root = roots["port"]
    _, before = TT.read_routing_manifest(root)
    gen, _ = TT.update_routing_manifest(root, POLICY, {1: f"{POLICY}_c1_g1"},
                                        station_norm={0: (5.0, 2.0)})
    assert gen == 1
    _, after = TT.read_routing_manifest(root)
    pol = after["policies"][POLICY]
    assert pol["1"] == f"{POLICY}_c1_g1"
    assert pol["0"] == before["policies"][POLICY]["0"]
    assert after["norm"]["mu"][0] == 5.0 and after["norm"]["sd"][0] == 2.0
    assert after["norm"]["mu"][1:] == before["norm"]["mu"][1:]
    with pytest.raises(KeyError):
        TT.update_routing_manifest(root, "nope", {0: "x"})


def test_reload_reuses_unchanged_engines_and_counts_outcomes(roots):
    server = TS.ForecastServer.from_manifest(roots["port"], max_batch=4,
                                             device="cpu")
    try:
        s = parse_exposition(server.metrics_text())
        assert sum_samples(s, "forecast_generation") == 0
        assert server.reload() is False          # nothing newer: stale
        old = dict(server.engines)
        assert _port_ctl(roots).retrain([1])["generation"] == 1
        assert server.reload() is True           # swapped
        assert server.generation == 1
        assert server.engines[1] is not old[1], "retrained cluster rebuilt"
        assert server.engines[0] is old[0], "unchanged cluster engine reused"
        assert server.reload() is False          # stale again
        assert server.stats["reloads"] == 1
        s = parse_exposition(server.metrics_text())
        assert sum_samples(s, "forecast_generation") == 1
        assert sum_samples(s, "forecast_reloads_total", outcome="swapped") == 1
        assert sum_samples(s, "forecast_reloads_total", outcome="stale") == 2
    finally:
        server.close()


def test_reload_warms_the_channels_the_server_warmed(roots):
    """A retrained cluster's new engine is warmed at every channel count the
    server was warmed at, so a request of such a shape after the swap takes
    the buffer built at the warm-up and allocates none."""
    server = TS.ForecastServer.from_manifest(roots["port"], max_batch=4,
                                             device="cpu")
    try:
        server.warmup(channels=3)
        assert _port_ctl(roots, server=server).retrain([1])["generation"] == 1
        engine = server.engines[1]
        assert sorted(engine._free) == [(b, 3) for b in server.buckets]
        built = {k: list(v) for k, v in engine._free.items()}
        x = np.ones((3, TASK["look_back"]), np.float32)
        assert server.predict(x, cluster=1).shape == (3, TASK["horizon"])
        assert sorted(engine._free) == sorted(built)
        assert all(len(engine._free[k]) == 1 and engine._free[k][0] is v[0]
                   for k, v in built.items())
    finally:
        server.close()


def test_retrains_of_two_controllers_on_one_device_never_overlap(
        roots, monkeypatch):
    """Two controllers of one root on one device retrain in two threads at
    once: their ``run_fl`` calls never overlap (the psgf_mix kernel's ticket
    counter is one per device), both generations are published and the
    manifest ends with both clusters' new checkpoints."""
    from repro_torch.core.fl import engine

    run_fl, active, most = engine.run_fl, [0], [0]
    guard = threading.Lock()

    def tracked(*args, **kw):
        with guard:
            active[0] += 1
            most[0] = max(most[0], active[0])
        try:
            time.sleep(0.2)
            return run_fl(*args, **kw)
        finally:
            with guard:
                active[0] -= 1

    monkeypatch.setattr(engine, "run_fl", tracked)
    out, errors = {}, []

    def retrain(c):
        try:
            out[c] = _port_ctl(roots).retrain([c])["generation"]
        except Exception as exc:          # reported below
            errors.append(exc)

    threads = [threading.Thread(target=retrain, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert most[0] == 1
    assert sorted(out.values()) == [1, 2]
    gen, manifest = TT.read_routing_manifest(roots["port"])
    assert gen == 2
    assert manifest["policies"][POLICY] == {
        str(c): f"{POLICY}_c{c}_g{g}" for c, g in out.items()}


def test_swap_under_concurrent_queue_traffic_drops_nothing(roots):
    """A controller attached to a serving server retrains and hot-swaps
    while a thread keeps submitting: every future resolves, each answer is
    the old or the new generation's (batch compositions vary, so each is
    held to one of the two within ``FL_PARITY_TOL``), and the new
    generation is seen."""
    server = TS.ForecastServer.from_manifest(roots["port"], max_batch=4,
                                             max_wait_ms=0.5, device="cpu")
    ctl = _port_ctl(roots, server=server)
    try:
        server.warmup(channels=1)
        x = np.ones((1, TASK["look_back"]), np.float32)
        y_old = server.predict(x, cluster=1)
        server.start()
        futs, stop = [], threading.Event()

        def traffic():
            while not stop.is_set():
                futs.append(server.submit(x, cluster=1))
                time.sleep(0.001)

        t = threading.Thread(target=traffic)
        t.start()
        try:
            res = ctl.retrain([1])               # reloads the server
            time.sleep(0.05)
        finally:
            stop.set()
            t.join()
        ys = [f.result(timeout=60) for f in futs]   # nothing dropped
        assert res["generation"] == server.generation == 1
        y_new = server.predict(x, cluster=1)
        assert not np.allclose(y_old, y_new, atol=1e-3)
        n_old = sum(np.allclose(y, y_old, rtol=TOL, atol=TOL) for y in ys)
        n_new = sum(np.allclose(y, y_new, rtol=TOL, atol=TOL) for y in ys)
        assert n_old + n_new == len(ys) > 0
        assert n_new > 0, "no request ever saw the new generation"
    finally:
        server.close()
