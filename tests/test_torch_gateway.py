"""The port's HTTP gateway against the JAX package's, on the CPU.

Two gateways, one over the reference's ``ForecastServer`` and one over the
port's (``device="cpu"``), serve the same two-cluster LoGTST weights (drawn
with numpy). The same requests get the same status codes, headers and JSON
bodies (bitwise) and forecasts within ``PORT_PARITY_TOL`` (1e-5). Then the
reference's ``tests/test_gateway.py`` cases on the port: auth, rate limit,
shedding, deadlines, the raw-units contract, concurrent keep-alive clients
with ``/metricz`` reconciled to the traffic, drain, and the CLI.
"""
import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.forecaster import get_forecaster as jax_forecaster  # noqa: E402
from repro.launch import gateway as JG  # noqa: E402
from repro.launch.serve_forecast import ForecastServer as JaxServer  # noqa: E402
from repro_torch.core.forecast import PORT_PARITY_TOL  # noqa: E402
from repro_torch.core.forecaster import (get_forecaster,  # noqa: E402
                                         params_from_numpy, save_forecaster)
from repro_torch.core.tasks import get_task, write_routing_manifest  # noqa: E402
from repro_torch.launch.gateway import (ForecastGateway, GatewayConfig,  # noqa: E402
                                        TokenBucket, request_json)
from repro_torch.launch.metrics import parse_exposition, sum_samples  # noqa: E402
from repro_torch.launch.serve_forecast import ForecastServer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = PORT_PARITY_TOL
TINY = dict(look_back=16, horizon=2, d_model=16, num_heads=2, d_ff=16,
            patch_len=8, stride=4)
TOKEN = "s3cret-token"
L = TINY["look_back"]
STATIONS = [0, 1, 0, 1, 0, 1]


def _numpy_params(seed):
    """One cluster's weights, drawn with numpy at the reference's shapes."""
    fc = jax_forecaster("logtst", **TINY)
    shapes = jax.eval_shape(fc.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(s.dtype), shapes)


PARAMS = [_numpy_params(0), _numpy_params(1)]


def _port_server(station_norm=None, stations=STATIONS, **kw):
    fc = get_forecaster("logtst", **TINY)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 1.0)
    return ForecastServer(
        models={c: (fc, params_from_numpy(p, device="cpu"))
                for c, p in enumerate(PARAMS)},
        station_cluster=stations, station_norm=station_norm, device="cpu",
        **kw)


def _jax_server(station_norm=None, stations=STATIONS):
    fc = jax_forecaster("logtst", **TINY)
    return JaxServer(
        models={c: (fc, jax.tree_util.tree_map(jax.numpy.asarray, p))
                for c, p in enumerate(PARAMS)},
        station_cluster=stations, station_norm=station_norm, max_batch=4,
        max_wait_ms=1.0)


@pytest.fixture(scope="module")
def both():
    """A warmed, authed gateway over each package's server."""
    out = {}
    for name, server, Gateway in (("port", _port_server(), ForecastGateway),
                                  ("jax", _jax_server(), JG.ForecastGateway)):
        server.warmup(channels=1)
        gw = Gateway(server, auth_token=TOKEN, max_pending=64, deadline_s=30.0)
        gw.start()
        out[name] = gw
    yield out
    for gw in out.values():
        gw.stop(close_server=True)


@pytest.fixture(scope="module")
def gw(both):
    return both["port"]


def _post(gw, body, token=TOKEN, **kw):
    host, port = gw.address
    return request_json(host, port, "POST", "/v1/forecast", body,
                        token=token, **kw)


def _raw_post(gw, text, token=TOKEN):
    """A POST whose body is sent as given (not JSON-encoded)."""
    conn = http.client.HTTPConnection(*gw.address, timeout=30)
    conn.request("POST", "/v1/forecast", body=text,
                 headers={"Authorization": f"Bearer {token}",
                          "Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, {k.lower(): v for k, v in resp.getheaders()},
           json.loads(resp.read()))
    conn.close()
    return out


# ---- the same requests, the same answers -----------------------------------

X = np.linspace(-1, 1, L, dtype=np.float32)[None]
X3 = np.random.default_rng(3).standard_normal((3, L)).astype(np.float32)
REQUESTS = [
    ("GET", "/healthz", None, None),
    ("GET", "/nope", None, None),
    ("GET", "/v1/forecast", None, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": 0}, None),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": 0}, "wrong"),
    ("POST", "/v1/forecast", {"station": 0}, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * (L + 3)], "station": 0}, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L, [0.0] * 3], "station": 0}, TOKEN),
    ("POST", "/v1/forecast", [1, 2, 3], TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": 999}, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "cluster": 7}, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": "abc"}, TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": 0, "raw": True},
     TOKEN),
    ("POST", "/v1/forecast", {"x": [[0.0] * L], "station": 0}, TOKEN),
] + [("POST", "/v1/forecast", {"x": X.tolist(), "station": s}, TOKEN)
     for s in range(6)] + [
    ("POST", "/v1/forecast", {"x": X3.tolist(), "cluster": c}, TOKEN)
    for c in (0, 1)]
HEADERS = ("content-type", "connection", "www-authenticate", "allow",
           "retry-after")


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_same_responses_as_reference(both, i):
    method, path, body, token = REQUESTS[i]
    got, want = [request_json(*both[k].address, method, path, body,
                              token=token) for k in ("port", "jax")]
    assert got[0] == want[0]
    assert ({h: got[1].get(h) for h in HEADERS}
            == {h: want[1].get(h) for h in HEADERS})
    if got[0] == 200 and "y" in want[2]:
        y, y_want = got[2].pop("y"), want[2].pop("y")
        np.testing.assert_allclose(np.asarray(y, np.float32),
                                   np.asarray(y_want, np.float32),
                                   rtol=TOL, atol=TOL)
    if path == "/healthz":
        got[2].pop("pending"), want[2].pop("pending")
    assert got[2] == want[2]


def test_malformed_json_400_same_as_reference_and_worker_unpoisoned(both):
    got, want = (_raw_post(both[k], "{definitely not json")
                 for k in ("port", "jax"))
    assert got[0] == want[0] == 400
    assert got[2] == want[2] and "invalid JSON" in got[2]["error"]
    assert _post(both["port"], {"x": [[0.0] * L], "station": 0})[0] == 200


def test_forecast_routes_and_matches_inprocess(gw):
    for station in range(6):
        status, _, body = _post(gw, {"x": X.tolist(), "station": station})
        assert status == 200, body
        assert body["cluster"] == STATIONS[station]
        ref = gw.server.predict(X, cluster=STATIONS[station])
        np.testing.assert_array_equal(np.asarray(body["y"], np.float32), ref)
    s0, _, b0 = _post(gw, {"x": X.tolist(), "cluster": 0})
    s1, _, b1 = _post(gw, {"x": X.tolist(), "cluster": 1})
    assert s0 == s1 == 200
    assert not np.allclose(b0["y"], b1["y"])


def test_healthz_and_metricz_unauthenticated(both):
    host, port = both["port"].address
    status, _, health = request_json(host, port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["clusters"] == 2 and health["generation"] == 0
    status, headers, text = request_json(host, port, "GET", "/metricz")
    assert status == 200 and headers["content-type"].startswith("text/plain")

    def families(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}
    want = request_json(*both["jax"].address, "GET", "/metricz")[2]
    assert families(text) == families(want)


# ---- the robustness layer on the port ---------------------------------------


def test_token_bucket_deterministic():
    t = {"now": 0.0}
    b = TokenBucket(rate=2.0, burst=3, clock=lambda: t["now"])
    assert [b.try_acquire() for _ in range(3)] == [0.0, 0.0, 0.0]
    assert b.try_acquire() == pytest.approx(0.5)
    t["now"] += 0.5                 # one token refilled (2/s * 0.5s)
    assert b.try_acquire() == 0.0
    assert b.try_acquire() > 0.0
    t["now"] += 10.0                # refill clamps at burst
    b.try_acquire()
    assert b.tokens <= b.burst
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1)
    with pytest.raises(ValueError):
        ForecastGateway(None, config=GatewayConfig(), port=0)


def test_rate_limit_breach_429():
    server = _port_server()
    server.warmup(channels=1)
    with ForecastGateway(server, auth_token=TOKEN, rate_limit=0.001,
                         rate_burst=2) as gw:
        body = {"x": [[0.0] * L], "station": 0}
        assert _post(gw, body)[0] == 200
        assert _post(gw, body)[0] == 200
        status, headers, _ = _post(gw, body)
        assert status == 429
        assert float(headers["retry-after"]) >= 1
        assert _post(gw, {"x": [[0.0] * L], "station": 1})[0] == 200
        s = parse_exposition(request_json(*gw.address, "GET", "/metricz")[2])
        assert sum_samples(s, "gateway_shed_total", reason="rate_limit") == 1
    server.close()


def test_queue_overflow_503_sheds_before_dispatch():
    """With the worker paused, admitted requests pile up at max_pending;
    the rest are shed with 503 + Retry-After before any model dispatch."""
    server = _port_server()
    server.warmup(channels=1)
    gw = ForecastGateway(server, auth_token=TOKEN, max_pending=2,
                         deadline_s=2.0, retry_after_s=3.0)
    with gw:
        server.stop()               # stall the backend: futures never resolve
        batches_before = server.stats["batches"]
        results = []

        def one():
            results.append(_post(gw, {"x": [[0.0] * L], "station": 0},
                                 timeout=30))

        threads = [threading.Thread(target=one) for _ in range(5)]
        for t in threads:
            t.start()
            time.sleep(0.05)        # deterministic arrival order
        for t in threads:
            t.join()
        assert sorted(r[0] for r in results) == [503, 503, 503, 504, 504]
        assert all(r[1].get("retry-after") == "3" for r in results
                   if r[0] == 503)
        assert server.stats["batches"] == batches_before
        assert server._queue.qsize() <= 2
        s = parse_exposition(request_json(*gw.address, "GET", "/metricz")[2])
        assert sum_samples(s, "gateway_shed_total", reason="queue_full") == 3
        assert sum_samples(s, "gateway_shed_total", reason="deadline") == 2
        server.start()              # resume so drain is clean
    server.close()


def test_raw_flag_contract_matches_reference():
    """raw=true on a non-raw server is a client error; on a raw-serving
    server station-routed requests are raw by default and raw=false opts
    back into normalized units; both within 1e-5 of the reference."""
    norm = (np.full(4, 5.0, np.float32), np.full(4, 2.0, np.float32))
    port, ref = (_port_server(norm, [0, 1, 0, 1]),
                 _jax_server(norm, [0, 1, 0, 1]))
    port.warmup(channels=1)
    x_raw = (np.linspace(-1, 1, L, dtype=np.float32) * 2 + 5)[None]
    x_norm = (x_raw - 5.0) / 2.0
    with ForecastGateway(port, auth_token=TOKEN) as gw:
        status, _, body = _post(gw, {"x": x_raw.tolist(), "station": 0})
        assert status == 200 and body["raw"] is True
        y = np.asarray(body["y"], np.float32)
        np.testing.assert_allclose(y, port.predict(x_raw, station=0), rtol=1e-6)
        np.testing.assert_allclose(y, ref.predict(x_raw, station=0),
                                   rtol=TOL, atol=TOL)
        status, _, body = _post(gw, {"x": x_norm.tolist(), "station": 0,
                                     "raw": False})
        assert status == 200 and body["raw"] is False and body["cluster"] == 0
        np.testing.assert_allclose(np.asarray(body["y"], np.float32),
                                   ref.predict(x_norm, cluster=0),
                                   rtol=TOL, atol=TOL)
        status, _, body = _post(gw, {"x": x_norm.tolist(), "station": 9,
                                     "raw": False})
        assert status == 404 and "unknown station" in body["error"]
    port.close()
    ref.close()


def test_concurrent_clients_all_served_and_metrics_reconcile():
    """8 keep-alive clients at once. Each answer comes from a coalesced
    bucket of whatever size the queue made, so it is held to the reference
    server's forecast within ``PORT_PARITY_TOL`` in both atol and rtol: the
    reference's own test compares buckets of other sizes at atol 0 and is
    flaky, because outputs near 0 then differ by more than rtol alone
    allows when the batch shape changes the summation order."""
    server, ref = _port_server(), _jax_server()
    server.warmup(channels=1)
    with ForecastGateway(server, auth_token=TOKEN, max_pending=256) as gw:
        CLIENTS, PER = 8, 12
        errors, answers = [], []

        def client(i):
            host, port = gw.address
            conn = http.client.HTTPConnection(host, port, timeout=60)
            rng = np.random.default_rng(i)
            try:
                for _ in range(PER):
                    s = int(rng.integers(0, 6))
                    x = rng.standard_normal((1, L)).astype(np.float32)
                    status, _, body = request_json(
                        host, port, "POST", "/v1/forecast",
                        {"x": x.tolist(), "station": s}, token=TOKEN,
                        conn=conn)
                    if status != 200:
                        errors.append((status, body))
                    else:
                        answers.append((x, s, body["y"]))
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]
        assert len(answers) == CLIENTS * PER
        xs = np.stack([x for x, _, _ in answers])
        for c in (0, 1):
            idx = [i for i, (_, s, _) in enumerate(answers)
                   if STATIONS[s] == c]
            want = ref.predict(xs[idx], cluster=c)
            got = np.asarray([answers[i][2] for i in idx], np.float32)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        status, headers, text = request_json(*gw.address, "GET", "/metricz")
        assert status == 200
        s = parse_exposition(text)
        n = CLIENTS * PER
        assert sum_samples(s, "gateway_http_requests_total", route="forecast",
                           code="200") == n
        assert sum_samples(s, "forecast_requests_total") == n
        assert sum_samples(s, "forecast_latency_seconds_count") == n
        assert sum_samples(s, "gateway_request_seconds_count",
                           route="forecast") == n
        assert sum_samples(s, "forecast_batch_fill_count") \
            == sum_samples(s, "forecast_batches_total")
        assert sum_samples(s, "forecast_series_served_total") \
            == server.stats["series_served"]
    server.close()
    ref.close()


def test_graceful_drain_on_stop():
    server = _port_server()
    server.warmup(channels=1)
    gw = ForecastGateway(server, auth_token=TOKEN, drain_s=5.0)
    host, port = gw.start()
    assert _post(gw, {"x": [[0.0] * L], "station": 0})[0] == 200
    gw.stop(close_server=True)
    assert server._closed and gw.drained is True
    with pytest.raises(OSError):
        request_json(host, port, "GET", "/healthz", timeout=2)
    with pytest.raises(RuntimeError, match="closed"):
        ForecastGateway(server, auth_token=TOKEN).start()


def test_start_stop_idempotent_and_in_loop_mode():
    server = _port_server()
    gw = ForecastGateway(server, auth_token=TOKEN)
    a = gw.start()
    assert gw.start() == a          # second start: same address, no rebind
    gw.stop()
    gw.stop()                       # second stop: no-op

    async def in_loop():
        g = ForecastGateway(server, auth_token=TOKEN)
        host, port = await g.start_async()
        status = await asyncio.get_running_loop().run_in_executor(
            None, lambda: _post(g, {"x": [[0.0] * L], "station": 1})[0])
        return status, await g.stop_async()

    assert asyncio.run(in_loop()) == (200, True)
    server.close()


def test_cli_serves_a_manifest_and_drains_on_interrupt(tmp_path):
    """``python -m repro_torch.launch.gateway --device cpu``: serves the
    manifest's generation, then drains and stops on SIGINT."""
    fc = get_forecaster("logtst", **TINY)
    root = str(tmp_path)
    for c, p in enumerate(PARAMS):
        save_forecaster(os.path.join(root, f"psgf_c{c}"), fc,
                        params_from_numpy(p, device="cpu"))
    write_routing_manifest(root, get_task("ev", look_back=L), fc,
                           np.asarray(STATIONS),
                           [{"policy": "psgf", "cluster": c} for c in (0, 1)])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--manifest",
         root, "--device", "cpu", "--port", "0", "--token", TOKEN],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "forecast gateway on http://" in line, proc.stderr.read()
        host, port = line.split("http://")[1].split()[0].rsplit(":", 1)
        status, _, health = request_json(host, int(port), "GET", "/healthz")
        assert status == 200 and health["generation"] == 0
        status, _, body = request_json(host, int(port), "POST", "/v1/forecast",
                                       {"x": X.tolist(), "station": 1},
                                       token=TOKEN)
        assert status == 200 and body["cluster"] == 1
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "drained and stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
