"""Production HTTP front door for :class:`ForecastServer` (counterpart of
``repro.launch.gateway``): a stdlib-only asyncio HTTP/1.1 gateway over the
port's routed server, with the reference's routes, status codes, headers,
JSON bodies and metric names.

  * ``POST /v1/forecast`` — JSON ``{"x": [[...look_back floats...] x M],
    "station": s | "cluster": c, "raw": bool?}`` -> ``{"y": [[...] x M]}``,
    routed like ``ForecastServer.submit``; on a raw-serving server
    (``from_manifest(denormalize=True)``) station-routed requests are RAW
    units and ``"raw": false`` opts one back into normalized units;
  * ``GET /healthz`` — liveness, drain state (503 while draining) and the
    ACTIVE routing-manifest generation, which moves with each hot swap;
  * ``GET /metricz`` — the server registry plus the gateway's metrics in
    Prometheus text format (``repro_torch.launch.metrics``).

Robustness: static bearer-token auth on /v1/forecast (401), a token bucket
per station (429 + ``Retry-After``), bounded admission that sheds overflow
before ``submit`` (503 + ``Retry-After``), a deadline per request (504),
and a graceful drain on stop.

The gateway's event-loop thread does no device work: it hands requests to
the server's queue and awaits their futures; the server's worker runs the
forwards on the server's own CUDA stream.

Thread mode (``start()`` / ``stop()``) hosts the loop on a daemon thread;
in-loop mode (``start_async`` / ``stop_async``) runs in the caller's loop.
:func:`request_json` is the matching stdlib client with keep-alive.

CLI (the card by default; ``--device cpu`` without one)::

  PYTHONPATH=src python -m repro_torch.launch.gateway --manifest ROOT \
      [--device cuda] [--port 8787] [--token SECRET] [--rate-limit 50] \
      [--max-pending 512] [--deadline 10] [--denormalize]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import math
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.launch.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry

_REASONS = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_acquire`` returns 0.0 on admission, else the seconds until the
    next token (the 429's ``Retry-After``). ``clock`` is injectable so the
    refill math is deterministic under test. Only touched from the gateway
    event loop — no lock needed."""

    __slots__ = ("rate", "burst", "tokens", "t", "clock")

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate <= 0 or burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, "
                             f"got {rate}, {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.clock = clock
        self.t = clock()

    def try_acquire(self) -> float:
        now = self.clock()
        self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


@dataclasses.dataclass
class GatewayConfig:
    """Knobs of the robustness layer (all deterministic under test)."""
    host: str = "127.0.0.1"
    port: int = 0                        # 0 = ephemeral, read .address
    auth_token: Optional[str] = None     # None disables auth
    rate_limit: Optional[float] = None   # req/s per station key; None = off
    rate_burst: Optional[float] = None   # bucket capacity; default max(1, rate)
    max_pending: int = 1024              # bounded admission queue
    deadline_s: float = 30.0             # per-request wall budget
    drain_s: float = 10.0                # graceful-shutdown wait
    retry_after_s: float = 1.0           # advertised on 503 sheds
    max_body_bytes: int = 1 << 20        # 413 above this


class ForecastGateway:
    """One asyncio HTTP listener wrapping one (routed) ForecastServer."""

    def __init__(self, server, config: Optional[GatewayConfig] = None, **kw):
        """``kw`` are GatewayConfig field overrides when ``config`` is None
        (``ForecastGateway(server, port=0, auth_token="s3cret")``)."""
        if config is None:
            config = GatewayConfig(**kw)
        elif kw:
            raise ValueError("pass config= OR field overrides, not both")
        self.server = server
        self.config = config
        self.address: Optional[Tuple[str, int]] = None
        self._buckets: Dict[object, TokenBucket] = {}
        self._pending = 0
        self._draining = False
        self._listener: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._thread_stop: Optional[asyncio.Event] = None
        self.drained: Optional[bool] = None  # set by the last stop_async()
        # gateway metrics live in the SERVER registry so /metricz is one
        # self-consistent exposition (own registry if the server opted out)
        self.metrics = getattr(server, "metrics", None) or MetricsRegistry()
        m = self.metrics
        self._m_http = m.counter(
            "gateway_http_requests_total", "HTTP responses by route and code",
            ("route", "code"))
        self._m_shed = m.counter(
            "gateway_shed_total",
            "requests refused before any model dispatch",
            ("reason",))
        self._m_latency = m.histogram(
            "gateway_request_seconds", "admission -> response-written latency",
            ("route",), buckets=DEFAULT_LATENCY_BUCKETS)
        self._m_pending = m.gauge(
            "gateway_pending", "admitted requests awaiting their forecast",
            fn=lambda: float(self._pending))
        self._m_conns = m.gauge(
            "gateway_connections", "open client connections",
            fn=lambda: float(len(self._writers)))

    # ---- lifecycle -------------------------------------------------------
    async def start_async(self):
        """Bind the listener inside the CALLER's event loop; also starts the
        backing server's micro-batching worker."""
        if self._listener is not None:
            return self.address
        self.server.start()
        self._loop = asyncio.get_running_loop()
        self._listener = await asyncio.start_server(
            self._handle_conn, self.config.host, self.config.port)
        sock = self._listener.sockets[0]
        self.address = sock.getsockname()[:2]
        return self.address

    async def stop_async(self, close_server: bool = False):
        """Graceful drain: stop accepting, wait (<= ``drain_s``) for admitted
        requests to resolve, then drop keep-alive connections. With
        ``close_server=True`` the backing ForecastServer is close()d too —
        anything its queue still holds fails loudly instead of hanging."""
        self._draining = True
        if self._listener is not None:
            self._listener.close()
            await self._listener.wait_closed()
            self._listener = None
        deadline = time.monotonic() + self.config.drain_s
        while self._pending > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        self.drained = drained = self._pending == 0
        for w in list(self._writers):
            try:
                w.close()
            except Exception:
                pass
        # let the per-connection handlers observe their closed transports and
        # unwind before the loop dies (avoids destroyed-pending-task noise)
        others = [t for t in asyncio.all_tasks()
                  if t is not asyncio.current_task()]
        if others:
            await asyncio.wait(others, timeout=1.0)
        if close_server:
            self.server.close()
        return drained

    def start(self) -> Tuple[str, int]:
        """Host the gateway on a daemon thread with its own event loop;
        returns the bound (host, port). Idempotent."""
        if self._thread is not None:
            return self.address
        started = threading.Event()
        boot_err: list = []

        def _run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def _main():
                self._thread_stop = asyncio.Event()
                try:
                    await self.start_async()
                except Exception as exc:  # e.g. port already bound
                    boot_err.append(exc)
                    return
                finally:
                    started.set()
                await self._thread_stop.wait()
                await self.stop_async(close_server=self._close_server_on_stop)

            try:
                loop.run_until_complete(_main())
            finally:
                loop.close()

        self._close_server_on_stop = False
        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="forecast-gateway")
        self._thread.start()
        started.wait(timeout=30)
        if boot_err:
            self._thread.join()
            self._thread = None
            raise boot_err[0]
        if self.address is None:
            raise RuntimeError("gateway failed to start within 30s")
        return self.address

    def stop(self, close_server: bool = False, timeout: float = 60.0):
        """Stop a thread-hosted gateway (drains, see ``stop_async``)."""
        if self._thread is None:
            return
        self._close_server_on_stop = close_server
        self._loop.call_soon_threadsafe(self._thread_stop.set)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("gateway thread did not stop")
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ---- HTTP plumbing ---------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                req = await self._read_request(reader, writer)
                if req is None:
                    break
                method, path, headers, body = req
                t0 = time.perf_counter()
                route, keep = await self._dispatch(
                    method, path, headers, body, writer)
                self._m_latency.labels(route).observe(
                    time.perf_counter() - t0)
                if not keep or headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader, writer):
        """One HTTP/1.1 request -> (method, path, headers, body), or None on
        EOF / unrecoverable framing error (connection closes)."""
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            await self._respond(writer, 400, {"error": "malformed request line"},
                                route="_bad", keep=False)
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n"):
                break
            if not h:
                return None
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
            if len(headers) > 100:
                await self._respond(writer, 400, {"error": "too many headers"},
                                    route="_bad", keep=False)
                return None
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            await self._respond(writer, 400,
                                {"error": "bad Content-Length"},
                                route="_bad", keep=False)
            return None
        if length > self.config.max_body_bytes:
            await self._respond(writer, 413, {"error": "body too large"},
                                route="_bad", keep=False)
            return None
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _respond(self, writer, code: int, payload, *, route: str,
                       content_type: str = "application/json",
                       extra_headers: Tuple[Tuple[str, str], ...] = (),
                       keep: bool = True) -> Tuple[str, bool]:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                + "".join(f"{k}: {v}\r\n" for k, v in extra_headers)
                + "\r\n")
        writer.write(head.encode("latin1") + body)
        self._m_http.labels(route, str(code)).inc()
        try:
            await writer.drain()
        except ConnectionError:
            return route, False
        return route, keep

    # ---- routes ----------------------------------------------------------
    async def _dispatch(self, method, path, headers, body, writer):
        if path == "/healthz" and method == "GET":
            code = 503 if self._draining else 200
            return await self._respond(writer, code, {
                "status": "draining" if self._draining else "ok",
                "clusters": len(self.server.engines),
                "generation": getattr(self.server, "generation", None),
                "process_shard": getattr(self.server, "process_shard", None),
                "pending": self._pending,
            }, route="healthz")
        if path == "/metricz" and method == "GET":
            return await self._respond(
                writer, 200, self.metrics.expose().encode(),
                route="metricz", content_type=PROMETHEUS_CONTENT_TYPE)
        if path == "/v1/forecast":
            if method != "POST":
                return await self._respond(
                    writer, 405, {"error": "POST only"}, route="forecast",
                    extra_headers=(("Allow", "POST"),))
            return await self._forecast(headers, body, writer)
        return await self._respond(writer, 404, {"error": f"no route {path}"},
                                   route="_unknown")

    def _authorized(self, headers) -> bool:
        token = self.config.auth_token
        if token is None:
            return True
        return headers.get("authorization", "") == f"Bearer {token}"

    def _rate_check(self, key) -> float:
        """0.0 = admitted; else seconds until the station's next token."""
        if self.config.rate_limit is None:
            return 0.0
        bucket = self._buckets.get(key)
        if bucket is None:
            burst = self.config.rate_burst or max(1.0, self.config.rate_limit)
            bucket = self._buckets.setdefault(
                key, TokenBucket(self.config.rate_limit, burst))
        return bucket.try_acquire()

    async def _forecast(self, headers, body, writer):
        route = "forecast"
        if not self._authorized(headers):
            return await self._respond(
                writer, 401, {"error": "missing or invalid bearer token"},
                route=route,
                extra_headers=(("WWW-Authenticate", "Bearer"),))
        if self._draining:
            self._m_shed.labels("draining").inc()
            return await self._respond(
                writer, 503, {"error": "draining"}, route=route,
                extra_headers=(("Retry-After",
                                f"{self.config.retry_after_s:g}"),))
        try:
            req = json.loads(body)
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            x = req["x"]
            station = req.get("station")
            cluster = req.get("cluster")
            raw = req.get("raw")
            if station is not None:
                station = int(station)
            if cluster is not None:
                cluster = int(cluster)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            return await self._respond(
                writer, 400, {"error": f"invalid JSON: {exc}"}, route=route)
        except (KeyError, TypeError, ValueError) as exc:
            return await self._respond(
                writer, 400, {"error": f"bad request body: {exc!r}"},
                route=route)
        # raw-units contract mirrors ForecastServer: station-routed requests
        # on a raw-serving server are raw; {"raw": false} opts out by
        # resolving the cluster HERE (stream_evaluate's trick); {"raw": true}
        # on a non-raw server is a loud client error.
        if raw and self.server.station_norm is None:
            return await self._respond(
                writer, 400,
                {"error": "server is not raw-serving "
                          "(no norm stats restored)"}, route=route)
        if (raw is False and station is not None and cluster is None
                and self.server.station_norm is not None):
            try:
                cluster = self.server.resolve_cluster(station=station)
                station = None
            except (KeyError, ValueError) as exc:
                self._m_shed.labels("unroutable").inc()
                return await self._respond(
                    writer, 404, {"error": str(exc)}, route=route)
        wait_s = self._rate_check("_global" if station is None else station)
        if wait_s > 0.0:
            self._m_shed.labels("rate_limit").inc()
            return await self._respond(
                writer, 429, {"error": "rate limit exceeded"}, route=route,
                extra_headers=(("Retry-After", f"{math.ceil(wait_s)}"),))
        if self._pending >= self.config.max_pending:
            # load shedding BEFORE submit: a shed request never consumes a
            # model dispatch and the admission queue depth stays bounded
            self._m_shed.labels("queue_full").inc()
            return await self._respond(
                writer, 503, {"error": "admission queue full"}, route=route,
                extra_headers=(("Retry-After",
                                f"{self.config.retry_after_s:g}"),))
        self._pending += 1
        try:
            fut = self.server.submit(x, station=station, cluster=cluster)
            wrapped = asyncio.wrap_future(fut, loop=self._loop)
            try:
                # shield: a deadline must fail THIS response, not cancel the
                # shared future mid-coalesce (the worker discards the late
                # result via _safe_set either way)
                y = await asyncio.wait_for(asyncio.shield(wrapped),
                                           self.config.deadline_s)
            except asyncio.TimeoutError:
                self._m_shed.labels("deadline").inc()
                return await self._respond(
                    writer, 504,
                    {"error": f"deadline {self.config.deadline_s}s exceeded"},
                    route=route)
            except KeyError as exc:      # unroutable station/cluster
                self._m_shed.labels("unroutable").inc()
                return await self._respond(
                    writer, 404, {"error": str(exc)}, route=route)
            except (ValueError, TypeError) as exc:   # malformed payload
                return await self._respond(
                    writer, 400, {"error": str(exc)}, route=route)
            except RuntimeError as exc:  # server closed under us
                return await self._respond(
                    writer, 503, {"error": str(exc)}, route=route,
                    extra_headers=(("Retry-After",
                                    f"{self.config.retry_after_s:g}"),))
        finally:
            self._pending -= 1
        if cluster is None and station is not None:
            try:  # informational only: report where the request was routed
                cluster = self.server.resolve_cluster(station=station)
            except (KeyError, ValueError):
                pass
        return await self._respond(writer, 200, {
            "y": np.asarray(y).tolist(),
            "station": station, "cluster": cluster,
            "raw": bool(self.server.station_norm is not None
                        and station is not None),
        }, route=route)


# ---- stdlib client helper ---------------------------------------------------


def request_json(host: str, port: int, method: str, path: str,
                 body: Optional[dict] = None, token: Optional[str] = None,
                 timeout: float = 30.0, conn=None):
    """One HTTP request via stdlib ``http.client``; returns
    ``(status, headers_dict, parsed_body)`` (JSON-decoded when the response
    is JSON, raw text otherwise). Pass an ``http.client.HTTPConnection`` as
    ``conn`` for keep-alive loops (one connection per closed-loop client)."""
    import http.client

    own = conn is None
    if own:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
    payload = None if body is None else json.dumps(body)
    hdrs = {"Content-Type": "application/json"}
    if token is not None:
        hdrs["Authorization"] = f"Bearer {token}"
    conn.request(method, path, body=payload, headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    headers = {k.lower(): v for k, v in resp.getheaders()}
    if headers.get("content-type", "").startswith("application/json"):
        out = json.loads(data) if data else None
    else:
        out = data.decode()
    if own:
        conn.close()
    return resp.status, headers, out


def main(argv: Optional[Sequence[str]] = None):
    from repro_torch.launch.serve_forecast import ForecastServer

    ap = argparse.ArgumentParser(
        description="HTTP gateway over a restored ForecastServer")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt-dir", help="single-model checkpoint dir")
    src.add_argument("--manifest", help="routing-manifest experiment root")
    ap.add_argument("--policy", default=None)
    ap.add_argument("--comm-bits", type=int, default=32, choices=(8, 16, 32),
                    help="restore payload width: 16 = bf16, 8 = int8 + "
                         "per-leaf scale (validated at the CLI)")
    ap.add_argument("--denormalize", action="store_true",
                    help="raw-unit station-routed serving (--manifest only)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; fails without a GPU)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--token", default=None, help="static bearer token")
    ap.add_argument("--rate-limit", type=float, default=None,
                    help="per-station requests/sec")
    ap.add_argument("--max-pending", type=int, default=1024)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    args = ap.parse_args(argv)

    kw = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
              device=args.device)
    if args.manifest:
        server = ForecastServer.from_manifest(
            args.manifest, policy=args.policy, comm_bits=args.comm_bits,
            denormalize=args.denormalize, **kw)
    else:
        server = ForecastServer.from_checkpoint(
            args.ckpt_dir, comm_bits=args.comm_bits, **kw)
    gw = ForecastGateway(server, host=args.host, port=args.port,
                         auth_token=args.token, rate_limit=args.rate_limit,
                         max_pending=args.max_pending,
                         deadline_s=args.deadline)
    host, port = gw.start()
    print(f"forecast gateway on http://{host}:{port} "
          f"({len(server.engines)} cluster engines on {server.device}; "
          f"auth={'on' if args.token else 'off'}) — Ctrl-C to drain & stop",
          flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    gw.stop(close_server=True)
    print("gateway drained and stopped", flush=True)


if __name__ == "__main__":
    main()
