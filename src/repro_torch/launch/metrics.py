"""Prometheus-style serving metrics: counters, gauges, histograms.

A stdlib-only copy of ``repro.launch.metrics``, the same metric names and
exposition format, so dashboards read either package's servers alike.

The serving stack (the ``ForecastServer`` worker loop, and the reference's
HTTP gateway) records everything observability needs — submit ->
result latency percentiles, per-(cluster, shape) batch fill and padded-slot
waste, per-cluster request counts, shed/unroutable/error tallies — through
this ONE registry, and ``GET /metricz`` serves the whole thing in Prometheus
text exposition format (``text/plain; version=0.0.4``).

Design constraints, in order:

  * HOT-PATH CHEAP. ``Counter.inc`` / ``Histogram.observe`` sit on the
    serving queue's per-request path, so a recording is one dict lookup
    (lock-free on the hit path — label children are cached and never
    removed) plus one tiny per-child lock around the float bump. No string
    formatting, no allocation, no global registry lock after creation.
    Exposition (`expose`) is the slow path and takes the locks per child.
  * STDLIB ONLY. No prometheus_client dependency — the text format is
    simple enough to emit (and parse: :func:`parse_exposition` is both the
    test-side validator and the benchmark's reconciliation reader).
  * Histograms are CUMULATIVE le-buckets exactly like Prometheus: an
    observation lands in every bucket whose upper bound >= value, plus
    ``_sum``/``_count`` series, so p50/p95/p99 can be estimated the standard
    way (:func:`quantile_from_buckets`).

Usage::

    reg = MetricsRegistry()
    lat = reg.histogram("forecast_latency_seconds", "submit->result latency",
                        ("cluster",), buckets=DEFAULT_LATENCY_BUCKETS)
    lat.labels("0").observe(0.0032)           # hot path
    text = reg.expose()                       # GET /metricz body
    parse_exposition(text)                    # {(name, labels): value}
"""
from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, Optional, Sequence, Tuple

_INF = float("inf")

# submit->result latencies on the micro-batching queue span ~100us (hot
# bucket dispatch) to seconds (cold compile / overload), so the default grid
# is log-spaced across exactly that range.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str):
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")


def escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _CounterChild:
    """One labeled counter series. ``inc`` is the hot path."""
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def get(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_value", "_lock", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self._lock = threading.Lock()
        self._fn = fn

    def set(self, value: float):
        if self._fn is not None:
            raise ValueError("function gauge: value comes from the callback")
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def get(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value


class _HistogramChild:
    """Cumulative le-bucket histogram series."""
    __slots__ = ("_bounds", "_counts", "_sum", "_lock")

    def __init__(self, bounds: Tuple[float, ...]):
        self._bounds = bounds            # strictly increasing, no +Inf
        self._counts = [0] * (len(bounds) + 1)   # [..., overflow (+Inf)]
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float):
        i = bisect_left(self._bounds, value)     # first bound >= value
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def get(self):
        """(cumulative_counts_per_le_bucket_incl_inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total = self._sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total, acc


class _MetricFamily:
    """Shared labels() machinery: children are cached per label-values tuple
    and never removed, so the hit path is one lock-free dict get."""

    kind = ""
    _child_args: tuple = ()

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        _check_name(name)
        for l in label_names:
            _check_name(l)
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    def _default_child(self):
        """The unlabeled series of a label-less family."""
        if self.label_names:
            raise ValueError(f"{self.name} has labels {self.label_names}; "
                             "use .labels(...)")
        return self.labels()

    def samples(self):
        """[(label_values, child)] sorted for stable exposition."""
        with self._lock:
            items = sorted(self._children.items())
        return items

    def _series_name(self, values: Tuple[str, ...], suffix: str = "",
                     extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = tuple(zip(self.label_names, values)) + extra
        if not pairs:
            return self.name + suffix
        inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in pairs)
        return f"{self.name}{suffix}{{{inner}}}"


class Counter(_MetricFamily):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def get(self, *values) -> float:
        return self.labels(*values).get()

    def expose_lines(self):
        for values, child in self.samples():
            yield f"{self._series_name(values)} {format_value(child.get())}"


class Gauge(_MetricFamily):
    kind = "gauge"

    def __init__(self, name, help, label_names=(),
                 fn: Optional[Callable[[], float]] = None):
        if fn is not None and label_names:
            raise ValueError("function gauges are label-less")
        super().__init__(name, help, label_names)
        self._fn = fn
        if fn is not None:
            self._children[()] = _GaugeChild(fn)

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float):
        self._default_child().set(value)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default_child().dec(amount)

    def get(self, *values) -> float:
        return self.labels(*values).get()

    def expose_lines(self):
        for values, child in self.samples():
            yield f"{self._series_name(values)} {format_value(child.get())}"


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name, help, label_names=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, label_names)
        bounds = tuple(float(b) for b in buckets if b != _INF)
        if not bounds or any(b >= c for b, c in zip(bounds, bounds[1:])):
            raise ValueError(f"buckets must be strictly increasing: {buckets}")
        self.bounds = bounds

    def _make_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, value: float):
        self._default_child().observe(value)

    def get(self, *values):
        return self.labels(*values).get()

    def expose_lines(self):
        for values, child in self.samples():
            cum, total, count = child.get()
            for bound, c in zip(self.bounds + (_INF,), cum):
                le = (("le", format_value(bound)),)
                yield (f"{self._series_name(values, '_bucket', le)} {c}")
            yield f"{self._series_name(values, '_sum')} {format_value(total)}"
            yield f"{self._series_name(values, '_count')} {count}"


class MetricsRegistry:
    """Create-once metric families + the ``/metricz`` exposition.

    ``counter``/``gauge``/``histogram`` are idempotent: re-declaring the same
    (name, kind, labels) returns the existing family (so the gateway can
    attach to a server's registry without coordination), while a conflicting
    re-declaration raises.
    """

    def __init__(self):
        self._metrics: Dict[str, _MetricFamily] = {}
        self._lock = threading.Lock()

    def _declare(self, cls, name, help, label_names, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (existing.kind != cls.kind
                        or existing.label_names != tuple(label_names)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}")
                return existing
            fam = cls(name, help, label_names, **kw)
            self._metrics[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str, labels: Sequence[str] = (),
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._declare(Gauge, name, help, labels, fn=fn)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def families(self):
        with self._lock:
            return list(self._metrics.values())

    def expose(self) -> str:
        """The full registry in Prometheus text exposition format."""
        out = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            out.extend(fam.expose_lines())
        return "\n".join(out) + "\n"


# ---- exposition parsing (tests + benchmark reconciliation) -------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")


def _parse_number(s: str) -> float:
    if s == "+Inf":
        return _INF
    if s == "-Inf":
        return -_INF
    return float(s)  # 'NaN' parses; anything else raises ValueError


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                        float]:
    """Parse (and thereby VALIDATE) Prometheus text exposition.

    Returns ``{(series_name, ((label, value), ...)): sample_value}`` with the
    label pairs sorted. Raises ``ValueError`` on any malformed line, unknown
    comment, or a sample whose metric family was never TYPE-declared — the
    test suite uses this as the format checker.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    typed: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {ln}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    raise ValueError(f"line {ln}: bad TYPE {parts[3]!r}")
                typed[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, raw_labels = m.group("name"), m.group("labels")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            raise ValueError(f"line {ln}: sample {name!r} without TYPE")
        labels = []
        if raw_labels:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw_labels):
                labels.append((lm.group(1), _unescape(lm.group(2))))
                consumed = lm.end()
            rest = raw_labels[consumed:].strip(", ")
            if rest:
                raise ValueError(f"line {ln}: malformed labels {raw_labels!r}")
        key = (name, tuple(sorted(labels)))
        if key in out:
            raise ValueError(f"line {ln}: duplicate series {key}")
        out[key] = _parse_number(m.group("value"))
    return out


def sum_samples(samples: Dict, name: str, **match: str) -> float:
    """Sum every sample of ``name`` whose labels include ``match`` — the
    reconciliation helper ('requests_total across all clusters == N')."""
    want = set(match.items())
    return sum(v for (n, labels), v in samples.items()
               if n == name and want <= set(labels))


def quantile_from_buckets(cum: Sequence[float], bounds: Sequence[float],
                          q: float) -> float:
    """Standard Prometheus-style quantile estimate from a cumulative
    le-bucket histogram (linear interpolation within the winning bucket;
    the overflow bucket clamps to the largest finite bound)."""
    total = cum[-1]
    if total <= 0:
        return float("nan")
    rank = q * total
    lo_bound, lo_cum = 0.0, 0.0
    for bound, c in zip(tuple(bounds) + (_INF,), cum):
        if c >= rank:
            if bound == _INF:
                return float(bounds[-1])
            if c == lo_cum:
                return float(bound)
            return lo_bound + (bound - lo_bound) * (rank - lo_cum) / (c - lo_cum)
        lo_bound, lo_cum = bound, c
    return float(bounds[-1])
