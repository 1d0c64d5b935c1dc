"""Metrics: counters/gauges + Prometheus text exposition.

Reference: ``src/ray/stats/metric_defs.cc`` (system metric definitions),
``_private/metrics_agent.py`` + ``_private/prometheus_exporter.py`` (the
per-node agent exposing Prometheus text). Here each daemon/controller
process runs a tiny stdlib HTTP endpoint serving ``/metrics`` in the
Prometheus exposition format; user code gets the same Counter/Gauge
API as ``ray.util.metrics``."""

from __future__ import annotations

import bisect
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_METRICS: Dict[str, "Metric"] = {}
_COLLECT_CALLBACKS: List[Callable[[], None]] = []


class Metric:
    """Base: name + help + labelled values."""

    TYPE = "untyped"

    def __init__(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.labelnames = tuple(labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            existing = _METRICS.get(name)
            if existing is not None:
                if existing.labelnames != self.labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered with different labels "
                        f"{self.labelnames} != {existing.labelnames}"
                    )
                # re-registration returns the same underlying metric
                self._values = existing._values
                self._lock = existing._lock
            else:
                _METRICS[name] = self

    def _key(self, labels: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        labels = labels or {}
        return tuple(str(labels.get(k, "")) for k in self.labelnames)

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def collect(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.description}",
            f"# TYPE {self.name} {self.TYPE}",
        ]
        with self._lock:
            for key, value in sorted(self._values.items()):
                if self.labelnames:
                    label_str = ",".join(
                        f'{n}="{v}"' for n, v in zip(self.labelnames, key)
                    )
                    lines.append(f"{self.name}{{{label_str}}} {value}")
                else:
                    lines.append(f"{self.name} {value}")
        return lines


class Counter(Metric):
    TYPE = "counter"

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount


class Gauge(Metric):
    TYPE = "gauge"


def bucket_quantile(
    buckets: Sequence[float], counts: Sequence[float], q: float
) -> Optional[float]:
    """Estimate the ``q``-quantile from histogram bucket counts
    (``counts[i]`` = observations with value <= ``buckets[i]``;
    ``counts[len(buckets)]`` is the +Inf overflow). Linear interpolation
    inside the winning bucket — the Prometheus ``histogram_quantile``
    estimator — so with log-spaced buckets of width ratio ``r`` the
    relative error is bounded by ~``(r-1)/2``. This is what makes
    histograms AGGREGATABLE: counts from any number of processes sum
    element-wise and the quantile of the sum is exact to bucket
    resolution, which no set of per-process quantile gauges can offer.
    Returns None when the histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c > 0 and cum + c >= rank:
            lo = buckets[i - 1] if i > 0 else 0.0
            # the +Inf bucket has no upper bound: clamp to the last
            # finite bound (size the table so p99.9 never lands here)
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            if hi <= lo:
                return hi
            return lo + (hi - lo) * max(0.0, rank - cum) / c
        cum += c
    return float(buckets[-1])


#: default latency buckets (seconds): sub-ms submit stages through
#: multi-second transfers — the envelopes this runtime actually spans
_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram(Metric):
    """Prometheus histogram: cumulative ``_bucket{le=...}`` series plus
    ``_sum``/``_count``. ``observe`` is a short lock + linear bucket scan
    (≤ ~16 comparisons) — cheap enough for per-task stage timings."""

    TYPE = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        labelnames: Tuple[str, ...] = (),
        buckets: Optional[Tuple[float, ...]] = None,
    ):
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        super().__init__(name, description, labelnames)

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        value = float(value)
        with self._lock:
            k = self._key(labels)
            ent = self._values.get(k)
            if ent is None:
                # [per-bucket counts..., +Inf count, sum, count]
                ent = self._values[k] = [0] * (len(self.buckets) + 1) + [0.0, 0]
            # bisect, not a linear scan: the SLO latency histograms run
            # ~150 log-spaced buckets and observe() sits on the engine's
            # per-token path (bisect_left lands on the first bound >= v;
            # past-the-end = the +Inf slot, which IS index len(buckets))
            ent[bisect.bisect_left(self.buckets, value)] += 1
            ent[-2] += value
            ent[-1] += 1

    def counts(self, labels: Optional[Dict[str, str]] = None) -> Optional[List[float]]:
        """Raw per-bucket counts (incl. the +Inf slot; sum and count
        trail) for one label set — the cross-process merge unit."""
        with self._lock:
            ent = self._values.get(self._key(labels))
            return list(ent) if ent is not None else None

    def quantiles(
        self, qs: Iterable[float], labels: Optional[Dict[str, str]] = None
    ) -> Dict[float, Optional[float]]:
        """Quantile estimates for one label set via
        :func:`bucket_quantile` (None when nothing was observed)."""
        ent = self.counts(labels)
        counts = ent[: len(self.buckets) + 1] if ent is not None else ()
        return {q: bucket_quantile(self.buckets, counts, q) for q in qs}

    def collect(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.description}",
            f"# TYPE {self.name} {self.TYPE}",
        ]
        with self._lock:
            for key, ent in sorted(self._values.items()):
                base = list(zip(self.labelnames, key))

                def _fmt(extra: List[Tuple[str, str]]) -> str:
                    pairs = base + extra
                    if not pairs:
                        return ""
                    return "{" + ",".join(f'{n}="{v}"' for n, v in pairs) + "}"

                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += ent[i]
                    lines.append(
                        f"{self.name}_bucket{_fmt([('le', repr(float(b)))])} {cum}"
                    )
                cum += ent[len(self.buckets)]
                lines.append(f"{self.name}_bucket{_fmt([('le', '+Inf')])} {cum}")
                lines.append(f"{self.name}_sum{_fmt([])} {ent[-2]}")
                lines.append(f"{self.name}_count{_fmt([])} {ent[-1]}")
        return lines


def on_collect(cb: Callable[[], None]) -> Callable[[], None]:
    """Register a callback run right before exposition (for gauges
    sampled from live state, e.g. store bytes). Returns ``cb`` so the
    owner can deregister it at shutdown."""
    with _REGISTRY_LOCK:
        _COLLECT_CALLBACKS.append(cb)
    return cb


def remove_collect(cb: Callable[[], None]) -> None:
    with _REGISTRY_LOCK:
        try:
            _COLLECT_CALLBACKS.remove(cb)
        except ValueError:
            pass


def render() -> str:
    with _REGISTRY_LOCK:
        callbacks = list(_COLLECT_CALLBACKS)
        metrics = list(_METRICS.values())
    for cb in callbacks:
        try:
            cb()
        except Exception:
            pass
    out: List[str] = []
    for m in metrics:
        out.extend(m.collect())
    return "\n".join(out) + "\n"


def inject_label(text: str, label: str, value: str) -> str:
    """Rewrite Prometheus exposition text so every series carries
    ``label="value"`` (federation relabeling: the controller stamps each
    scraped node's series with its node id). Comment lines pass through.
    A series that ALREADY carries the label keeps its own value —
    daemon-side gauges are registered with a ``node`` label, and a
    duplicated label name is a parse error for real Prometheus."""
    out: List[str] = []
    pair = f'{label}="{value}"'
    marker = f'{label}="'
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        name, _, rest = line.partition(" ")
        if "{" in name:
            head, _, tail = name.partition("{")
            # boundary-anchored so a label NAMED e.g. "mynode" doesn't
            # mask the injection (labels are comma-joined, no spaces)
            if tail.startswith(marker) or ("," + marker) in tail:
                out.append(line)  # series already carries the label
            else:
                out.append(f"{head}{{{pair},{tail} {rest}")
        else:
            out.append(f"{name}{{{pair}}} {rest}")
    return "\n".join(out)


class _Handler(BaseHTTPRequestHandler):
    #: extra GET routes (path -> () -> str), set per server instance via
    #: a subclass — the controller mounts /federate here
    _routes: Dict[str, Callable[[], str]] = {}

    def do_GET(self):  # noqa: N802
        path = self.path.rstrip("/")
        if path in self._routes:
            try:
                body = self._routes[path]().encode()
            except Exception:
                self.send_response(500)
                self.end_headers()
                return
            ctype = "text/plain; version=0.0.4"
        elif path == "/healthz":
            body = b"ok"
            ctype = "text/plain"
        elif path in ("", "/metrics"):
            body = render().encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class MetricsServer:
    """Prometheus exposition endpoint for this process."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        routes: Optional[Dict[str, Callable[[], str]]] = None,
    ):
        # per-instance handler class: co-hosted servers (controller +
        # daemon in the head process) must not share extra routes
        handler = type("_BoundHandler", (_Handler,), {"_routes": dict(routes or {})})
        try:
            self._httpd = ThreadingHTTPServer((host, port), handler)
        except OSError:
            # fixed port already taken (e.g. controller + daemon
            # co-hosted): fall back to auto-assign rather than failing
            # cluster startup
            self._httpd = ThreadingHTTPServer((host, 0), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="metrics"
        )
        self._thread.start()

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
