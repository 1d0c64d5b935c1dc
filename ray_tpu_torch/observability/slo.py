"""SLO ledger: per-request lifecycle accounting for the serving path.

The north-star workloads are scored against SLOs (TTFT/ITL p99/p99.9,
goodput), not raw throughput — but quantile GAUGES cannot be aggregated
across processes (the p99 of two p99s is meaningless), and a slow
request used to be unattributable: nothing said whether its time went to
ingress shed/queueing, router dispatch/resume, engine queue wait,
prefill chunks, decode gaps, or a disaggregated KV export/import. This
module is the measurement substrate that fixes both:

* **fixed log-bucket latency histograms** — ``raytpu_llm_ttft_seconds``
  / ``raytpu_llm_itl_seconds`` / ``raytpu_llm_e2e_seconds``, labeled
  ``{deployment, tenant_class}``, on :data:`SLO_BUCKETS` (ratio-1.10
  log-spaced bounds, so any quantile — p99.9 included — interpolates
  from SUMMED per-process counts at ~5% relative error). Resumable
  serve streams are observed by the ROUTER (the client-perceived
  timeline: failover stalls count as slow gaps, and the samples
  survive replica SIGKILLs); direct engine callers and non-resumable
  streams are observed by the engine. Every process's counts merge
  element-wise in :func:`build_report`.
* **goodput vs fault-cost counters** — delivered-useful tokens
  (``raytpu_llm_goodput_tokens_total``) split from token work faults
  forced (``raytpu_llm_fault_cost_tokens_total{reason}``: cancelled /
  failed decode work, preemption re-prefill, resume replay) plus
  ``raytpu_llm_deadline_expired_total`` — the counters that let the
  traffic simulator (ROADMAP item 8) separate fault cost from capacity
  cost, reconciling exactly against the engine/ingress intake books
  (:func:`books_balanced`).
* **a flight recorder** — a bounded per-process ring
  (:class:`FlightRecorder`) holding the slowest-K requests by stage
  breakdown PLUS every flagged one (SLO-violating, resumed, preempted,
  failed, shed), each entry carrying its trace id when the request
  was sampled. ``serve.slo_report()`` collects every tier's ring and
  JOINS entries by request id, so one call names the stage that made an
  outlier slow.

Everything here is jax-free and cheap by construction: a ledger stamp is
one ``time.monotonic()`` on an object the request already owns, a
histogram observe is one bisect + increment, and a recorder insert is a
bounded deque append / fixed-size heap replace.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import math
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG


def _log_buckets(lo: float, hi: float, ratio: float) -> Tuple[float, ...]:
    """Log-spaced bucket bounds from ``lo`` to just past ``hi``, rounded
    to 4 significant digits (stable exposition text), strictly
    increasing."""
    out: List[float] = []
    v = lo
    while v < hi * ratio:
        r = round(v, 3 - int(math.floor(math.log10(v))))
        if not out or r > out[-1]:
            out.append(r)
        v *= ratio
    return tuple(out)


#: 100µs .. 120s at width ratio 1.10: linear interpolation inside a
#: bucket bounds the relative error by (ratio-1)/2 ≈ 5% at ANY quantile
#: — p99.9 of a merged cluster-wide distribution included — for ~150
#: buckets per label set. The span covers sub-ms decode gaps through
#: multi-minute stuck requests.
SLO_BUCKETS: Tuple[float, ...] = _log_buckets(1e-4, 120.0, 1.10)


# -- metrics (registered once per process) -----------------------------------

_METRICS = None
_METRICS_LOCK = threading.Lock()


def slo_metrics():
    """The SLO series (README Observability catalog). TTFT/ITL/e2e are
    HISTOGRAMS on :data:`SLO_BUCKETS` — the aggregatable replacement for
    the old per-engine quantile gauges."""
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.observability.metrics import Counter, Histogram

        with _METRICS_LOCK:
            if _METRICS is None:
                labels = ("deployment", "tenant_class")
                _METRICS = {
                    "ttft": Histogram(
                        "raytpu_llm_ttft_seconds",
                        "request submit to first streamed token",
                        labels, buckets=SLO_BUCKETS,
                    ),
                    "itl": Histogram(
                        "raytpu_llm_itl_seconds",
                        "inter-token gap between consecutive streamed tokens",
                        labels, buckets=SLO_BUCKETS,
                    ),
                    "e2e": Histogram(
                        "raytpu_llm_e2e_seconds",
                        "request submit to terminal state",
                        labels, buckets=SLO_BUCKETS,
                    ),
                    "goodput": Counter(
                        "raytpu_llm_goodput_tokens_total",
                        "tokens delivered by requests that finished cleanly",
                        labels,
                    ),
                    "fault": Counter(
                        "raytpu_llm_fault_cost_tokens_total",
                        "token work faults forced (cancelled|failed decode "
                        "work, preempt_replay re-prefill, resume_replay)",
                        ("deployment", "reason"),
                    ),
                    "deadline": Counter(
                        "raytpu_llm_deadline_expired_total",
                        "requests reaped because their deadline expired",
                        ("deployment",),
                    ),
                }
    return _METRICS


# -- per-engine latency tape -------------------------------------------------


class BucketCounts:
    """A bare log-bucket count vector (no registry, no labels): the
    per-engine TTFT tape backing ``stats()['ttft']`` back-compat, and
    the merge unit for snapshot aggregation. NOT thread-safe — callers
    own the locking (the engine observes under its own lock)."""

    __slots__ = ("buckets", "counts", "total")

    def __init__(
        self,
        buckets: Sequence[float] = SLO_BUCKETS,
        counts: Optional[Sequence[int]] = None,
    ):
        self.buckets = tuple(buckets)
        self.counts = list(counts) if counts else [0] * (len(self.buckets) + 1)
        self.total = sum(self.counts)

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.total += 1

    def merge(self, other: "BucketCounts") -> "BucketCounts":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        return self

    def quantile(self, q: float) -> Optional[float]:
        from ray_tpu_torch.observability.metrics import bucket_quantile

        return bucket_quantile(self.buckets, self.counts, q)


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded per-process ring of request ledger entries: the slowest-K
    (fixed-size min-heap keyed by the caller's latency key — replace is
    O(log K) with K fixed, i.e. O(1)) plus EVERY flagged entry
    (SLO-violating / resumed / preempted / shed / failed) on a
    ``deque(maxlen)``. Inserts never allocate beyond the caps, so the
    recorder can run always-on under full serving load."""

    def __init__(self, slow_slots: Optional[int] = None, flagged_slots: Optional[int] = None):
        self._slow_cap = int(
            GLOBAL_CONFIG.slo_flight_recorder_slots if slow_slots is None else slow_slots
        )
        self._slow: List[Tuple[float, int, Dict[str, Any]]] = []
        self._flagged: deque = deque(
            maxlen=int(
                GLOBAL_CONFIG.slo_flight_flagged_slots
                if flagged_slots is None
                else flagged_slots
            )
        )
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.added = 0

    def add(
        self,
        entry: Dict[str, Any],
        *,
        flagged: bool = False,
        slow_key: Optional[float] = None,
    ) -> None:
        with self._lock:
            self.added += 1
            if flagged:
                self._flagged.append(entry)
            if slow_key is not None and self._slow_cap > 0:
                item = (float(slow_key), next(self._seq), entry)
                if len(self._slow) < self._slow_cap:
                    heapq.heappush(self._slow, item)
                elif item[0] > self._slow[0][0]:
                    heapq.heapreplace(self._slow, item)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Every retained entry, deduped (an entry can sit in both the
        flagged ring and the slowest-K heap)."""
        with self._lock:
            seen: Dict[int, Dict[str, Any]] = {}
            for e in self._flagged:
                seen[id(e)] = e
            for _k, _s, e in self._slow:
                seen[id(e)] = e
            return [dict(e) for e in seen.values()]


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder every tier (engine, router, ingress)
    in this process writes into."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


# -- snapshot / aggregation --------------------------------------------------

#: histogram + counter series a process snapshot carries (the SLO sinks
#: plus the router/ingress counters the report reconciles against)
_SNAP_HISTOGRAMS = (
    "raytpu_llm_ttft_seconds",
    "raytpu_llm_itl_seconds",
    "raytpu_llm_e2e_seconds",
)
_SNAP_COUNTERS = (
    "raytpu_llm_goodput_tokens_total",
    "raytpu_llm_fault_cost_tokens_total",
    "raytpu_llm_deadline_expired_total",
    "raytpu_llm_requests_total",
    "raytpu_stream_resumes_total",
    "raytpu_stream_resume_replay_tokens_total",
    "raytpu_ingress_requests_total",
    "raytpu_ingress_shed_total",
)


def snapshot() -> Dict[str, Any]:
    """This process's SLO state: raw histogram bucket counts (mergeable),
    counter values, and the flight-recorder ring. Callers (LLMServer /
    HttpIngress ``slo_snapshot``) attach their tier's ``books``."""
    from ray_tpu_torch.observability.metrics import _METRICS as _REG

    out: Dict[str, Any] = {"histograms": {}, "counters": {}, "flight": []}
    for name in _SNAP_HISTOGRAMS:
        m = _REG.get(name)
        if m is None:
            continue
        with m._lock:  # noqa: SLF001 — the registry owns no dump API
            values = {k: list(v) for k, v in m._values.items()}  # noqa: SLF001
        out["histograms"][name] = {
            "labelnames": list(m.labelnames),
            "buckets": list(m.buckets),
            "values": values,
        }
    for name in _SNAP_COUNTERS:
        m = _REG.get(name)
        if m is None:
            continue
        with m._lock:  # noqa: SLF001
            out["counters"][name] = {
                "labelnames": list(m.labelnames),
                "values": dict(m._values),  # noqa: SLF001
            }
    out["flight"] = flight_recorder().snapshot()
    return out


def books_balanced(books: Dict[str, Any]) -> bool:
    """The exact-conservation identity for one tier's intake books.

    * engine: every submitted request is finished, failed, cancelled,
      or still in flight (queued/running) — nothing leaks, even across
      chaos kills, preemption churn, and drain cutoffs.
    * ingress: every request seen was shed, rejected as bad input, or
      forwarded downstream — a shed provably consumed nothing.

    The identity holds exactly at quiesce; mid-transition reads can be
    transiently short by the requests crossing a boundary (callers poll).
    """
    kind = books.get("kind")
    if kind == "engine":
        return int(books.get("submitted", 0)) == (
            int(books.get("finished", 0))
            + int(books.get("failed", 0))
            + int(books.get("cancelled", 0))
            + int(books.get("queued", 0))
            + int(books.get("running", 0))
        )
    if kind == "ingress":
        return int(books.get("seen", 0)) == (
            int(books.get("shed", 0))
            + int(books.get("bad_request", 0))
            + int(books.get("forwarded", 0))
        )
    return False


def _merge_values(dst: Dict[Any, Any], src: Dict[Any, Any]) -> None:
    for k, v in src.items():
        cur = dst.get(k)
        if cur is None:
            dst[k] = list(v) if isinstance(v, list) else v
        elif isinstance(v, list):
            for i, x in enumerate(v):
                cur[i] += x
        else:
            dst[k] = cur + v


#: the INTERNAL id suffixes the serving path itself appends — resume
#: attempts ride ``<rid>.rN`` (serve/router), disagg prefills
#: ``<rid>.pf`` (router handoff). Only these fold; a client-supplied id
#: that happens to contain a dot ("sess7.q1") is its own request and
#: must never merge with a sibling ("sess7.q2").
_INTERNAL_SUFFIX = re.compile(r"\.(r\d+|pf)$")

#: outcome-join precedence: the tier closest to the client wins
#: (within a tier, a clean terminal state beats an attempt's failure)
_TIER_RANK = {"engine": 0, "router": 1, "ingress": 2}


def _join_flight(entries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Join per-tier recorder entries into per-request records by BASE
    request id (one logical request, several engine intakes — see
    :data:`_INTERNAL_SUFFIX`)."""
    by_base: Dict[str, Dict[str, Any]] = {}
    anon = itertools.count()
    for e in entries:
        rid = str(e.get("request_id") or "")
        base = _INTERNAL_SUFFIX.sub("", rid) if rid else f"anon{next(anon)}"
        rec = by_base.setdefault(
            base,
            {
                "request_id": base,
                "tiers": {},
                "stages": {},
                "resumes": 0,
                "replayed_tokens": 0,
                "flags": [],
            },
        )
        tier = str(e.get("tier") or "unknown")
        rec["tiers"].setdefault(tier, e)
        for key in ("deployment", "tenant_class", "trace_id"):
            if e.get(key) and not rec.get(key):
                rec[key] = e[key]
        # outcome: the tier CLOSEST to the client wins, regardless of
        # snapshot arrival order — a resumed stream leaves a 'failed'
        # engine entry for the killed attempt 0 next to the router's
        # 'ok'; the client got their tokens, so the joined record is ok
        if e.get("outcome"):
            new_rank = (
                _TIER_RANK.get(tier, 0),
                1 if e["outcome"] in ("ok", "finished") else 0,
            )
            if new_rank >= rec.get("_outcome_rank", (-1, -1)):
                rec["outcome"] = e["outcome"]
                rec["_outcome_rank"] = new_rank
        for key in ("ttft_s", "e2e_s"):
            if e.get(key) is not None:
                rec[key] = max(float(e[key]), float(rec.get(key) or 0.0))
        rec["resumes"] += int(e.get("resumes") or 0)
        rec["replayed_tokens"] += int(e.get("replayed_tokens") or 0)
        for f in e.get("flags") or ():
            if f not in rec["flags"]:
                rec["flags"].append(f)
        for stage, dur in (e.get("stages") or {}).items():
            key = f"{tier}.{stage}"
            rec["stages"][key] = round(
                max(float(dur), float(rec["stages"].get(key, 0.0))), 6
            )
    out = []
    for rec in by_base.values():
        rec.pop("_outcome_rank", None)
        if rec["stages"]:
            rec["slowest_stage"] = max(rec["stages"], key=rec["stages"].get)
        out.append(rec)
    out.sort(key=lambda r: float(r.get("e2e_s") or r.get("ttft_s") or 0.0), reverse=True)
    return out


_QS = (0.50, 0.99, 0.999)
_QNAMES = ("p50", "p99", "p999")


def _quantile_block(buckets, counts) -> Dict[str, Any]:
    from ray_tpu_torch.observability.metrics import bucket_quantile

    n = int(sum(counts))
    block: Dict[str, Any] = {"count": n}
    for q, name in zip(_QS, _QNAMES):
        v = bucket_quantile(buckets, counts, q)
        if v is not None:
            block[name] = round(v, 6)
    return block


def build_report(
    snapshots: List[Dict[str, Any]],
    serve_status: Optional[Dict[str, Any]] = None,
    *,
    flight_limit: int = 100,
) -> Dict[str, Any]:
    """Fold per-process snapshots (each optionally tagged with
    ``deployment``/``tier``/``books`` by its producer) into the
    cluster-wide SLO report: aggregated TTFT/ITL/e2e quantiles per
    deployment (and per tenant class), goodput vs fault-cost counters,
    per-replica books with their conservation verdicts, and the joined
    flight-recorder dump, slowest first."""
    merged_hist: Dict[str, Dict[str, Any]] = {}
    merged_counters: Dict[str, Dict[str, Any]] = {}
    flight: List[Dict[str, Any]] = []
    books: List[Dict[str, Any]] = []
    for snap in snapshots:
        if not snap:
            continue
        for name, h in (snap.get("histograms") or {}).items():
            dst = merged_hist.setdefault(
                name,
                {"labelnames": h["labelnames"], "buckets": h["buckets"], "values": {}},
            )
            _merge_values(dst["values"], h["values"])
        for name, c in (snap.get("counters") or {}).items():
            dst = merged_counters.setdefault(
                name, {"labelnames": c["labelnames"], "values": {}}
            )
            _merge_values(dst["values"], c["values"])
        flight.extend(snap.get("flight") or ())
        if snap.get("books"):
            b = dict(snap["books"])
            b["deployment"] = snap.get("deployment", b.get("deployment", ""))
            b["balanced"] = books_balanced(b)
            books.append(b)

    deployments: Dict[str, Dict[str, Any]] = {}

    def _dep(name: str) -> Dict[str, Any]:
        return deployments.setdefault(
            name,
            {
                "ttft_s": {"count": 0},
                "itl_s": {"count": 0},
                "e2e_s": {"count": 0},
                "by_class": {},
                "goodput_tokens": 0,
                "fault_tokens": {},
                "deadline_expired": 0,
                "books": [],
            },
        )

    for name, key in (
        ("raytpu_llm_ttft_seconds", "ttft_s"),
        ("raytpu_llm_itl_seconds", "itl_s"),
        ("raytpu_llm_e2e_seconds", "e2e_s"),
    ):
        h = merged_hist.get(name)
        if h is None:
            continue
        buckets = h["buckets"]
        nb = len(buckets) + 1
        per_dep: Dict[str, List[float]] = {}
        for lk, ent in h["values"].items():
            dep, cls = (lk[0] or ""), (lk[1] or "")
            counts = ent[:nb]
            acc = per_dep.setdefault(dep, [0] * nb)
            for i, c in enumerate(counts):
                acc[i] += c
            _dep(dep)["by_class"].setdefault(cls, {})[key] = _quantile_block(
                buckets, counts
            )
        for dep, counts in per_dep.items():
            _dep(dep)[key] = _quantile_block(buckets, counts)

    gp = merged_counters.get("raytpu_llm_goodput_tokens_total", {}).get("values", {})
    for lk, v in gp.items():
        _dep(lk[0] or "")["goodput_tokens"] += int(v)
    ft = merged_counters.get("raytpu_llm_fault_cost_tokens_total", {}).get("values", {})
    for lk, v in ft.items():
        d = _dep(lk[0] or "")["fault_tokens"]
        d[lk[1]] = d.get(lk[1], 0) + int(v)
    dl = merged_counters.get("raytpu_llm_deadline_expired_total", {}).get("values", {})
    for lk, v in dl.items():
        _dep(lk[0] or "")["deadline_expired"] += int(v)
    for b in books:
        _dep(b.get("deployment") or "")["books"].append(b)

    for dep in deployments.values():
        fault = sum(dep["fault_tokens"].values())
        good = dep["goodput_tokens"]
        dep["goodput_fraction"] = (
            round(good / (good + fault), 6) if (good + fault) > 0 else None
        )
        dep["books_balanced"] = all(b["balanced"] for b in dep["books"]) if dep[
            "books"
        ] else None

    if serve_status:
        for name, st in serve_status.items():
            if name in deployments:
                deployments[name]["restarts"] = st.get("restarts")
                deployments[name]["shed_total"] = st.get("shed_total")
                # most recent applied autoscale decision (reason +
                # old/new target + wall ts) so a report alone is enough
                # to attribute autoscaler lag to a p99.9 miss window
                if st.get("last_scale") is not None:
                    deployments[name]["last_scale"] = st.get("last_scale")

    return {
        "generated_at": time.time(),
        "buckets": {"ratio": 1.10, "count": len(SLO_BUCKETS)},
        "deployments": deployments,
        "counters": {
            name: {
                ",".join(k) if isinstance(k, tuple) else str(k): v
                for k, v in c["values"].items()
            }
            for name, c in merged_counters.items()
        },
        "flight_recorder": _join_flight(flight)[:flight_limit],
    }
