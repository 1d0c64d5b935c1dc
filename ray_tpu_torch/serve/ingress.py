"""HTTP/SSE ingress: the overload-safe multi-tenant front door.

Everything used to enter through an in-process ``DeploymentHandle`` —
one abusive tenant could fill every engine admission queue and turn
overload into an outage. This module terminates streaming HTTP at the
edge and owns the front-door robustness policies (reference shape:
``serve/_private/proxy.py``, run as a *deployment* so it scales/heals
like any replica set; grounding: the Gemma-on-TPU serving comparison,
PAPERS.md arXiv:2605.25645, which scores SLO attainment under
contention, not raw tok/s):

* **per-tenant fairness** — a cost-denominated token bucket per tenant
  (cost = prompt tokens + ``max_new_tokens``), with per-tenant
  rate/burst overrides and a priority class (``interactive`` >
  ``standard`` > ``batch``). 429 + ``Retry-After`` (the exact bucket
  refill wait) instead of queueing.
* **shed BEFORE queue** — the shed decision reads the engine
  queue-depth / outstanding-token gossip the router already receives
  (``Router.cluster_pressure()``, zero extra RPCs): a request that
  would only park in an engine admission queue is refused at the door
  with 429 + ``Retry-After``, so a shed request consumes **zero**
  engine queue slots. Lower classes shed first (``shed_verdict``);
  the class also rides downstream as the engine ``priority``, so
  degradation continues inside the scheduler (batch work is preempted
  for interactive work under block pressure).
* **client-disconnect propagation** — a client that goes away
  mid-stream closes the value iterator, which abandons the ref stream,
  which cooperatively cancels the replica-side producer, which closes
  the engine generator and ``cancel()``s the request: KV blocks and
  the decode slot free within ~one token (core/streaming.py,
  core/task_executor.py, serve/router.py).
* **per-request deadlines** — ``x-request-timeout-s`` (clamped to
  ``serve_ingress_default_timeout_s``) is stamped into the ambient
  ``core/deadline`` budget, so the engine stops decoding for callers
  that already gave up.
* **tenant/session affinity** — :func:`pick_ingress` rendezvous-hashes
  a tenant onto one ingress replica; that replica's router (optimistic
  load bumps + the PR 6 prefix-affinity scorer) keeps the tenant's
  shared system prompt hot on one backend replica subset.

Downstream of the door, requests ride the resumable-stream path
(``Router.execute_stream`` tier 3): a mid-stream backend replica death
is invisible through HTTP — the stream resumes on a survivor with
exactly-once token delivery.

The ingress replica is a PLAIN serve class (no jax import) — it holds a
``DeploymentHandle`` to the engine deployment, which works inside an
actor because handles pickle with their controller handle (PR 9).
Observability: ``raytpu_ingress_requests_total{tenant_class,outcome}``,
``raytpu_ingress_shed_total{reason}``, ``raytpu_ingress_ttfb_seconds``;
``serve.status()`` surfaces ``{shed_total, queue_depth,
outstanding_tokens}`` per deployment from the same gossip channel.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.deadline import deadline_scope

#: priority classes, most sheddable first; the value doubles as the
#: engine ``priority`` (the continuous-batching scheduler preempts
#: lowest-priority-first, so the ladder applies inside the engine too)
CLASS_PRIORITY: Dict[str, int] = {"batch": 0, "standard": 1, "interactive": 2}

_TOP_PRIORITY = max(CLASS_PRIORITY.values())

_SENTINEL = object()


class TokenBucket:
    """Cost-denominated token bucket (fairness primitive). Not
    thread-safe on its own — the ingress serializes access under one
    lock. ``now`` is injectable for deterministic unit tests."""

    __slots__ = ("rate", "burst", "level", "stamp")

    def __init__(self, rate: float, burst: float):
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self.level = self.burst
        self.stamp = time.monotonic()

    def try_take(self, cost: float, now: Optional[float] = None) -> float:
        """0.0 → taken. Otherwise the seconds until the bucket could
        cover ``cost`` (the honest ``Retry-After``); nothing is taken.
        A cost above the burst capacity is quoted against the cap —
        the wait is the time to refill a FULL bucket, after which the
        request is admitted with the bucket driven negative (a tenant
        whose single request exceeds its whole burst must still be
        servable, just slowly)."""
        now = time.monotonic() if now is None else now
        self.level = min(self.burst, self.level + (now - self.stamp) * self.rate)
        self.stamp = now
        need = min(float(cost), self.burst)
        if need <= self.level:
            self.level -= float(cost)
            return 0.0
        return (need - self.level) / self.rate


@dataclass
class TenantPolicy:
    """Per-tenant knobs; ``None`` falls through to the config/global
    defaults."""

    rate: Optional[float] = None
    burst: Optional[float] = None
    tenant_class: str = "standard"


@dataclass
class IngressConfig:
    #: downstream deployment name (informational once a handle is bound)
    target: str = "llm"
    #: downstream streaming method (must be LLM-shaped: dict request
    #: with a token ``prompt``) — ``generate`` rides the resumable path
    method: str = "generate"
    default_class: str = "standard"
    #: None → the ``serve_ingress_default_rate``/``_burst`` knobs
    default_rate: Optional[float] = None
    default_burst: Optional[float] = None
    tenants: Dict[str, TenantPolicy] = field(default_factory=dict)
    #: load watermark: priority-0 (batch) requests shed once the
    #: gossiped outstanding tokens per REPORTING replica exceed this;
    #: class k sheds above ``(k+1) ×`` it — interactive traffic keeps
    #: flowing until 3× the pressure that sheds batch. <= 0 disables.
    shed_outstanding_per_replica: float = 2048.0
    #: queue watermark: below-top classes shed once the summed engine
    #: admission queues reach this fraction of their gossiped bound;
    #: at >= 1.0 (queues actually full) every class sheds — queueing
    #: further would only park the request until its deadline
    shed_queue_fraction: float = 0.5
    #: None → the ``serve_ingress_default_timeout_s`` knob
    default_timeout_s: Optional[float] = None
    #: None → the ``serve_ingress_retry_after_s`` knob
    retry_after_s: Optional[float] = None
    #: thread pool sizing for the blocking stream plumbing: each ACTIVE
    #: stream parks one worker in next() between tokens, so this is the
    #: per-replica concurrent-stream ceiling (excess requests queue at
    #: dispatch — explicit backpressure, not starvation of the shared
    #: default pool, whose min(32, cpus+4) workers would otherwise cap
    #: concurrency far below max_concurrent_queries)
    max_concurrent_streams: int = 64
    #: bucket-persistence key (set by ``ingress_deployment`` to the door
    #: deployment's name): per-tenant token-bucket fill levels snapshot
    #: to the serve controller on a timer and are restored by a
    #: replacement replica — a restart no longer refills every tenant's
    #: budget. None (standalone/driver use) disables persistence.
    snapshot_key: Optional[str] = None
    #: SLO autopilot: ITL p99 budget (seconds). When set, the load
    #: watermark above stops being a static constant — it is scaled by
    #: target/measured ITL (worst fresh replica's windowed p99, from
    #: gossip), so the door tightens admission while decode steps are
    #: slow and relaxes it when ITL runs comfortably under budget. See
    #: ``effective_shed_threshold``. None = static watermark.
    shed_itl_target_s: Optional[float] = None

    def resolved_rate(self, pol: TenantPolicy) -> float:
        if pol.rate is not None:
            return pol.rate
        if self.default_rate is not None:
            return self.default_rate
        return GLOBAL_CONFIG.serve_ingress_default_rate

    def resolved_burst(self, pol: TenantPolicy) -> float:
        if pol.burst is not None:
            return pol.burst
        if self.default_burst is not None:
            return self.default_burst
        return GLOBAL_CONFIG.serve_ingress_default_burst


#: bounds on the ITL-derived watermark adjustment: the closed loop may
#: tighten the static base to 1/4 or relax it to 4x, never beyond —
#: a latency spike (or an idle, instantly-fast engine) must not swing
#: admission to zero or infinity on one gossip window
ITL_ADJUST_MIN = 0.25
ITL_ADJUST_MAX = 4.0


def effective_shed_threshold(
    base: float,
    itl_target_s: Optional[float],
    measured_itl_p99_s: float,
) -> float:
    """The load watermark the door actually applies, as a pure function
    (cluster-free testable). Static ``base`` when no ITL target is
    configured or no measurement has gossiped yet; otherwise the base
    scaled by target/measured — at-budget ITL reproduces the static
    threshold exactly, 2x-over-budget halves it, half-budget doubles it
    — clamped to [ITL_ADJUST_MIN, ITL_ADJUST_MAX] times the base."""
    if base <= 0 or not itl_target_s or measured_itl_p99_s <= 0.0:
        return base
    adjust = float(itl_target_s) / measured_itl_p99_s
    adjust = max(ITL_ADJUST_MIN, min(ITL_ADJUST_MAX, adjust))
    return base * adjust


def shed_verdict(
    pressure: Dict[str, Any], priority: int, cfg: IngressConfig
) -> Optional[str]:
    """Shed-before-queue policy, as a pure function (unit-tested
    without a cluster). ``pressure`` is ``Router.cluster_pressure()``
    output. Returns None (admit) or a shed reason.

    No fresh gossip → ADMIT: shedding blind would turn a gossip hiccup
    into an outage; the engine's own admission bound remains the
    backstop."""
    reporting = int(pressure.get("reporting") or 0)
    if reporting <= 0:
        return None
    max_queue = int(pressure.get("max_queue_depth") or 0)
    if max_queue > 0:
        frac = float(pressure.get("queue_depth") or 0) / max_queue
        if frac >= 1.0 or (
            frac >= cfg.shed_queue_fraction and priority < _TOP_PRIORITY
        ):
            return "queue_pressure"
    base = effective_shed_threshold(
        cfg.shed_outstanding_per_replica,
        cfg.shed_itl_target_s,
        float(pressure.get("itl_p99_s") or 0.0),
    )
    if base > 0:
        per_replica = float(pressure.get("outstanding_tokens") or 0.0) / reporting
        if per_replica > base * (priority + 1):
            return "load"
    return None


def _ingress_metrics():
    from ray_tpu_torch.observability.rpc_metrics import (
        INGRESS_REQUESTS,
        INGRESS_SHED,
        INGRESS_TTFB,
    )

    return INGRESS_REQUESTS, INGRESS_SHED, INGRESS_TTFB


class HttpIngress:
    """One ingress replica: an aiohttp HTTP/SSE server owning the
    front-door policies, forwarding admitted requests through a
    ``DeploymentHandle``'s router. Defined undecorated at module level
    so cloudpickle exports it by reference (see serve/replica.py)."""

    def __init__(
        self,
        config: Optional[IngressConfig] = None,
        handle=None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.cfg = config or IngressConfig()
        if handle is None:
            # driver-side standalone use; inside a replica the handle is
            # bound at deploy time (ingress_deployment) — a bare name
            # can't find the controller from the worker's namespace
            from ray_tpu_torch import serve as _serve

            handle = _serve.get_deployment_handle(self.cfg.target)
        self._target_handle = handle
        self._router = handle._router
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        #: restored bucket states from the serve controller (tenant ->
        #: {"level", "wall"}), consumed lazily as tenants re-appear —
        #: refill since the snapshot is credited at consumption time
        self._bucket_seed: Dict[str, Dict[str, float]] = {}
        self._snapshot_stop = threading.Event()
        if self.cfg.snapshot_key:
            self._restore_buckets()
            period = GLOBAL_CONFIG.serve_ingress_bucket_snapshot_period_s
            if period > 0:
                threading.Thread(
                    target=self._bucket_snapshot_loop,
                    args=(period,),
                    daemon=True,
                    name="ingress-bucket-snapshot",
                ).start()
        #: local mirrors of the prometheus counters — gossiped to the
        #: serve controller (routing_stats) and returned by debug_stats
        #: so tests/operators read them without scraping /metrics
        self._shed_total = 0
        self._sheds: Dict[str, int] = {}
        self._outcomes: Dict[str, int] = {}
        self._forwarded = 0
        #: independent intake count (stamped at request entry, BEFORE
        #: any policy runs) — the left-hand side of the ingress
        #: conservation identity seen == shed + bad_request + forwarded
        self._seen = 0
        #: last flight-recorder shed entry per reason (1/s sampling —
        #: see _count_shed)
        self._shed_flight_at: Dict[str, float] = {}
        #: (monotonic, ttfb_s) client-observed first-byte latencies —
        #: the windowed p99 gossiped through routing_stats. The door's
        #: clock includes router-side waits (replica death, dispatch
        #: queues) that the engines' own TTFT windows never contain, so
        #: the controller's SLO-autopilot burn signal for the TARGET
        #: deployment reads it alongside the engines' gossip
        self._recent_ttfb: deque = deque(maxlen=512)
        #: forwarded requests still waiting for their FIRST byte
        #: (request_id -> forward monotonic). Their current age is a
        #: live lower bound on the eventual TTFB, folded into
        #: ``_ttfb_p99`` — without it a total stall (every replica dead)
        #: produces NO samples and the burn signal goes blind exactly
        #: when it matters
        self._inflight_t0: Dict[str, float] = {}
        self.host = host
        self.port = int(port)
        # dedicated pool for the blocking stream plumbing (dispatch +
        # per-item next): sized to the stream ceiling. Iterator CLOSES
        # deliberately run on the loop's default pool instead — a close
        # must never queue behind 64 parked next() calls, or a
        # disconnected client's engine work outlives it (exactly the
        # overload regime disconnect propagation exists for).
        from concurrent.futures import ThreadPoolExecutor

        self._exec = ThreadPoolExecutor(
            max_workers=max(1, int(self.cfg.max_concurrent_streams)),
            thread_name_prefix="ingress-stream",
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True, name="serve-ingress"
        )
        self._thread.start()
        if not self._started.wait(15) or self._startup_error is not None:
            raise RuntimeError(
                f"ingress http server failed to start: {self._startup_error!r}"
            )

    # -- server thread ----------------------------------------------------
    def _serve_loop(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        app = web.Application()
        app.router.add_get("/healthz", self._handle_health)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        # access_log=None: per-request log lines would be forwarded to
        # every connected driver by the worker log tailer — pure noise
        # at serving rates (the request counters carry the signal)
        runner = web.AppRunner(app, access_log=None)

        async def _start():
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            addrs = runner.addresses
            if addrs:
                self.port = int(addrs[0][1])  # port=0 → the bound port
            self._started.set()

        try:
            loop.run_until_complete(_start())
        except BaseException as e:  # noqa: BLE001 — surface to __init__
            self._startup_error = e
            self._started.set()
            return
        loop.run_forever()

    async def _handle_health(self, request):
        from aiohttp import web

        return web.json_response({"ok": True})

    # -- bucket persistence (the restart-refill fix) ----------------------
    def _restore_buckets(self) -> None:
        """Pull the door's persisted bucket table from the serve
        controller. Best-effort: an unreachable controller means fresh
        buckets (the pre-persistence behavior), never a failed start."""
        import ray_tpu_torch

        try:
            controller = self._target_handle._controller
            self._bucket_seed = dict(
                ray_tpu_torch.get(
                    controller.load_ingress_buckets.remote(
                        self.cfg.snapshot_key
                    ),
                    timeout=10,
                )
                or {}
            )
        except Exception:  # noqa: BLE001
            self._bucket_seed = {}

    def _bucket_snapshot_loop(self, period: float) -> None:
        """Timer push of per-tenant fill levels. Wall-clock stamps, not
        monotonic — the restoring replica is a different process, and it
        credits refill for the downtime from the stamp."""
        controller = self._target_handle._controller
        while not self._snapshot_stop.wait(period):
            try:
                now_mono = time.monotonic()
                now_wall = time.time()
                with self._lock:
                    snap = {
                        tenant: {
                            "level": b.level,
                            "wall": now_wall - (now_mono - b.stamp),
                        }
                        for tenant, b in self._buckets.items()
                    }
                if snap:
                    controller.save_ingress_buckets.remote(
                        self.cfg.snapshot_key, snap
                    )
            except Exception:  # noqa: BLE001 — drop the tick, keep looping
                pass

    # -- accounting -------------------------------------------------------
    def _count(self, tenant_class: str, outcome: str) -> None:
        requests, _shed, _ttfb = _ingress_metrics()
        with self._lock:
            key = f"{tenant_class}:{outcome}"
            self._outcomes[key] = self._outcomes.get(key, 0) + 1
        requests.inc(labels={"tenant_class": tenant_class, "outcome": outcome})

    def _count_shed(self, tenant_class: str, reason: str, tenant: str = "") -> None:
        _requests, shed, _ttfb = _ingress_metrics()
        with self._lock:
            self._shed_total += 1
            self._sheds[reason] = self._sheds.get(reason, 0) + 1
        shed.inc(labels={"reason": reason})
        self._count(tenant_class, "shed")
        # SLO ledger: sheds file flagged flight-recorder entries —
        # capacity-protection decisions the operator audits when goodput
        # dips — but SAMPLED at ~1/s per reason: an overload burst sheds
        # hundreds per second, and unsampled they would flush every
        # resumed/slow/error outlier out of the shared newest-win ring
        # exactly when the operator needs it (totals live in the
        # counters; the ring only needs a representative)
        now = time.monotonic()
        with self._lock:
            last = self._shed_flight_at.get(reason, 0.0)
            if now - last < 1.0:
                return
            self._shed_flight_at[reason] = now
        from ray_tpu_torch.observability.slo import flight_recorder

        flight_recorder().add(
            {
                "tier": "ingress",
                "request_id": None,
                "deployment": self.cfg.target,
                "tenant_class": tenant_class,
                "tenant": tenant,
                "outcome": "shed",
                "shed_reason": reason,
                "flags": ["shed"],
                "stages": {},
            },
            flagged=True,
        )

    #: bucket-table bound: past it the least-recently-used quarter is
    #: evicted (an evicted tenant's next request refills a fresh burst —
    #: acceptable for cold tenants, and the table can't grow forever)
    _MAX_BUCKETS = 4096

    def _take(self, tenant: str, pol: TenantPolicy, cost: float) -> float:
        """NOTE: the tenant id is caller-supplied — fairness is only as
        strong as the authentication in front of this header. A client
        minting a fresh id per request starts each one on a fresh burst;
        deploy behind an authenticating edge (or derive the tenant from
        credentials) for adversarial traffic. The cluster-pressure shed
        (class-blind on unknown tenants: default class) remains the
        backstop either way."""
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= self._MAX_BUCKETS:
                    # TokenBucket.stamp is the last-touch time: evict the
                    # coldest quarter in one pass instead of per-insert
                    for victim in sorted(
                        self._buckets, key=lambda t: self._buckets[t].stamp
                    )[: self._MAX_BUCKETS // 4]:
                        del self._buckets[victim]
                bucket = self._buckets[tenant] = TokenBucket(
                    self.cfg.resolved_rate(pol), self.cfg.resolved_burst(pol)
                )
                seed = self._bucket_seed.pop(tenant, None)
                if seed is not None:
                    # resume the persisted fill level, crediting refill
                    # for the time since the snapshot — a restart must
                    # not hand a depleted tenant a fresh burst, nor
                    # freeze its refill clock
                    bucket.level = min(
                        bucket.burst,
                        float(seed.get("level", bucket.burst))
                        + max(0.0, time.time() - float(seed.get("wall", 0.0)))
                        * bucket.rate,
                    )
            return bucket.try_take(cost)

    def _budget(self, request, body: Dict[str, Any]) -> float:
        ceiling = (
            self.cfg.default_timeout_s
            if self.cfg.default_timeout_s is not None
            else GLOBAL_CONFIG.serve_ingress_default_timeout_s
        )
        raw = request.headers.get("x-request-timeout-s")
        if raw is None:
            raw = body.get("timeout_s")
        if raw is None:
            return ceiling
        try:
            return max(0.1, min(float(raw), ceiling))
        except (TypeError, ValueError):
            return ceiling

    # -- request path -----------------------------------------------------
    async def _handle(self, request):
        from aiohttp import web

        t0 = time.monotonic()
        _requests, _shed, ttfb = _ingress_metrics()
        if request.method != "POST":
            return web.json_response(
                {"error": "POST a generation request"}, status=405
            )
        with self._lock:
            self._seen += 1
        try:
            raw = await request.read()
            body = json.loads(raw) if raw else {}
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            prompt = [int(t) for t in (body.get("prompt") or ())]
            if not prompt:
                raise ValueError("request needs a 'prompt' (list of token ids)")
            max_new = int(body.get("max_new_tokens") or 64)
            if max_new < 1:
                raise ValueError("max_new_tokens must be >= 1")
        except Exception as e:  # noqa: BLE001 — malformed input
            self._count("unknown", "bad_request")
            return web.json_response({"error": f"bad request: {e!r}"}, status=400)

        tenant = request.headers.get("x-tenant-id") or str(
            body.get("tenant") or "anonymous"
        )
        pol = self.cfg.tenants.get(tenant) or TenantPolicy(
            tenant_class=self.cfg.default_class
        )
        tenant_class = (
            pol.tenant_class if pol.tenant_class in CLASS_PRIORITY else "standard"
        )
        priority = CLASS_PRIORITY[tenant_class]
        cost = len(prompt) + max_new

        # 1. per-tenant fairness — the bucket sheds BEFORE any
        # downstream work; Retry-After is the exact refill wait
        retry_after = self._take(tenant, pol, cost)
        if retry_after > 0.0:
            self._count_shed(tenant_class, "rate_limit", tenant)
            return self._shed_response(web, "rate_limit", retry_after)

        # 2. cluster pressure — gossiped engine stats the router already
        # holds; a shed here provably never consumed an engine queue slot
        reason = shed_verdict(self._router.cluster_pressure(), priority, self.cfg)
        if reason is not None:
            self._count_shed(tenant_class, reason, tenant)
            retry = (
                self.cfg.retry_after_s
                if self.cfg.retry_after_s is not None
                else GLOBAL_CONFIG.serve_ingress_retry_after_s
            )
            return self._shed_response(web, reason, retry)

        # 3. forward on the resumable-stream path, class stamped as the
        # engine priority, deadline stamped into the ambient budget
        req = dict(body)
        req["prompt"] = prompt
        req["max_new_tokens"] = max_new
        req["priority"] = priority  # the CLASS decides, never the client
        # SLO ledger: the class labels the latency histograms downstream,
        # and pinning the request id HERE (the first tier that sees the
        # request) lets slo_report() join this tier's flight-recorder
        # entry with the router's and the engine's for one request
        req["tenant_class"] = tenant_class
        import uuid as _uuid

        req.setdefault("request_id", _uuid.uuid4().hex[:16])
        rid = str(req["request_id"])
        req.pop("tenant", None)
        req.pop("timeout_s", None)
        budget = self._budget(request, body)
        model_id = request.headers.get("serve-multiplexed-model-id", "")
        method = self.cfg.method
        router = self._router
        loop = asyncio.get_event_loop()

        def _dispatch():
            with deadline_scope(budget):
                return router.execute_stream(
                    method, (req,), {}, model_id=model_id, timeout=budget
                )

        with self._lock:
            self._forwarded += 1
            self._inflight_t0[rid] = time.monotonic()
        try:
            values = await loop.run_in_executor(self._exec, _dispatch)
        except Exception as e:  # noqa: BLE001 — dispatch failed
            self._inflight_t0.pop(rid, None)
            self._count(tenant_class, "error")
            return web.json_response({"error": repr(e)}, status=503)

        streaming = "text/event-stream" in request.headers.get("Accept", "")
        it = iter(values)
        if not streaming:
            try:
                tokens = await loop.run_in_executor(self._exec, list, it)
            except Exception as e:  # noqa: BLE001
                self._count(tenant_class, "error")
                self._flight_ttfb(rid, tenant_class, time.monotonic() - t0, "error")
                return web.json_response({"error": repr(e)}, status=503)
            finally:
                await loop.run_in_executor(None, _close_iterator, it)
            dur = time.monotonic() - t0
            ttfb.observe(dur)
            self._count(tenant_class, "ok")
            self._flight_ttfb(rid, tenant_class, dur, "ok")
            return web.json_response({"tokens": tokens})
        return await self._stream_sse(request, it, tenant_class, t0, rid)

    def _flight_ttfb(
        self, rid: str, tenant_class: str, ttfb_s: float, outcome: str
    ) -> None:
        """File an ingress-tier flight entry for a slow or failed
        request (cheap predicate per request; the joined record then
        shows whether the time went to the door, the router, or the
        engine)."""
        with self._lock:
            # first-byte-pending entry still here → the SSE first-byte
            # hook never sampled this request (JSON path, or it died
            # before any byte): record its TTFB now, exactly once
            if self._inflight_t0.pop(rid, None) is not None:
                self._recent_ttfb.append((time.monotonic(), float(ttfb_s)))
        slow = ttfb_s > GLOBAL_CONFIG.slo_ttft_slow_s
        if not slow and outcome == "ok":
            return
        from ray_tpu_torch.observability.slo import flight_recorder

        flags = (["slow_ttfb"] if slow else []) + (
            [outcome] if outcome != "ok" else []
        )
        flight_recorder().add(
            {
                "tier": "ingress",
                "request_id": rid,
                "deployment": self.cfg.target,
                "tenant_class": tenant_class,
                "outcome": outcome,
                "ttft_s": round(ttfb_s, 6),
                "stages": {"ttfb": round(ttfb_s, 6)},
                "flags": flags,
            },
            flagged=True,
            slow_key=ttfb_s,
        )

    async def _stream_sse(self, request, it, tenant_class: str, t0: float, rid: str = ""):
        """SSE the stream out. Once the response is prepared this ALWAYS
        returns it; a client disconnect must not bubble out (a second
        response would be sent) and MUST close the value iterator — that
        close is what cancels the engine request and frees its blocks."""
        from aiohttp import web

        _requests, _shed, ttfb = _ingress_metrics()
        loop = asyncio.get_event_loop()
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        outcome = "ok"
        first = True
        first_dur: Optional[float] = None
        try:
            while True:
                try:
                    item = await loop.run_in_executor(self._exec, next, it, _SENTINEL)
                except Exception as e:  # noqa: BLE001 — mid-stream failure
                    outcome = "error"
                    await resp.write(
                        f"event: error\ndata: {json.dumps(repr(e))}\n\n".encode()
                    )
                    break
                if item is _SENTINEL:
                    await resp.write(b"event: done\ndata: {}\n\n")
                    break
                if first:
                    first = False
                    first_dur = time.monotonic() - t0
                    ttfb.observe(first_dur)
                    with self._lock:
                        self._inflight_t0.pop(rid, None)
                        self._recent_ttfb.append(
                            (time.monotonic(), float(first_dur))
                        )
                await resp.write(f"data: {json.dumps(item)}\n\n".encode())
            await resp.write_eof()
        except (ConnectionError, asyncio.CancelledError):
            outcome = "disconnect"  # client went away mid-stream
        finally:
            await loop.run_in_executor(None, _close_iterator, it)
            self._count(tenant_class, outcome)
            self._flight_ttfb(
                rid,
                tenant_class,
                first_dur if first_dur is not None else time.monotonic() - t0,
                outcome,
            )
        return resp

    @staticmethod
    def _shed_response(web, reason: str, retry_after: float):
        retry_after = max(0.05, float(retry_after))
        return web.json_response(
            {"error": "shed", "reason": reason, "retry_after": retry_after},
            status=429,
            headers={"Retry-After": f"{retry_after:.3f}"},
        )

    # -- introspection / serve plumbing -----------------------------------
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _ttfb_p99(self, window_s: float = 30.0) -> float:
        """Windowed client-observed first-byte p99. Requests still
        WAITING for their first byte contribute their current age —
        a live lower bound on their eventual TTFB — so a total stall
        (every replica dead) registers immediately instead of only
        after the stalled requests finally complete."""
        now = time.monotonic()
        with self._lock:
            samples = list(self._recent_ttfb)
            pending = [now - t0 for t0 in self._inflight_t0.values()]
        vals = sorted(
            [v for ts, v in samples if now - ts <= window_s] + pending
        )
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, math.ceil(0.99 * len(vals)) - 1))
        return vals[idx]

    def routing_stats(self) -> Dict[str, Any]:
        """Opts ingress replicas into the serve gossip reporter
        (serve/replica.py): the shed counter reaches ``serve.status()``
        through the same replica→controller channel the engines' queue
        stats ride — no new control-plane path. ``ttfb_p99_s`` +
        ``target`` feed the controller's SLO-autopilot burn signal for
        the target deployment (see controller._autoscale_once)."""
        ttfb = self._ttfb_p99()
        with self._lock:
            return {
                "shed_total": self._shed_total,
                "forwarded_total": self._forwarded,
                "ingress": True,
                "target": self.cfg.target,
                "ttfb_p99_s": round(ttfb, 6),
            }

    def ledger_books(self) -> Dict[str, Any]:
        """Front-door conservation books (slo.books_balanced): every
        request seen was shed, rejected as bad input, or forwarded —
        exactly one of the three, so ``seen == shed + bad_request +
        forwarded`` holds at all times (each request increments its
        bucket BEFORE the handler returns)."""
        with self._lock:
            bad = sum(
                v for k, v in self._outcomes.items()
                if k.endswith(":bad_request")
            )
            completed = sum(
                v for k, v in self._outcomes.items()
                if k.split(":", 1)[1] in ("ok", "error", "disconnect")
            )
            return {
                "kind": "ingress",
                "seen": self._seen,
                "shed": self._shed_total,
                "bad_request": bad,
                "forwarded": self._forwarded,
                "completed": completed,
                "in_flight": self._forwarded - completed,
            }

    def slo_snapshot(self) -> Dict[str, Any]:
        """SLO-ledger dump for ``serve.slo_report()``: this door
        process's flight recorder + counters (its ROUTER lives here too,
        so resumed-stream entries ride along) plus the ingress books."""
        from ray_tpu_torch.observability import slo as _slo

        snap = _slo.snapshot()
        snap["books"] = self.ledger_books()
        snap["tier"] = "ingress"
        snap["deployment"] = self.cfg.target
        return snap

    def debug_stats(self) -> Dict[str, Any]:
        """Full counter snapshot for tests/operators: shed breakdown,
        per-class outcomes, the live pressure view, and this replica's
        router-decision / stream-resume counters (the scored-path and
        failover evidence lives in THIS process — the driver can't read
        it from its own registry)."""
        from ray_tpu_torch.observability.rpc_metrics import (
            ROUTER_DECISIONS,
            STREAM_RESUMES,
        )

        with self._lock:
            out: Dict[str, Any] = {
                "shed_total": self._shed_total,
                "sheds": dict(self._sheds),
                "outcomes": dict(self._outcomes),
                "forwarded_total": self._forwarded,
                "tenants": sorted(self._buckets),
            }
        out["pressure"] = self._router.cluster_pressure()
        out["router_decisions"] = {
            f"{k[0]}:{k[1]}": v for k, v in ROUTER_DECISIONS._values.items()
        }
        out["stream_resumes"] = {
            k[0]: v for k, v in STREAM_RESUMES._values.items()
        }
        return out

    def check_health(self) -> bool:
        return self._thread.is_alive() and self._startup_error is None

    def stop(self) -> None:
        self._snapshot_stop.set()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._exec.shutdown(wait=False)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def _close_iterator(it) -> None:
    """Close a value iterator from a cleanup path. A generator whose
    next() is still blocked in ANOTHER executor thread (abandoned by a
    cancelled handler) raises 'generator already executing' — retry
    briefly: the pending next() returns with the next token, the frame
    suspends, and the close lands, which is what propagates the cancel
    to the engine. Best-effort after that (GC abandon is the backstop)."""
    close = getattr(it, "close", None)
    if close is None:
        return
    for _ in range(100):
        try:
            close()
            return
        except ValueError:
            time.sleep(0.05)
        except Exception:  # noqa: BLE001 — cleanup must never raise
            return


def ingress_deployment(
    target: str = "llm",
    config: Optional[IngressConfig] = None,
    *,
    name: str = "ingress",
    num_replicas: int = 1,
    max_concurrent_queries: int = 64,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """Build the ingress as a regular serve deployment: N replicas, each
    terminating HTTP/SSE on its own auto-assigned port (production puts
    an L4 balancer in front; tests/bench talk to replica addresses
    directly via :func:`ingress_addresses` + :func:`pick_ingress`).

    Call AFTER ``serve.run`` of the target deployment — the downstream
    ``DeploymentHandle`` is built at ``bind()`` time and pickled into
    every replica (the PR 9 handle-pickling fix is what makes this
    ≥3-process serve chain work)."""
    from ray_tpu_torch import serve

    # the explicit ``target`` argument always names the downstream
    # deployment; the caller's config object is never mutated (one
    # IngressConfig can parameterize several doors). The door's own
    # deployment name keys bucket persistence: every replica of this
    # door shares (and a replacement restores) one tenant-bucket table.
    import dataclasses

    if config is None:
        cfg = IngressConfig(target=target, snapshot_key=name)
    else:
        cfg = dataclasses.replace(config, target=target, snapshot_key=name)
    dep = serve.deployment(
        name=name,
        num_replicas=num_replicas,
        max_concurrent_queries=max_concurrent_queries,
        ray_actor_options=dict(ray_actor_options or {"num_cpus": 0.1}),
    )(HttpIngress)

    class _BoundIngress:
        def __init__(self, inner):
            self._inner = inner

        def bind(self, **overrides):
            handle = serve.get_deployment_handle(cfg.target)
            return self._inner.bind(cfg, handle, **overrides)

        def __getattr__(self, item):
            return getattr(self._inner, item)

    return _BoundIngress(dep)


def ingress_addresses(name: str = "ingress", timeout: float = 60.0) -> List[str]:
    """``host:port`` of every READY ingress replica."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import get_or_create_controller

    controller = get_or_create_controller()
    replicas = ray_tpu_torch.get(controller.get_replicas.remote(name), timeout=timeout)
    return [
        ray_tpu_torch.get(
            r.handle_request.remote("address", [], {}, ""), timeout=timeout
        )
        for r in replicas
    ]


def pick_ingress(tenant: str, addresses: Sequence[str]) -> str:
    """Rendezvous-hash a tenant onto one ingress replica: the tenant's
    whole session enters through one door, whose router state (local
    load bumps + the backend prefix-affinity scorer) keeps the tenant's
    shared system prompt hot on one backend replica subset, while
    tenants as a population spread evenly across ingress replicas."""
    if not addresses:
        raise ValueError("no ingress addresses")
    import hashlib

    return max(
        addresses,
        key=lambda a: hashlib.blake2b(
            f"{tenant}|{a}".encode(), digest_size=8
        ).digest(),
    )


class IngressShedError(RuntimeError):
    """Client-side 429: the front door refused the request."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(f"shed ({reason}), retry after {retry_after:.3f}s")
        self.reason = reason
        self.retry_after = retry_after


def http_stream(
    address: str,
    request: Dict[str, Any],
    *,
    tenant: Optional[str] = None,
    timeout_s: Optional[float] = None,
    connect_timeout: float = 60.0,
) -> Iterator[Any]:
    """Minimal stdlib SSE client (tests + bench; a real client is any
    HTTP/SSE stack). Yields stream items; raises :class:`IngressShedError`
    on 429. Closing the returned generator closes the connection — the
    server observes the disconnect and cancels the engine request."""
    import urllib.error
    import urllib.request

    headers = {
        "Content-Type": "application/json",
        "Accept": "text/event-stream",
    }
    if tenant:
        headers["x-tenant-id"] = tenant
    if timeout_s is not None:
        headers["x-request-timeout-s"] = str(timeout_s)
    http_req = urllib.request.Request(
        f"http://{address}/generate",
        data=json.dumps(request).encode(),
        headers=headers,
    )
    try:
        resp = urllib.request.urlopen(http_req, timeout=connect_timeout)
    except urllib.error.HTTPError as e:
        if e.code == 429:
            try:
                info = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001
                info = {}
            raise IngressShedError(
                str(info.get("reason", "unknown")),
                float(e.headers.get("Retry-After") or 0.0),
            ) from None
        raise

    def _events():
        try:
            event = None
            for raw in resp:
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not line:
                    event = None  # blank line = event boundary
                elif line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
                    if event == "error":
                        raise RuntimeError(f"ingress stream error: {data}")
                    if event == "done":
                        return
                    yield data
        finally:
            resp.close()

    return _events()
