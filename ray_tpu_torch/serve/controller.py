"""ServeController: reconciles deployments to their target state.

Reference: ``serve/_private/controller.py:84`` (deploy_application
``:719``), ``deployment_state.py:2331`` (replica FSM + ROLLING updates
keyed on deployment version) and ``autoscaling_state.py:262``
(queue-length autoscaling). One named controller actor owns the replica
sets and runs a control loop: start missing replicas, promote them once
READY, reap dead ones, roll old-version replicas out start-before-kill,
and scale on the replicas' reported ongoing-request counts. Routing
tables are PUSHED to routers via long-poll (``long_poll.py`` in the
reference): ``poll_replicas`` parks until the replica set version
changes."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import Replica

CONTROLLER_NAME = "__serve_controller__"


def autoscale_decision(
    *,
    target: int,
    cfg: AutoscalingConfig,
    total_load: float,
    ttft_p99_s: float = 0.0,
) -> Tuple[int, str]:
    """Pure replica-count decision (cluster-free testable): what the
    deployment's target should be, and why.

    Legacy mode (no ``target_ttft_p99_s``, or no TTFT signal gossiped
    yet): scale toward ``total_load / target_ongoing_requests`` —
    unchanged queue-depth behavior.

    SLO autopilot mode: burn = measured windowed TTFT-p99 / budget.
      * burn >= ttft_burn_high — the budget is gone: scale OUT (at
        least one step; straight to the queue-derived count when a
        burst demands more).
      * burn <= ttft_burn_low AND the queue signal agrees we're
        over-provisioned: release ONE replica (conservative scale-in).
      * in between — the hysteresis dead band: HOLD, so a chaos blip
        (a replica kill inflating p99 for one window) doesn't thrash.
    """
    queue_desired = max(
        cfg.min_replicas,
        min(cfg.max_replicas, round(total_load / cfg.target_ongoing_requests)),
    )
    budget = cfg.target_ttft_p99_s
    if not budget or ttft_p99_s <= 0.0:
        return queue_desired, "queue_depth"
    burn = ttft_p99_s / float(budget)
    if burn >= cfg.ttft_burn_high:
        return min(cfg.max_replicas, max(target + 1, queue_desired)), "ttft_burn"
    if burn <= cfg.ttft_burn_low and queue_desired < target:
        return max(cfg.min_replicas, target - 1), "ttft_relax"
    return target, "hold"


def pool_ratio_decision(
    *,
    prefill_target: int,
    n_decode: int,
    prefill_tokens_per_s: float,
    decode_tokens_per_s: float,
    min_replicas: int,
    max_replicas: int,
) -> Tuple[int, str]:
    """Pure disagg prefill-pool sizing decision: with homogeneous
    replicas, the prefill:decode split should track the observed
    prefill:decode TOKEN mix (desired_prefill ≈ n_decode * P/D, both
    rates from engine gossip). No signal on either side (idle pool,
    gossip not landed) holds the current target — never resize blind."""
    if prefill_tokens_per_s <= 0.0 or decode_tokens_per_s <= 0.0 or n_decode <= 0:
        return prefill_target, "no_signal"
    desired = int(round(n_decode * prefill_tokens_per_s / decode_tokens_per_s))
    desired = max(min_replicas, min(max_replicas, max(1, desired)))
    return desired, "token_mix"


def _count_autoscale_decision(deployment: str, reason: str) -> None:
    try:
        from ray_tpu_torch.observability.rpc_metrics import SERVE_AUTOSCALE_DECISIONS

        SERVE_AUTOSCALE_DECISIONS.inc(
            labels={"deployment": deployment, "reason": reason}
        )
    except Exception:
        pass


def _count_replica_restart(state: "_DeploymentState", reason: str) -> None:
    """A ready replica was killed for replacement: observed death or an
    unhealthy self-report. Counted on the controller's /metrics registry
    AND on the deployment state (surfaced via status())."""
    state.restarts[reason] = state.restarts.get(reason, 0) + 1
    try:
        from ray_tpu_torch.observability.rpc_metrics import SERVE_REPLICA_RESTARTS

        SERVE_REPLICA_RESTARTS.inc(labels={"reason": reason})
    except Exception:
        pass


class _DeploymentState:
    def __init__(self, name, cls_or_fn, init_args, init_kwargs, config: DeploymentConfig):
        self.name = name
        self.cls_or_fn = cls_or_fn
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        # every deploy without an explicit version is a new code version
        # (the reference hashes config+code; we can't diff code, so a
        # fresh uuid forces the same rolling replacement)
        self.version: str = config.version or uuid.uuid4().hex[:8]
        self.target = (
            config.autoscaling.min_replicas if config.autoscaling else config.num_replicas
        )
        #: READY replicas: (version, handle) — the routing set
        self.replicas: List[Tuple[str, Any]] = []
        #: started but not yet proven ready: (version, handle, started_at)
        self.starting: List[Tuple[str, Any, float]] = []
        #: unrouted, waiting for in-flight requests to finish before the
        #: kill (graceful drain — zero-downtime rolls/scale-downs)
        self.draining: List[Tuple[str, Any, float]] = []
        self.last_scale_ts = 0.0
        self.last_stuck_evict_ts = 0.0
        #: last time a starter died as runtime-unplaceable
        self.unplaceable_ts = 0.0
        #: replica uid -> multiplexed model ids loaded there (pushed by
        #: replicas; propagated to routers through the long-poll)
        self.replica_models: Dict[str, List[str]] = {}
        #: replica uid -> (routing stats dict, receipt monotonic) —
        #: load + prefix-digest gossip from gossip-capable replicas
        #: (serve/replica.py), shipped to routers with the routing set
        self.replica_stats: Dict[str, Tuple[Dict[str, Any], float]] = {}
        #: last replica.health() poll sweep (proactive wedged-replica
        #: restart rides its own cadence, not every reconcile pass)
        self.last_health_ts = 0.0
        #: ready replicas killed for replacement, by reason — mirrored
        #: into status() so tests/operators see it without scraping the
        #: controller process's /metrics
        self.restarts: Dict[str, int] = {"death": 0, "unhealthy": 0}
        #: last APPLIED autoscale decision ({"ts", "from", "to",
        #: "reason"}) — surfaced via status() so the load harness can
        #: measure autoscaler lag (burst start -> first target change)
        #: without scraping metrics
        self.last_scale_info: Dict[str, Any] = {}


class _ServeController:
    """Runs inside an actor; a background thread reconciles."""

    def __init__(self, registered_namespace=None):
        # the namespace this controller's NAME lives in (the creating
        # driver's) — the controller process's own namespace differs, and
        # replicas need the registered one to get_actor() us for reports
        self._registered_namespace = registered_namespace
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = threading.Lock()
        # Preemption-aware drain handoff: node ids currently DRAINING
        # (controller-pushed). Replicas there are unrouted (moved to the
        # draining list) so routers drop them, in-flight requests finish,
        # and replacements start — all before the kill lands.
        self._draining_nodes: set = set()
        #: ingress-door key -> {tenant: bucket state}: the timer-pushed
        #: token-bucket persistence table (survives ingress replica
        #: restarts; this controller outlives its replicas)
        self._ingress_buckets: Dict[str, Dict[str, Dict[str, float]]] = {}
        #: replica actor_id -> node_id cache (stable: replicas don't move)
        self._replica_nodes: Dict[bytes, bytes] = {}
        try:
            from ray_tpu_torch.core.api import _global_worker

            self._node_listener_backend = _global_worker().backend
            self._node_listener_backend.add_node_event_listener(self._on_node_event)
        except Exception:
            self._node_listener_backend = None  # local mode: no node events
        # serializes whole reconcile passes: deploy() (RPC thread) and the
        # control loop both reconcile, and unsynchronized passes would
        # double-start replicas then drop one set from tracking (leak)
        self._reconcile_lock = threading.Lock()
        # long-poll state: bumped whenever any routing set changes
        self._versions: Dict[str, int] = {}
        self._change = threading.Condition()
        # the control loop's reconcile passes, begun and ended (under
        # _change): a status wait reads after one that began after it
        self._passes_begun = 0
        self._passes_ended = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._control_loop, daemon=True, name="serve-control"
        )
        self._thread.start()

    def _bump(self, name: str) -> None:
        with self._change:
            self._versions[name] = self._versions.get(name, 0) + 1
            self._change.notify_all()

    def _on_node_event(self, msg) -> None:
        """Controller node-state push (io-loop thread: keep non-blocking).
        DRAINING enters the set; DEAD/removed leaves it."""
        node_id = msg.get("node_id")
        if node_id is None:
            return
        if msg.get("state") == "DRAINING":
            self._draining_nodes.add(node_id)
        elif not msg.get("alive", True):
            self._draining_nodes.discard(node_id)

    # -- API -------------------------------------------------------------
    def deploy(self, name, cls_or_fn, init_args, init_kwargs, config: DeploymentConfig) -> bool:
        with self._lock:
            old = self._deployments.get(name)
            state = _DeploymentState(name, cls_or_fn, init_args, init_kwargs, config)
            if old is not None:
                if config.version is not None and config.version == old.version:
                    # same code version: in-place config update (scale);
                    # existing replicas keep serving untouched — and an
                    # autoscaled target must survive the redeploy, or the
                    # pass after a config tweak drains replicas under load
                    state.version = old.version
                    if config.autoscaling and old.config.autoscaling:
                        state.target = old.target
                        state.last_scale_ts = old.last_scale_ts
                state.replicas = old.replicas
                state.starting = old.starting
                state.draining = old.draining
                state.restarts = old.restarts
            self._deployments[name] = state
        self._reconcile_once()
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            state = self._deployments.pop(name, None)
        if state is None:
            return False
        all_handles = (
            state.replicas
            + [(v, h) for v, h, _t in state.starting]
            + [(v, h) for v, h, _t in state.draining]
        )
        for _v, r in all_handles:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._bump(name)
        return True

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            state = self._deployments.get(name)
            return [r for _v, r in state.replicas] if state else []

    def _routing_set(self, name: str):
        """(handle, loaded_model_ids, stats_entry) triples — what
        routers consume. ``stats_entry`` is None for replicas that never
        gossiped (plain deployments), else ``{"stats": ..., "age_s": ...}``
        with the age measured on THIS controller's clock at poll time
        (routers age it locally from receipt — monotonic clocks don't
        compare across processes)."""
        now = time.monotonic()
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return []
            out = []
            for _v, r in state.replicas:
                uid = r.actor_id.hex()
                ent = state.replica_stats.get(uid)
                stats_entry = (
                    {
                        "stats": ent[0],
                        "age_s": max(0.0, now - ent[1]),
                        # opaque identity of THIS report (controller
                        # receipt time): routers must reset their
                        # optimistic load bumps only when a genuinely
                        # NEW report arrives — re-deriving freshness
                        # from now-age_s wobbles with delivery latency
                        # and would wipe bumps on every relay
                        "stamp": ent[1],
                    }
                    if ent is not None
                    else None
                )
                out.append((r, state.replica_models.get(uid, []), stats_entry))
            return out

    @staticmethod
    def _live_uids(state: _DeploymentState) -> set:
        """Actor uids the deployment still tracks in ANY lifecycle list
        — the pruning horizon for replica-pushed side tables (models,
        routing stats). One definition, used by every prune site, so a
        future lifecycle list can't silently leak one of the dicts."""
        return {
            r.actor_id.hex()
            for group in (
                state.replicas,
                [(v, h) for v, h, _t in state.starting],
                [(v, h) for v, h, _t in state.draining],
            )
            for _v, r in group
        }

    def report_models(self, name: str, replica_uid: str, models: List[str]) -> bool:
        """Replica-pushed multiplexed-model set (reference: model ids
        flow replica -> controller -> routers via long-poll broadcast,
        ``multiplex.py`` + ``long_poll.py``)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return False
            state.replica_models[replica_uid] = list(models)
            # prune entries for replicas no longer tracked — without this
            # the dict grows one entry per replica generation forever
            live = self._live_uids(state)
            live.add(replica_uid)
            for uid in [u for u in state.replica_models if u not in live]:
                del state.replica_models[uid]
        self._bump(name)
        return True

    def report_replica_stats(self, name: str, replica_uid: str, stats: Dict[str, Any]) -> bool:
        """Replica-pushed routing gossip (load + prefix digest): stored
        with a receipt timestamp and broadcast to routers through the
        same long-poll channel as the routing set. Bounded: entries are
        pruned to live replicas, mirroring ``report_models``. Bump cost:
        one long-poll wake per report per parked router — the gossip
        cadence IS the `serve_replica_stats_period_s` knob (raise it to
        trade routing-signal freshness for controller fan-out)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return False
            state.replica_stats[replica_uid] = (dict(stats), time.monotonic())
            live = self._live_uids(state)
            live.add(replica_uid)
            for uid in [u for u in state.replica_stats if u not in live]:
                del state.replica_stats[uid]
        self._bump(name)
        return True

    @ray_tpu_torch.method(concurrency_group="longpoll")
    def poll_replicas(self, name: str, known_version: int, timeout_s: float = 30.0):
        """Long-poll (reference ``LongPollClient``): returns
        ``(version, routing_set)`` as soon as the routing set differs
        from ``known_version`` (or on timeout, with the current state).
        The routing set pairs each replica handle with its loaded
        multiplexed-model ids."""
        deadline = time.monotonic() + timeout_s
        with self._change:
            while self._versions.get(name, 0) == known_version:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    break
                self._change.wait(min(remaining, 1.0))
            version = self._versions.get(name, 0)
        return version, self._routing_set(name)

    @ray_tpu_torch.method(concurrency_group="longpoll")
    def wait_status(
        self,
        name: str,
        *,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        quiescent: bool = False,
        version: Optional[str] = None,
        timeout_s: float = 30.0,
    ):
        """Condition-based status wait (deflakes what used to be client
        sleep-polling): parks on the controller's change condition until
        the deployment's routed-replica count enters
        [min_replicas, max_replicas] (with ``quiescent``, nothing is
        starting or draining; with ``version``, every routed replica is
        on that version — a completed roll), or the timeout expires.
        Returns the final status dict either way — callers assert on it."""
        deadline = time.monotonic() + timeout_s

        def _ok(st: Dict[str, Any]) -> bool:
            if st is None:
                return False
            if min_replicas is not None and st["replicas"] < min_replicas:
                return False
            if max_replicas is not None and st["replicas"] > max_replicas:
                return False
            if quiescent and (st["starting"] or st["draining"]):
                return False
            if version is not None and (
                st["version"] != version
                or st["replicas_current_version"] != st["replicas"]
            ):
                return False
            return True

        with self._change:
            # liveness as of this call: the first read waits (within the
            # deadline) for a control-loop pass begun after the call, so a
            # replica that died just before it is counted dead, not routed
            first = self._passes_begun + 1
            while self._passes_ended < first and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._change.wait(min(remaining, 0.25))
        while True:
            st = self.status().get(name)
            if _ok(st):
                return st
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._stop.is_set():
                return st
            with self._change:
                # woken by any routing-set change; the 0.25s cap also
                # re-samples target/autoscale changes that don't bump
                self._change.wait(min(remaining, 0.25))

    def resumable_stream_methods(self, name: str) -> List[str]:
        """Streaming methods the deployment's CALLABLE declares
        replay-safe (``resumable_streams`` class attribute) — read off
        the deployed class object, no replica round-trip. Routers fetch
        this once and upgrade ``execute_stream`` to exactly-once token
        delivery for these methods (serve/router.py tier 3)."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return []
            return [
                str(m)
                for m in (getattr(st.cls_or_fn, "resumable_streams", ()) or ())
            ]

    def deployment_meta(self, name: str) -> Dict[str, Any]:
        """Code/config properties a router needs once per deployment
        (cached router-side with a TTL): the resumable-streams
        declaration plus the paired prefill-pool name for disaggregated
        serving. One RPC instead of one per property."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return {"resumable_streams": [], "disagg_prefill": None}
            return {
                "resumable_streams": [
                    str(m)
                    for m in (
                        getattr(st.cls_or_fn, "resumable_streams", ()) or ()
                    )
                ],
                "disagg_prefill": st.config.disagg_prefill,
            }

    # -- ingress bucket persistence (serve/ingress.py satellite) ---------
    #: per-door cap on remembered tenants — newest-stamp entries win
    _MAX_BUCKET_TENANTS = 4096

    def save_ingress_buckets(
        self, key: str, buckets: Dict[str, Dict[str, float]]
    ) -> bool:
        """Timer-pushed per-tenant token-bucket fill levels from an
        ingress replica (``{"level": ..., "wall": time.time()}`` per
        tenant). Merged per tenant by NEWEST wall stamp — tenants
        rendezvous onto one door, so cross-replica conflicts are rare
        and recency is the right tiebreak. A replacement replica
        restores from here instead of refilling every tenant's burst."""
        with self._lock:
            table = self._ingress_buckets.setdefault(key, {})
            for tenant, state in buckets.items():
                cur = table.get(tenant)
                if cur is None or float(state.get("wall", 0.0)) >= float(
                    cur.get("wall", 0.0)
                ):
                    table[tenant] = dict(state)
            if len(table) > self._MAX_BUCKET_TENANTS:
                for victim in sorted(
                    table, key=lambda t: float(table[t].get("wall", 0.0))
                )[: len(table) - self._MAX_BUCKET_TENANTS]:
                    del table[victim]
        return True

    def load_ingress_buckets(self, key: str) -> Dict[str, Dict[str, float]]:
        """Snapshot for a (re)starting ingress replica."""
        with self._lock:
            return {
                t: dict(s) for t, s in self._ingress_buckets.get(key, {}).items()
            }

    # -- SLO ledger (observability/slo.py) -------------------------------
    def slo_snapshots(self, timeout_s: float = 10.0) -> Dict[str, Any]:
        """Cluster-wide SLO-ledger collection: every replica of every
        deployment is asked for its ``slo_snapshot`` (latency histogram
        bucket counts, goodput/fault counters, flight-recorder ring,
        intake books). Replicas whose callable has no ledger (plain
        deployments) and dead/slow replicas are skipped — the report is
        built from whoever answers, which is exactly the survivors'
        view an operator wants mid-incident. Returns raw snapshots plus
        ``status()``; ``serve.slo_report()`` merges and quantiles them
        driver-side (where the driver's own router ledger joins in)."""
        with self._lock:
            targets = [
                (name, r)
                for name, st in self._deployments.items()
                for _v, r in st.replicas
            ]
        pending = []
        for name, r in targets:
            try:
                pending.append(
                    (name, r.handle_request.remote("slo_snapshot", [], {}, ""))
                )
            except Exception:  # noqa: BLE001 — dead replica: skip
                pass
        snaps: List[Dict[str, Any]] = []
        # ONE shared deadline across the whole fan-in: N wedged replicas
        # must cost ~timeout_s total, not N*timeout_s of serialized
        # stalls on the controller actor (every other controller RPC —
        # status, scaling, wait_status — queues behind this loop)
        deadline = time.monotonic() + float(timeout_s)
        for name, ref in pending:
            try:
                snap = ray_tpu_torch.get(
                    ref, timeout=max(0.1, deadline - time.monotonic())
                )
            except Exception:  # noqa: BLE001 — no ledger / dead / slow
                continue
            if isinstance(snap, dict):
                snap.setdefault("deployment", name)
                snaps.append(snap)
        return {"snapshots": snaps, "status": self.status()}

    def routes(self) -> Dict[str, str]:
        """route_prefix -> deployment name (proxy routing table)."""
        with self._lock:
            out = {}
            for name, st in self._deployments.items():
                prefix = st.config.route_prefix or f"/{name}"
                out[prefix] = name
            return out

    @staticmethod
    def _pressure_of(st: _DeploymentState) -> Dict[str, Any]:
        """Shed/queue pressure rollup from FRESH replica gossip — what
        lets an operator see shedding and engine backlog straight from
        ``serve.status()`` without scraping /metrics. ``queue_depth`` /
        ``outstanding_tokens`` come from engine replicas
        (``InferenceEngine.routing_stats``); ``shed_total`` from ingress
        replicas (``serve/ingress.py`` gossips its shed counter the same
        way). Stale reports (older than ``serve_routing_stats_ttl_s``)
        are excluded: a wedged replica's last gossip must not pin
        phantom pressure into the status view."""
        now = time.monotonic()
        ttl = GLOBAL_CONFIG.serve_routing_stats_ttl_s
        queue_depth = 0
        outstanding = 0.0
        shed = 0
        ttft = 0.0
        itl = 0.0
        for stats, received in st.replica_stats.values():
            if now - received > ttl:
                continue
            queue_depth += int(stats.get("queue_depth") or 0)
            outstanding += float(stats.get("outstanding_tokens") or 0.0)
            shed += int(stats.get("shed_total") or 0)
            # worst fresh replica's windowed tail latencies — the same
            # signals the autopilot steers on, surfaced for operators
            # and the load harness
            ttft = max(ttft, float(stats.get("ttft_p99_s", 0.0) or 0.0))
            itl = max(itl, float(stats.get("itl_p99_s", 0.0) or 0.0))
        return {
            "queue_depth": queue_depth,
            "outstanding_tokens": round(outstanding, 1),
            "shed_total": shed,
            "ttft_p99_s": round(ttft, 6),
            "itl_p99_s": round(itl, 6),
        }

    def status(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "target": st.target,
                    "replicas": len(st.replicas),
                    "starting": len(st.starting),
                    "draining": len(st.draining),
                    "version": st.version,
                    # rolling-update progress: the roll is done when every
                    # routed replica is on the current version
                    "replicas_current_version": sum(
                        1 for v, _r in st.replicas if v == st.version
                    ),
                    "autoscaling": st.config.autoscaling is not None,
                    "restarts": dict(st.restarts),
                    "last_scale": dict(st.last_scale_info),
                    **self._pressure_of(st),
                }
                for name, st in self._deployments.items()
            }

    def ping(self) -> bool:
        return True

    def shutdown(self) -> bool:
        self._stop.set()
        if self._node_listener_backend is not None:
            try:
                self._node_listener_backend.remove_node_event_listener(
                    self._on_node_event
                )
            except Exception:
                pass
        with self._lock:
            deployments = list(self._deployments.values())
            self._deployments.clear()
        for st in deployments:
            handles = (
                st.replicas
                + [(v, h) for v, h, _t in st.starting]
                + [(v, h) for v, h, _t in st.draining]
            )
            for _v, r in handles:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        with self._change:
            self._change.notify_all()
        return True

    # -- control loop ----------------------------------------------------
    def _control_loop(self) -> None:
        while not self._stop.wait(0.25):
            with self._change:
                self._passes_begun += 1
            try:
                try:
                    self._reconcile_once()
                finally:
                    with self._change:
                        self._passes_ended = self._passes_begun
                        self._change.notify_all()
                self._autoscale_once()
            except Exception:  # noqa: BLE001 — keep the loop alive
                import logging

                logging.getLogger(__name__).exception("serve control loop error")

    def _spawn_replica(self, st: _DeploymentState):
        opts = dict(st.config.ray_actor_options)
        opts.setdefault("max_concurrency", st.config.max_concurrent_queries)
        return Replica.options(**opts).remote(
            st.cls_or_fn, st.init_args, st.init_kwargs, st.name,
            self._registered_namespace,
        )

    def _core_actor_info(self, handle) -> Optional[Dict[str, Any]]:
        """The runtime's actor FSM view for a replica (PENDING or a
        death reason of "no node can host" both mean the cluster can't
        place it — the real resource-stuck signals)."""
        try:
            from ray_tpu_torch.core.api import _global_worker

            be = _global_worker().backend
            return be.io.run(
                be.controller.call(
                    "get_actor_info", {"actor_id": handle.actor_id}
                ),
                timeout=5,
            )
        except Exception:
            return None

    def _replica_node(self, handle) -> Optional[bytes]:
        """Node hosting a replica (cached: replicas never migrate)."""
        key = handle.actor_id
        nid = self._replica_nodes.get(key)
        if nid is not None:
            return nid
        info = self._core_actor_info(handle)
        addr = (info or {}).get("address")
        nid = getattr(addr, "node_id", None)
        if nid is not None:
            if len(self._replica_nodes) > 4096:  # replica-generation churn
                self._replica_nodes.clear()
            self._replica_nodes[key] = nid
        return nid

    def _alive(self, replica) -> Optional[bool]:
        """True=alive, False=dead, None=slow (indeterminate)."""
        try:
            ray_tpu_torch.get(replica.stats.remote(), timeout=5)
            return True
        except ray_tpu_torch.GetTimeoutError:
            return None  # slow ≠ dead
        except Exception:
            return False

    def _reconcile_once(self) -> None:
        with self._reconcile_lock:
            with self._lock:
                states = list(self._deployments.values())
            for st in states:
                changed = False
                # 1. promote starters that became ready; reap only DEAD
                # ones — slow init (large model loads) is normal for TPU
                # replicas and must never trigger a kill/respawn loop
                still_starting: List[Tuple[str, Any, float]] = []
                for v, r, t0 in st.starting:
                    ok = self._alive(r)
                    if ok is True:
                        st.replicas.append((v, r))
                        changed = True
                    elif ok is False:
                        # a starter the RUNTIME failed as unplaceable is
                        # the resource-stuck signal (the core fails such
                        # actors at its lease timeout, typically before
                        # our PENDING-age gate can observe them)
                        info = self._core_actor_info(r)
                        if info and str(info.get("reason", "")).startswith(
                            "no node can host"
                        ):
                            st.unplaceable_ts = time.monotonic()
                        try:
                            ray_tpu_torch.kill(r)
                        except Exception:
                            pass
                    else:
                        still_starting.append((v, r, t0))
                st.starting = still_starting
                # 2. reap dead ready replicas (timeout = overload, keep)
                alive: List[Tuple[str, Any]] = []
                for v, r in st.replicas:
                    ok = self._alive(r)
                    if ok is False:
                        changed = True
                        _count_replica_restart(st, "death")
                        try:
                            ray_tpu_torch.kill(r)
                        except Exception:
                            pass
                    else:
                        alive.append((v, r))
                st.replicas = alive
                # 2a. proactive health: replicas that ANSWER but report
                # unhealthy (replica.health -> the callable's
                # check_health, e.g. the LLM engine's wedged-step-loop
                # detector) are restarted — liveness alone never catches
                # a stalled engine whose actor loop still replies. Own
                # cadence: the 0.25s reconcile pass must not double
                # every replica's RPC load.
                period = GLOBAL_CONFIG.serve_replica_health_period_s
                now_h = time.monotonic()
                if (
                    period > 0
                    and st.replicas
                    and now_h - st.last_health_ts >= period
                ):
                    st.last_health_ts = now_h
                    healthy: List[Tuple[str, Any]] = []
                    for v, r in st.replicas:
                        wedged = False
                        try:
                            wedged = (
                                ray_tpu_torch.get(r.health.remote(), timeout=5)
                                is False
                            )
                        except Exception:
                            # dead/slow/raising: liveness reaping (above,
                            # next pass) owns those — restarting on a
                            # saturated replica's timeout would turn
                            # overload into an outage
                            wedged = False
                        if wedged:
                            changed = True
                            _count_replica_restart(st, "unhealthy")
                            try:
                                ray_tpu_torch.kill(r)
                            except Exception:
                                pass
                        else:
                            healthy.append((v, r))
                    st.replicas = healthy
                # 2b. preemption handoff: replicas on DRAINING nodes are
                # unrouted NOW (routers drop them on the next long-poll
                # push, in-flight requests finish, the drain-kill waits
                # for idle) and replacements start below — all inside the
                # node's drain grace, so clients see zero errors.
                if self._draining_nodes:
                    still_routed: List[Tuple[str, Any]] = []
                    for v, r in st.replicas:
                        nid = self._replica_node(r)
                        if nid is not None and nid in self._draining_nodes:
                            st.draining.append((v, r, time.monotonic()))
                            changed = True
                        else:
                            still_routed.append((v, r))
                    st.replicas = still_routed
                cur = st.version
                ready_cur = [(v, r) for v, r in st.replicas if v == cur]
                ready_old = [(v, r) for v, r in st.replicas if v != cur]
                starting_cur = [s for s in st.starting if s[0] == cur]
                # 3. start replicas: scale-up AND rolling replacement are
                # the same move — keep (ready_cur + starting_cur) headed
                # toward target, start-before-kill. While OLD replicas
                # exist the surge is capped at 1: TPU replicas hold chips,
                # and a full-surge roll could never schedule.
                start_cap = 1 if ready_old else st.target
                while (
                    len(ready_cur) + len(starting_cur) < st.target
                    and len(starting_cur) < start_cap
                ):
                    h = self._spawn_replica(st)
                    entry = (cur, h, time.monotonic())
                    st.starting.append(entry)
                    starting_cur.append(entry)
                # resource-stuck roll: if the new replica can't come up
                # (cluster can't fit target+1 — e.g. all chips held by
                # old replicas), free one old after a grace period; the
                # availability dip is then unavoidable, not a deadlock
                now = time.monotonic()
                # resource-stuck: either a live starter is still PENDING
                # past the grace (cluster can't fit target+1), or the
                # runtime already failed a starter as unplaceable. A
                # placed-but-slow init (big model load) matches neither.
                starter_pending = bool(starting_cur) and (
                    now - min(t for _v, _h, t in starting_cur) > 30
                    and (self._core_actor_info(starting_cur[0][1]) or {}).get(
                        "state"
                    )
                    == "PENDING"
                )
                recently_unplaceable = now - st.unplaceable_ts < 60 and (
                    st.unplaceable_ts > 0
                )
                if (
                    ready_old
                    and (starter_pending or recently_unplaceable)
                    # one eviction per grace period — or every 0.25s pass
                    # would drain another old replica and a slow roll
                    # would cause a full outage
                    and now - st.last_stuck_evict_ts > 30
                ):
                    st.last_stuck_evict_ts = now
                    victim = ready_old.pop(0)
                    st.replicas.remove(victim)
                    st.draining.append((victim[0], victim[1], now))
                    changed = True
                # 4. rolling: once a current-version replica is ready,
                # retire old-version replicas one-for-one (total ready
                # never dips below target while old ones remain). Retire
                # = UNROUTE now, kill only after in-flight requests drain
                # (zero-downtime: a hard kill would fail them).
                while ready_old and len(st.replicas) > st.target:
                    victim = ready_old.pop(0)
                    st.replicas.remove(victim)
                    st.draining.append((victim[0], victim[1], time.monotonic()))
                    changed = True
                # 5. scale down current-version surplus (same drain)
                while not ready_old and len(st.replicas) > st.target:
                    v, r = st.replicas.pop()
                    st.draining.append((v, r, time.monotonic()))
                    changed = True
                # 6. reap drained replicas: kill once idle (or after the
                # 30s drain grace for stuck requests)
                still_draining: List[Tuple[str, Any, float]] = []
                for v, r, t0 in st.draining:
                    idle = False
                    try:
                        idle = (
                            ray_tpu_torch.get(r.stats.remote(), timeout=5)["ongoing"] == 0
                        )
                    except ray_tpu_torch.GetTimeoutError:
                        idle = False  # saturated ≠ idle: wait out the grace
                    except Exception:
                        idle = True  # dead/unreachable: nothing to drain
                    # ≥0.5s in drain before an idle-kill: routers need a
                    # long-poll push cycle to drop the replica from their
                    # cached set, or a just-dispatched request dies
                    if (idle and time.monotonic() - t0 > 0.5) or (
                        time.monotonic() - t0 > 30
                    ):
                        try:
                            ray_tpu_torch.kill(r)
                        except Exception:
                            pass
                    else:
                        still_draining.append((v, r, t0))
                st.draining = still_draining
                with self._lock:
                    if self._deployments.get(st.name) is not st:
                        # state swapped mid-reconcile (redeploy/delete):
                        # hand our replicas to the new state object so
                        # the roll continues from them
                        newer = self._deployments.get(st.name)
                        if newer is not None:
                            newer.replicas = st.replicas
                            newer.starting = st.starting
                            newer.draining = st.draining
                        else:
                            # deleted mid-pass: kill EVERYTHING this pass
                            # touched, incl. starters spawned after the
                            # delete snapshotted its handles
                            handles = (
                                st.replicas
                                + [(v, h) for v, h, _t in st.starting]
                                + [(v, h) for v, h, _t in st.draining]
                            )
                            for _v, r in handles:
                                try:
                                    ray_tpu_torch.kill(r)
                                except Exception:
                                    pass
                if changed:
                    self._bump(st.name)

    def _autoscale_once(self) -> None:
        now = time.monotonic()
        with self._lock:
            all_states = dict(self._deployments)
        states = [s for s in all_states.values() if s.config.autoscaling]
        # disagg prefill pools whose size the decode pool's token mix
        # owns: the ratio decision replaces the queue/SLO decision there
        # (both deployments must exist and the prefill one must opt in
        # by carrying an autoscaling config)
        paired_prefill = {
            st.config.disagg_prefill: st.name
            for st in all_states.values()
            if st.config.disagg_prefill and st.config.disagg_prefill in all_states
        }
        for st in states:
            cfg: AutoscalingConfig = st.config.autoscaling
            if st.name in paired_prefill:
                self._adapt_prefill_pool(
                    st, all_states[paired_prefill[st.name]], cfg, now
                )
                continue
            total = 0.0
            n = 0
            ttft = 0.0
            for _v, r in st.replicas:
                try:
                    total += ray_tpu_torch.get(r.stats.remote(), timeout=5)["ongoing"]
                    n += 1
                except Exception:
                    pass
                # gossip-capable replicas (LLM engines) also report their
                # ADMISSION-QUEUE depth: requests the engine had to park
                # for KV blocks are real unmet demand that the serve-level
                # ongoing count (streams in flight) underplays — fold it
                # into the autoscale signal so a saturated engine scales
                # out before callers hit the queue bound. FRESH reports
                # only: a wedged reporter's last gossip must not pin
                # phantom demand into every future autoscale pass.
                ent = st.replica_stats.get(r.actor_id.hex())
                if ent is not None and (
                    now - ent[1] < GLOBAL_CONFIG.serve_routing_stats_ttl_s
                ):
                    total += float(ent[0].get("queue_depth", 0) or 0)
                    # SLO autopilot signal: the WORST fresh replica's
                    # windowed TTFT p99 — a tail SLO is only as good as
                    # the slowest replica serving it
                    ttft = max(ttft, float(ent[0].get("ttft_p99_s", 0.0) or 0.0))
            # the front door's client-observed first-byte p99 for THIS
            # deployment (ingress replicas gossip target + ttfb_p99_s):
            # the door's clock includes router-side waits — a replica
            # death, dispatch queues — that the engines' own TTFT
            # windows never contain, so a kill that stalls clients
            # burns the budget even while every surviving engine's
            # p99 looks healthy
            for other in all_states.values():
                for stats, received in other.replica_stats.values():
                    if (
                        stats.get("ingress")
                        and stats.get("target") == st.name
                        and now - received
                        < GLOBAL_CONFIG.serve_routing_stats_ttl_s
                    ):
                        ttft = max(
                            ttft, float(stats.get("ttfb_p99_s", 0.0) or 0.0)
                        )
            # no replica answered AND no door is watching: nothing to
            # steer on. But every-replica-dead WITH a fresh ingress
            # signal is exactly when budget burn must still scale out —
            # the replacement logic restores count, the burn decision
            # raises it
            if n == 0 and ttft <= 0.0:
                continue
            desired, reason = autoscale_decision(
                target=st.target, cfg=cfg, total_load=total, ttft_p99_s=ttft
            )
            self._apply_scale(st, cfg, desired, reason, now)

    def _apply_scale(
        self,
        st: _DeploymentState,
        cfg: AutoscalingConfig,
        desired: int,
        reason: str,
        now: float,
    ) -> None:
        """Delay-gated target write shared by every autoscale path —
        records the applied decision for status()/harness lag scoring."""
        delay = (
            cfg.upscale_delay_s if desired > st.target else cfg.downscale_delay_s
        )
        if desired != st.target and now - st.last_scale_ts >= delay:
            prev = st.target
            st.target = desired
            st.last_scale_ts = now
            st.last_scale_info = {
                "ts": time.time(),
                "from": prev,
                "to": desired,
                "reason": reason,
            }
            _count_autoscale_decision(st.name, reason)

    def _adapt_prefill_pool(
        self,
        st: _DeploymentState,
        decode_st: _DeploymentState,
        cfg: AutoscalingConfig,
        now: float,
    ) -> None:
        """Adapt a disagg prefill pool's size to the observed
        prefill:decode token mix (both rates from fresh engine gossip —
        prefill throughput reported by the prefill pool, decode
        throughput by the decode pool)."""
        ttl = GLOBAL_CONFIG.serve_routing_stats_ttl_s

        def _rate(state: _DeploymentState, key: str) -> float:
            return sum(
                float(stats.get(key, 0.0) or 0.0)
                for stats, received in state.replica_stats.values()
                if now - received <= ttl
            )

        desired, reason = pool_ratio_decision(
            prefill_target=st.target,
            n_decode=len(decode_st.replicas),
            prefill_tokens_per_s=_rate(st, "prefill_tokens_per_s"),
            decode_tokens_per_s=_rate(decode_st, "decode_tokens_per_s"),
            min_replicas=cfg.min_replicas,
            max_replicas=cfg.max_replicas,
        )
        self._apply_scale(st, cfg, desired, reason, now)


ServeController = ray_tpu_torch.remote(_ServeController)


def get_or_create_controller():
    # get_if_exists handles the named-actor creation race internally
    # (actor.py) and real creation failures surface as themselves.
    # long-polls park a thread each for up to 30s; a dedicated
    # concurrency group keeps any number of routers from starving
    # deploy/status/get_replicas lanes
    try:
        ns = ray_tpu_torch.get_runtime_context().namespace
    except Exception:
        ns = None
    return ServeController.options(
        name=CONTROLLER_NAME,
        num_cpus=0,
        max_concurrency=16,
        concurrency_groups={"longpoll": 32},
        get_if_exists=True,
    ).remote(ns)
