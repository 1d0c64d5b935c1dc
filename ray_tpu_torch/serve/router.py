"""Router: cache-affinity + load-scored replica choice, pow-2 fallback.

Reference: ``serve/_private/replica_scheduler/pow_2_scheduler.py:52`` —
sample two replicas, compare queue lengths, send to the shorter — fed by
``long_poll.py``: the replica list arrives via a controller long-poll
(a background thread parks in ``poll_replicas`` and wakes the moment
the routing set changes), not a periodic poll. Deploys/scale-ups/
replica deaths propagate to routers in milliseconds.

LLM-aware routing (the multi-replica serving tentpole): replicas that
gossip routing stats (load in OUTSTANDING TOKENS + a compact digest of
their prefix cache, pushed replica -> controller -> long-poll) are
scored instead of sampled: ``score = outstanding_tokens + local_bump -
affinity_weight * matched_prefix_tokens``, lowest wins. A conversation
whose system prompt is warm on replica A costs A nothing to prefill, so
A wins until its queue outweighs the cache benefit — locality-aware
scheduling exactly as the Ray paper frames it, with the blend weight as
the knob. The scored path engages ONLY when every candidate has fresh
gossip (``serve_routing_stats_ttl_s``); stale or absent signals fall
back to pow-2 over cached queue lengths — a wrong load guess
self-corrects, a stale digest would keep dogpiling one replica.

Execution semantics (reference ``router.py``): ``execute``/
``execute_stream`` are retry-until-executed — a dispatch that races a
replica death re-chooses among the survivors instead of surfacing
ActorDiedError to the caller (what keeps rolling updates zero-drop).
The raw ``dispatch`` remains at-most-once for callers that manage
their own refs. Streams of methods a deployment declares in
``resumable_streams`` get the strongest tier: seq-numbered items,
mid-stream replica death resumed on a survivor with the prompt
extended by the already-delivered tokens, duplicates suppressed —
exactly-once token delivery (see ``execute`` for the full three-tier
contract).

Model multiplexing: a request carrying ``model_id`` prefers replicas
whose cached stats report that model loaded (reference model-aware
replica scheduling), falling back to pow-2 over all replicas."""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.deadline import Deadline, effective_timeout
from ray_tpu_torch.core.exceptions import ActorDiedError, WorkerCrashedError
from ray_tpu_torch.core.rpc import ConnectionLost
from ray_tpu_torch.core.streaming import SeqGate, TokenChunk
from ray_tpu_torch.observability import tracing as _tracing

_STATS_TTL_S = 0.25

#: failures that mean "the replica is gone", never "the request is bad" —
#: the only class a resumable stream may fail over on (an app-level
#: exception from the callable must propagate: replaying it would just
#: raise it twice)
_REPLICA_GONE = (ActorDiedError, WorkerCrashedError, ConnectionLost)

#: consecutive zero-progress failover attempts before a resumable stream
#: gives up: every successful token resets the count, so this only trips
#: when replicas die faster than they can deliver a single token
_MAX_BARREN_RESUMES = 5

#: refresh window for the deployment's resumable_streams declaration — a
#: redeploy can change the callable, and a handle outliving it must not
#: pin the old contract forever (bounded staleness, one controller call
#: per window per router)
_RESUMABLE_META_TTL_S = 30.0


def _count_decision(deployment: str, policy: str, affinity_hit: bool = False) -> None:
    from ray_tpu_torch.observability.rpc_metrics import (
        ROUTER_AFFINITY_HITS,
        ROUTER_DECISIONS,
    )

    ROUTER_DECISIONS.inc(labels={"deployment": deployment, "policy": policy})
    if affinity_hit:
        ROUTER_AFFINITY_HITS.inc(labels={"deployment": deployment})


def _count_stream_resume(deployment: str, replayed_tokens: int) -> None:
    from ray_tpu_torch.observability.rpc_metrics import (
        STREAM_RESUME_REPLAY_TOKENS,
        STREAM_RESUMES,
    )
    from ray_tpu_torch.observability.slo import slo_metrics

    STREAM_RESUMES.inc(labels={"deployment": deployment})
    if replayed_tokens > 0:
        STREAM_RESUME_REPLAY_TOKENS.inc(replayed_tokens)
        # the same increment feeds the SLO ledger's fault-cost split:
        # replayed tokens are work a fault forced (mostly absorbed by
        # the survivor's radix cache, but never goodput)
        slo_metrics()["fault"].inc(
            replayed_tokens,
            labels={"deployment": deployment, "reason": "resume_replay"},
        )


def _request_prompt(args) -> Optional[List[int]]:
    """Token prompt of an LLM-shaped request payload (the affinity
    scorer's input), or None for anything else."""
    if not args:
        return None
    req = args[0]
    if isinstance(req, dict):
        prompt = req.get("prompt")
        if isinstance(prompt, (list, tuple)) and prompt:
            return list(prompt)
    return None


def _poll_loop(router_ref: "weakref.ref", controller, deployment: str) -> None:
    """Long-poll thread body. Holds only a WEAK ref to its router: when
    the handle (and router) are garbage-collected, the thread notices on
    its next wakeup and exits — dropped handles must not park controller
    long-poll slots forever."""
    version = -1  # first poll returns immediately with current state
    while True:
        r = router_ref()
        if r is None or r._closed:
            return
        del r
        try:
            version, routing_set = ray_tpu_torch.get(
                controller.poll_replicas.remote(deployment, version, 30.0),
                timeout=45,
            )
            r = router_ref()
            if r is None or r._closed:
                return
            r._apply(routing_set)
            del r
        except Exception:
            # controller briefly unavailable: back off, keep serving
            # from the cached set
            time.sleep(0.5)


class Router:
    def __init__(self, controller, deployment: str):
        self._controller = controller
        self._deployment = deployment
        self._replicas: List[Any] = []
        self._replicas_lock = threading.Lock()
        self._have_replicas = threading.Event()
        # replica -> (fetched_at, ongoing + local optimistic bumps):
        # fresh stats RPCs per dispatch would double request latency and
        # add 2x load (the reference compares CACHED queue lengths)
        self._stats: dict = {}
        # replica actor_id -> loaded model ids (controller-pushed)
        self._models: dict = {}
        # replica actor_id -> (received_at_local, routing stats dict,
        # digest set, report stamp) — controller-relayed gossip for
        # scored routing; aged on OUR monotonic clock (controller ships
        # age_s at poll time, clocks don't compare across processes);
        # the stamp identifies the underlying REPORT so re-relays of an
        # unchanged one are recognizable
        self._rstats: Dict[Any, tuple] = {}
        # replica actor_id -> optimistic token bump: requests dispatched
        # since that replica's last gossip (cleared by fresher gossip) so
        # a burst inside one gossip period spreads instead of dogpiling
        self._local_tokens: Dict[Any, float] = {}
        # cluster KV-tier directory (PR 17): chain-digest hex ->
        # (descriptor, holder actor_id, refreshed_at). Fed by the
        # replicas' "kv_tier" routing-gossip adverts; a LIVE holder
        # dropping a digest from its advert set RETRACTS the entry in
        # one gossip hop, while a DEAD holder's entries linger for
        # kv_tier_advert_ttl_s — the daemon, not the replica process,
        # owns the bytes, and a warm replacement re-adverts them
        self._tier_dir: Dict[str, tuple] = {}
        # replica actor_id -> frozenset of advertised digest hexes (the
        # previous report's view, diffed per report for retraction)
        self._tier_adverts: Dict[Any, frozenset] = {}
        self._poller_started = False
        self._poller_lock = threading.Lock()
        #: deployment meta (resumable_streams declaration + paired
        #: disagg prefill pool), fetched lazily from the serve
        #: controller and cached with a TTL
        self._meta: Optional[Dict[str, Any]] = None
        self._meta_fetched_at = 0.0
        #: lazily-built router for the paired prefill-pool deployment
        #: (disaggregated serving two-stage dispatch)
        self._prefill_router: Optional["Router"] = None
        self._closed = False

    def close(self) -> None:
        self._closed = True

    def __del__(self):
        self._closed = True

    # -- push subscription ----------------------------------------------
    def _ensure_poller(self) -> None:
        with self._poller_lock:
            if self._poller_started:
                return
            self._poller_started = True
            threading.Thread(
                target=_poll_loop,
                args=(weakref.ref(self), self._controller, self._deployment),
                daemon=True,
                name=f"serve-router-{self._deployment}",
            ).start()

    def _apply(self, routing_set: List[Any]) -> None:
        """routing_set entries from the controller's long-poll:
        ``(handle, loaded_model_ids)`` pairs (legacy) or ``(handle,
        loaded_model_ids, stats_entry)`` triples, where ``stats_entry``
        is None or ``{"stats": <routing gossip>, "age_s": <age at poll
        time>}`` for gossip-capable (LLM) replicas."""
        now = time.monotonic()
        replicas, models, rstats = [], {}, {}
        for entry in routing_set:
            handle, mids = entry[0], entry[1]
            replicas.append(handle)
            models[handle.actor_id] = tuple(mids)
            stats_entry = entry[2] if len(entry) > 2 else None
            if stats_entry is not None:
                stats = stats_entry["stats"]
                received = now - float(stats_entry.get("age_s", 0.0))
                digest = frozenset(stats.get("prefix_digest") or ())
                stamp = stats_entry.get("stamp")
                rstats[handle.actor_id] = (received, stats, digest, stamp)
        with self._replicas_lock:
            self._replicas = replicas
            self._models = models
            live = set(models)
            self._stats = {k: v for k, v in self._stats.items() if k in live}
            for aid, ent in rstats.items():
                prev = self._rstats.get(aid)
                self._rstats[aid] = ent
                if prev is None or ent[3] != prev[3]:
                    # a genuinely NEW report already reflects what we
                    # dispatched — drop the optimistic bump. Comparing
                    # the report STAMP, not reconstructed receipt times:
                    # every routing-set relay recomputes received as
                    # now-age_s, so delivery jitter alone would look
                    # "fresher" and wipe bumps mid-burst.
                    self._local_tokens.pop(aid, None)
            self._rstats = {k: v for k, v in self._rstats.items() if k in live}
            self._local_tokens = {
                k: v for k, v in self._local_tokens.items() if k in live
            }
            retractions = 0
            for aid, ent in rstats.items():
                adverts = ent[1].get("kv_tier") or {}
                advert_set = frozenset(adverts)
                prev_set = self._tier_adverts.get(aid)
                if prev_set:
                    # a digest a LIVE holder stopped advertising was
                    # evicted from its daemon's tier: purge in one hop
                    # instead of letting fault-ins chase it to a miss
                    for gone in prev_set - advert_set:
                        cur = self._tier_dir.get(gone)
                        if cur is not None and cur[1] == aid:
                            del self._tier_dir[gone]
                            retractions += 1
                for dh, desc in adverts.items():
                    self._tier_dir[dh] = (desc, aid, now)
                self._tier_adverts[aid] = advert_set
            self._tier_adverts = {
                k: v for k, v in self._tier_adverts.items() if k in live
            }
            if self._tier_dir:
                # dead-holder retention: keep the entry (the daemon may
                # still serve it to a warm replacement) but not forever
                ttl = GLOBAL_CONFIG.kv_tier_advert_ttl_s
                self._tier_dir = {
                    dh: ent for dh, ent in self._tier_dir.items()
                    if ent[1] in live or now - ent[2] < ttl
                }
        if retractions:
            from ray_tpu_torch.observability.rpc_metrics import KV_TIER_RETRACTIONS

            KV_TIER_RETRACTIONS.inc(retractions)
        if replicas:
            self._have_replicas.set()
        else:
            self._have_replicas.clear()

    def _drop_replica(self, replica) -> None:
        """Locally remove a replica observed dead — the controller push
        will confirm shortly, but requests in THIS window must not keep
        choosing the corpse."""
        with self._replicas_lock:
            self._replicas = [
                r for r in self._replicas if r.actor_id != replica.actor_id
            ]
            self._stats.pop(replica.actor_id, None)
            self._models.pop(replica.actor_id, None)
            self._rstats.pop(replica.actor_id, None)
            self._local_tokens.pop(replica.actor_id, None)
            # death is NOT retraction: the holder's daemon still has the
            # tier bytes, so _tier_dir entries stay (TTL-bounded) for the
            # resume that is about to need them — only the per-actor
            # advert view goes, there will be no more reports to diff
            self._tier_adverts.pop(replica.actor_id, None)
            if not self._replicas:
                self._have_replicas.clear()

    # -- choice ----------------------------------------------------------
    def choose_replica(self, model_id: str = "", request_args=None, wait_s: float = 30.0):
        self._ensure_poller()
        if not self._have_replicas.wait(timeout=wait_s):
            raise RuntimeError(f"no replicas for deployment {self._deployment!r}")
        with self._replicas_lock:
            replicas = list(self._replicas)
        if not replicas:
            # raced a scale-to-zero push
            return self.choose_replica(model_id, request_args, wait_s)
        if model_id:
            # model-aware: prefer replicas the controller says already
            # hold the model (replica-pushed, so no stats-TTL staleness)
            with_model = [
                r for r in replicas
                if model_id in self._models.get(r.actor_id, ())
            ]
            if with_model:
                replicas = with_model
        if len(replicas) == 1:
            _count_decision(self._deployment, "single")
            return replicas[0]
        chosen, fallback = self._choose_scored(replicas, request_args)
        if chosen is not None:
            return chosen
        a, b = random.sample(replicas, 2)
        qa, qb = self._queue_len(a), self._queue_len(b)
        # a gossip-capable deployment falling back on STALE signals is a
        # DIFFERENT condition than a plain deployment (never had stats)
        # or an all-draining window (fresh gossip, nothing routable):
        # split it out so load tests can assert the scored path actually
        # engaged — a run whose decisions are all stale_fallback means
        # the gossip cadence (or TTL) is mistuned
        with self._replicas_lock:
            had_gossip = bool(self._rstats)
        _count_decision(
            self._deployment,
            "stale_fallback" if (fallback == "stale" and had_gossip) else "pow2",
        )
        return a if qa <= qb else b

    def _choose_scored(self, replicas, request_args):
        """Least-outstanding-tokens blended with prefix affinity, over
        replica-gossiped stats. Returns ``(choice, None)``, or
        ``(None, reason)`` (→ pow-2 fallback) — ``reason`` is "stale"
        unless EVERY candidate has gossip fresher than the staleness TTL
        (a replica without fresh signals scored at an assumed load would
        either starve or drown), or "draining" when the signals are
        fresh but every candidate is draining (an attributably different
        condition — fallback counters must not blame the gossip)."""
        now = time.monotonic()
        ttl = GLOBAL_CONFIG.serve_routing_stats_ttl_s
        entries = []
        with self._replicas_lock:
            for r in replicas:
                ent = self._rstats.get(r.actor_id)
                if ent is None or now - ent[0] > ttl:
                    return None, "stale"  # absent/stale signal: fall back
                entries.append((r, ent[1], ent[2]))
            bumps = dict(self._local_tokens)
        prompt = _request_prompt(request_args)
        prompt_hashes: List[int] = []
        block_size = 0
        if prompt is not None:
            block_size = int(entries[0][1].get("block_size") or 0)
            if block_size > 0 and len(prompt) >= block_size:
                from ray_tpu_torch.inference.kv_cache import prefix_block_hashes

                prompt_hashes = prefix_block_hashes(prompt, block_size)
        weight = GLOBAL_CONFIG.serve_affinity_weight
        best = None
        best_key = None
        best_matched = 0
        for r, stats, digest in entries:
            if stats.get("draining"):
                continue
            matched = 0
            if prompt_hashes and digest:
                # consecutive-prefix match: a hit on block k only helps
                # if blocks 0..k-1 are warm too (the engine acquires the
                # LONGEST cached prefix, nothing past the first miss)
                for h in prompt_hashes:
                    if h not in digest:
                        break
                    matched += 1
            matched_tokens = matched * block_size
            load = float(stats.get("outstanding_tokens", 0.0)) + bumps.get(
                r.actor_id, 0.0
            )
            key = (load - weight * matched_tokens, load)
            if best_key is None or key < best_key:
                best, best_key, best_matched = r, key, matched_tokens
        if best is None:
            return None, "draining"  # every gossiping replica is draining
        # optimistic local debit: what this dispatch will add to the
        # winner's backlog before its next gossip lands
        est = 64.0
        if prompt is not None:
            est = max(1.0, len(prompt) - best_matched) + 64.0
        with self._replicas_lock:
            self._local_tokens[best.actor_id] = (
                self._local_tokens.get(best.actor_id, 0.0) + est
            )
        _count_decision(
            self._deployment, "affinity", affinity_hit=best_matched > 0
        )
        return best, None

    def cluster_pressure(self) -> Dict[str, Any]:
        """Aggregate gossiped engine pressure over the current routing
        set — the ingress tier's shed signal (serve/ingress.py). Sums
        FRESH reports only (``serve_routing_stats_ttl_s``); the local
        optimistic bumps (requests this router dispatched since each
        replica's last gossip) are folded into ``outstanding_tokens`` so
        a burst inside one gossip period registers as pressure
        immediately instead of after the next report lands.

        Non-blocking by design: a shed decision must cost a dict scan,
        never a controller round-trip — with no replicas (or no gossip)
        yet, ``reporting`` is 0 and the caller decides (the ingress
        admits: never shed blind)."""
        self._ensure_poller()
        now = time.monotonic()
        ttl = GLOBAL_CONFIG.serve_routing_stats_ttl_s
        with self._replicas_lock:
            n = len(self._replicas)
            entries = list(self._rstats.values())
            local = sum(self._local_tokens.values())
        queue_depth = 0
        outstanding = 0.0
        max_queue = 0
        reporting = 0
        itl = 0.0
        ttft = 0.0
        for received, stats, _digest, _stamp in entries:
            if now - received > ttl:
                continue
            reporting += 1
            queue_depth += int(stats.get("queue_depth") or 0)
            outstanding += float(stats.get("outstanding_tokens") or 0.0)
            max_queue += int(stats.get("max_queue_depth") or 0)
            # SLO autopilot signals: the WORST fresh replica's windowed
            # tail latencies — the ingress derives its load watermark
            # from measured ITL (effective_shed_threshold), and a tail
            # SLO is only as good as the slowest replica serving it
            itl = max(itl, float(stats.get("itl_p99_s", 0.0) or 0.0))
            ttft = max(ttft, float(stats.get("ttft_p99_s", 0.0) or 0.0))
        return {
            "replicas": n,
            "reporting": reporting,
            "queue_depth": queue_depth,
            "outstanding_tokens": outstanding + local,
            "max_queue_depth": max_queue,
            "itl_p99_s": itl,
            "ttft_p99_s": ttft,
        }

    def _queue_len(self, replica) -> float:
        now = time.monotonic()
        key = replica.actor_id
        entry = self._stats.get(key)
        if entry is not None and now - entry[0] < _STATS_TTL_S:
            return entry[1]
        try:
            ongoing = float(
                ray_tpu_torch.get(replica.stats.remote(), timeout=10)["ongoing"]
            )
        except Exception:
            ongoing = 0.0
        self._stats[key] = (now, ongoing)
        return ongoing

    def _bump(self, replica) -> None:
        # optimistic local bump so a burst within the TTL window spreads
        # instead of dogpiling the momentarily-shortest queue
        entry = self._stats.get(replica.actor_id)
        if entry is not None:
            self._stats[replica.actor_id] = (entry[0], entry[1] + 1.0)

    # -- dispatch ---------------------------------------------------------
    def dispatch(self, method: str, args, kwargs, model_id: str = ""):
        """At-most-once: returns the replica call's ObjectRef."""
        # a serve request is a trace ENTRY POINT: sample a root here (or
        # inherit the caller's ambient trace) so the replica push — and
        # everything the replica does — parents to this dispatch span
        with _tracing.root_span(
            f"serve::{self._deployment}.{method}", "serve"
        ):
            replica = self.choose_replica(model_id, args)
            self._bump(replica)
            return replica.handle_request.remote(
                method, list(args), dict(kwargs or {}), model_id
            )

    def dispatch_stream(self, method: str, args, kwargs, model_id: str = ""):
        """Streaming call: returns the replica generator's ref iterator."""
        with _tracing.root_span(
            f"serve::{self._deployment}.{method}", "serve"
        ):
            replica = self.choose_replica(model_id, args)
            self._bump(replica)
            return replica.handle_request_streaming.options(
                num_returns="streaming"
            ).remote(method, list(args), dict(kwargs or {}), model_id)

    def execute(
        self,
        method: str,
        args,
        kwargs,
        *,
        model_id: str = "",
        timeout: Optional[float] = 60.0,
        idempotent: bool = True,
    ):
        """Retry-until-executed (reference router semantics): a dispatch
        that lands on a dying replica re-chooses. App-level exceptions
        are NOT retried — only replica death/crash.

        RETRY CONTRACT — three tiers, strongest guarantee that each call
        shape can soundly get:

        1. **Idempotent auto-retry** (``idempotent=True``, the default):
           retry-until-executed across ANY failure, including replica
           death. At-least-once — the runtime cannot tell "replica died
           before it saw the push" apart from "replica executed (part
           of) the request, then died", so a non-idempotent request (a
           payment, an append) can run twice after an unlucky crash.
           Only sound for idempotent handlers.
        2. **Exactly-once while reachable** (``idempotent=False``):
           auto-retry is confined to the provably-safe cases. While the
           chosen replica is REACHABLE every retry rides the RPC layer's
           request-id dedup (core/rpc.py via core_worker request-id
           reuse): a lost reply or transient connection reset is
           answered from the replica's reply cache instead of
           re-executing. Submission-side failures (the push provably
           never reached a replica) re-choose freely. A post-dispatch
           replica DEATH propagates — the reply cache died with the
           process, so the caller owns the cross-replica decision.
        3. **Exactly-once token delivery for resumable streams**
           (``execute_stream`` on methods the deployment declares in
           its callable's ``resumable_streams``): items carry a
           per-request monotonic seq; a mid-stream replica death is
           resumed on a survivor with the original prompt extended by
           the already-delivered tokens and ``resume_from=seq``, and
           the SeqGate suppresses boundary duplicates — the
           client-visible sequence has no gaps and no repeats even
           across multiple deaths. REPLAY-SAFETY CAVEAT: resume is only
           sound for side-effect-free DETERMINISTIC generation (same
           params + request seed + prompt → same items; the engine keys
           sampling on ``(seed, position)`` for exactly this). A stream
           with external side effects per item, or nondeterministic
           items, must not be declared resumable — the replayed prefix
           would re-run its effects or fork the sequence.
           Non-resumable streams keep the old contract: replay only
           before the first item, mid-stream death propagates.

        One Deadline covers the whole call (core/deadline.py): dispatch
        retries AND the result get draw from the same budget, clamped by
        any ambient deadline of the caller — inner timeouts never stack."""
        budget = effective_timeout(timeout)
        deadline = Deadline.after(budget if budget is not None else 3600)
        last_err: Optional[Exception] = None
        # trace root covering dispatch retries AND the result get: the
        # replica-side spans parent to this one
        with _tracing.root_span(f"serve::{self._deployment}.{method}", "serve"):
            while not deadline.expired:
                # the replica wait honors the SAME deadline as the call:
                # blocking 30s for a replacement inside a 2s-budget call
                # and then dispatching anyway would return results after
                # the caller's deadline instead of failing it honestly
                replica = self.choose_replica(
                    model_id, args, wait_s=max(1.0, deadline.remaining())
                )
                self._bump(replica)
                try:
                    ref = replica.handle_request.remote(
                        method, list(args), dict(kwargs or {}), model_id
                    )
                except (ActorDiedError, WorkerCrashedError) as e:
                    # submission failed: the request never reached a
                    # replica, safe to re-choose even for non-idempotent
                    # work
                    last_err = e
                    self._drop_replica(replica)
                    continue
                try:
                    remaining = max(1.0, deadline.remaining())
                    return ray_tpu_torch.get(ref, timeout=remaining)
                except (ActorDiedError, WorkerCrashedError) as e:
                    last_err = e
                    self._drop_replica(replica)
                    if not idempotent:
                        # the push may have been delivered and executed —
                        # replaying could duplicate a side effect
                        raise
                    continue
        raise last_err or TimeoutError(
            f"no replica executed {self._deployment}.{method} in time"
        )

    # -- resumable streams -------------------------------------------------
    def _deployment_meta(self) -> Dict[str, Any]:
        """Deployment code/config meta (resumable-streams declaration +
        paired disagg prefill pool), read from the serve controller and
        cached with a TTL — both are properties of the deployed CODE/
        CONFIG, which a redeploy can change under a long-lived handle."""
        cached = self._meta
        if (
            cached is not None
            and time.monotonic() - self._meta_fetched_at < _RESUMABLE_META_TTL_S
        ):
            return cached
        try:
            meta = dict(
                ray_tpu_torch.get(
                    self._controller.deployment_meta.remote(self._deployment),
                    timeout=10,
                )
            )
        except Exception:
            # controller briefly unreachable (failover): serve the stale
            # cache if there is one, else the legacy contract — and
            # retry on the next call either way
            return cached if cached is not None else {
                "resumable_streams": [], "disagg_prefill": None,
            }
        self._meta = meta
        self._meta_fetched_at = time.monotonic()
        return meta

    def _resumable_methods(self) -> frozenset:
        return frozenset(self._deployment_meta().get("resumable_streams") or ())

    # -- cluster KV tier (PR 17) -------------------------------------------
    def _tier_attach(self, prompt: List[int]) -> Optional[Dict[str, Any]]:
        """Longest consecutive root-anchored chain of tier-advertised
        prefix blocks covering ``prompt``, as the ``kv_tier`` request
        spec (``{"blocks": [[digest_hex, desc], ...], "tokens": n}``) —
        or None when the directory covers nothing. The chain digest is
        recomputed HERE from the request's own tokens, so a matched
        descriptor provably holds KV for exactly this prefix (same
        capability-name scheme the replica re-verifies on commit).
        Chains stop one token short of the full prompt: admission needs
        a tail to prefill, exactly like the disagg import."""
        with self._replicas_lock:
            if not self._tier_dir:
                return None
            tier_dir = dict(self._tier_dir)
        from ray_tpu_torch.inference.kv_cache import _chain_digest

        bs = 0
        for ent in tier_dir.values():
            bs = int(ent[0].get("block_size") or 0)
            if bs > 0:
                break
        if bs <= 0 or len(prompt) <= bs:
            return None
        blocks: List[Any] = []
        prev = b""
        for i in range((len(prompt) - 1) // bs):
            d = _chain_digest(
                prev, tuple(int(t) for t in prompt[i * bs : (i + 1) * bs])
            )
            ent = tier_dir.get(d.hex())
            if ent is None:
                break
            blocks.append([d.hex(), ent[0]])
            prev = d
        if not blocks:
            return None
        return {"blocks": blocks, "tokens": len(blocks) * bs}

    def _tier_resume_spec(
        self, prompt: List[int], wait_s: float = 0.0
    ) -> tuple:
        """Tier chain for a RESUME attempt: ``(spec_or_None, covered)``
        where ``covered`` means the chain reaches everything but the
        sub-block tail — the resume is then a fault-in, not a replay,
        and the replay counters must not grow. ``wait_s`` bounds a brief
        poll for adverts still in flight through the gossip (the live-
        migration window: the source flushed its KV a beat ago and the
        stats report carrying the adverts may not have landed yet)."""
        deadline = time.monotonic() + wait_s

        def _covers(spec) -> bool:
            if spec is None:
                return False
            bs = int(spec["tokens"]) // max(1, len(spec["blocks"]))
            return int(spec["tokens"]) >= len(prompt) - bs

        spec = self._tier_attach(prompt)
        while not _covers(spec) and time.monotonic() < deadline:
            time.sleep(0.05)
            spec = self._tier_attach(prompt)
        return spec, _covers(spec)

    # -- disaggregated prefill/decode handoff ------------------------------
    def _disagg_handoff(
        self,
        prefill_dep: str,
        req: Dict[str, Any],
        model_id: str,
        caller_budget: Optional[float] = None,
    ) -> None:
        """Two-stage dispatch, stage one: run the prompt's prefill on
        the PREFILL pool (scored dispatch like any request) and attach
        the returned KV descriptor, so the decode-pool replica imports
        the prompt KV instead of recomputing it. Every failure rung —
        short prompt, prefill-pool death, handoff timeout, empty export
        — degrades to plain single-replica generation (the descriptor
        simply isn't attached) and is counted on
        ``raytpu_kv_migration_fallbacks_total``; the stream itself never
        fails because of the handoff."""
        from ray_tpu_torch.inference.kv_transfer import (
            count_fallback,
            migration_metrics,
        )

        prompt = req.get("prompt") or []
        if len(prompt) < GLOBAL_CONFIG.serve_disagg_min_prompt_tokens:
            count_fallback("short_prompt")
            return
        with self._replicas_lock:
            pr = self._prefill_router
        if pr is None or pr._deployment != prefill_dep:
            pr = Router(self._controller, prefill_dep)
            with self._replicas_lock:
                self._prefill_router = pr
        # the handoff spends the CALLER's budget: blocking the full
        # handoff timeout inside a shorter-deadline stream would delay
        # the decode dispatch past the point the caller already gave up
        # (the same contract the choose_replica clamp enforces)
        handoff_timeout = GLOBAL_CONFIG.serve_disagg_handoff_timeout_s
        if caller_budget is not None:
            handoff_timeout = min(handoff_timeout, caller_budget)
        t0 = time.monotonic()
        try:
            desc = pr.execute(
                "prefill_export",
                [{
                    "prompt": [int(t) for t in prompt],
                    "priority": int(req.get("priority", 0)),
                    "request_id": f"{req['request_id']}.pf",
                }],
                {},
                model_id=model_id,
                timeout=handoff_timeout,
            )
        except Exception:  # noqa: BLE001 — any handoff failure → fallback
            count_fallback("prefill_dispatch")
            return
        if not desc:
            count_fallback("empty_export")
            return
        req["kv_import"] = desc
        migration_metrics()["handoff"].observe(time.monotonic() - t0)

    def execute_stream(
        self,
        method: str,
        args,
        kwargs,
        *,
        model_id: str = "",
        timeout: Optional[float] = 60.0,
    ):
        """Streaming with dispatch retry. Two contracts (tier 2 vs tier
        3 of the ``execute`` docstring):

        * methods the deployment declares in ``resumable_streams`` (and
          whose request is LLM-shaped: a dict with a token ``prompt``)
          get EXACTLY-ONCE TOKEN DELIVERY — mid-stream replica death is
          resumed on a survivor with the prompt extended by the
          already-delivered tokens, duplicates suppressed, no gaps and
          no repeats across any number of deaths;
        * everything else re-chooses only if the stream dies BEFORE the
          first item (nothing was delivered, trivially safe to replay);
          mid-stream death propagates — replaying would duplicate items.

        The Deadline budget covers dispatch + time-to-first-item (and is
        re-armed per failover attempt on the resumable path); after
        that, each item get inherits the CALLER's timeout (None = wait
        forever) — a slow producer mid-stream is backpressure, not a
        dispatch failure, so it must not trip a fixed 60s timer."""
        if method in self._resumable_methods():
            req = args[0] if args and isinstance(args[0], dict) else None
            if req is not None and _request_prompt(args) is not None:
                return self._execute_stream_resumable(
                    method, req, list(args[1:]), kwargs,
                    model_id=model_id, timeout=timeout,
                )
        budget = effective_timeout(timeout)
        deadline = Deadline.after(budget if budget is not None else 3600)
        # per-item patience once streaming: the caller's timeout with any
        # tighter ambient deadline already folded in; None = wait forever
        item_timeout = budget
        last_err: Optional[Exception] = None
        # trace root spanning dispatch → first item (the serve TTFT
        # window); the replica's streaming task span parents to it
        with _tracing.root_span(f"serve::{self._deployment}.{method}", "serve"):
            while not deadline.expired:
                replica = self.choose_replica(
                    model_id, args, wait_s=max(1.0, deadline.remaining())
                )
                self._bump(replica)
                gen = replica.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(method, list(args), dict(kwargs or {}), model_id)
                try:
                    # bounded time-to-first-item: a replica stuck before
                    # its first yield must not park this request forever
                    first_ref = gen.next_with_timeout(
                        max(1.0, deadline.remaining())
                    )
                    first = ray_tpu_torch.get(
                        first_ref, timeout=max(1.0, deadline.remaining())
                    )
                except StopIteration:
                    def _empty():
                        return
                        yield  # pragma: no cover
                    return _empty()
                except (ActorDiedError, WorkerCrashedError) as e:
                    last_err = e
                    self._drop_replica(replica)
                    continue
                def _rest(first=first, gen=gen):
                    try:
                        # TokenChunk = a producer-coalesced burst (one
                        # ref per engine wake-up); flatten so consumers
                        # see the per-token stream. Bare lists pass
                        # through — a generic stream may yield them as
                        # VALUES.
                        if isinstance(first, TokenChunk):
                            yield from first
                        else:
                            yield first
                        for ref in gen:
                            item = ray_tpu_torch.get(ref, timeout=item_timeout)
                            if isinstance(item, TokenChunk):
                                yield from item
                            else:
                                yield item
                    finally:
                        # consumer done OR walked away (close()/GC — an
                        # HTTP client disconnect closes this generator):
                        # release the ref stream and cooperatively cancel
                        # a still-running producer so the replica's
                        # engine request is cancelled and frees its KV
                        # blocks instead of decoding for nobody
                        gen.abandon()

                return _rest()
        raise last_err or TimeoutError(
            f"no replica started stream {self._deployment}.{method} in time"
        )

    def _execute_stream_resumable(
        self,
        method: str,
        req: Dict[str, Any],
        extra_args: List[Any],
        kwargs,
        *,
        model_id: str = "",
        timeout: Optional[float] = 60.0,
    ):
        """Exactly-once token delivery across replica death (tier 3).

        The request's identity is pinned BEFORE the first dispatch —
        ``request_id`` and, for sampled generation, an explicit ``seed``
        — so any replica that (re)runs it derives the identical token
        stream (engine sampling is keyed on ``(seed, position)``). Every
        attempt carries ``resume_from`` = the count of tokens already
        delivered to the client, with the prompt extended by exactly
        those tokens; replicas answer with ``(seq, token)`` pairs and
        the SeqGate admits each seq exactly once. The replayed prefix is
        an exact radix-cache prefix on any replica that served (part of)
        the stream's deployment traffic, so a warm survivor resumes at
        near-warm TTFT (bench: ``serve_llm_resume_ttft_p50``)."""
        budget = effective_timeout(timeout)
        req = dict(req)
        req.setdefault("request_id", uuid.uuid4().hex[:16])
        if req.get("seed") is None and float(req.get("temperature", 0.0)) > 0.0:
            # sampled generation MUST replay under one pinned seed; the
            # engine's id-derived fallback seed would also work, but an
            # explicit stamp survives request_id suffixing across attempts
            req["seed"] = int.from_bytes(os.urandom(4), "little")
        # disaggregated serving: compute the prompt KV on the prefill
        # pool first, attach the migration descriptor for the decode
        # replica (identity is already pinned, so the handoff changes
        # WHERE the prefill runs, never what the client sees)
        prefill_dep = self._deployment_meta().get("disagg_prefill")
        if prefill_dep and "kv_import" not in req:
            self._disagg_handoff(prefill_dep, req, model_id, budget)
        base_prompt = [int(t) for t in req["prompt"]]
        if "kv_import" not in req and "kv_tier" not in req:
            # cluster-tier warm admission: a fresh dispatch whose prefix
            # chain is tier-resident anywhere imports it instead of
            # prefilling — this is what makes a controller-spawned
            # replacement WARM from its first request (the dead
            # replica's adverts outlive it in the directory)
            spec = self._tier_attach(base_prompt)
            if spec is not None:
                req["kv_tier"] = spec
        base_rid = str(req["request_id"])
        gate = SeqGate(0)
        delivered: List[int] = []
        item_timeout = budget
        # router-tier SLO ledger: the router is the only tier that SEES
        # a failover (the engines on either side each saw a normal
        # request), so the stage that makes a resumed outlier slow —
        # detection + re-dispatch + warm replay — is stamped here and
        # joined with the engine-tier entries by request id in
        # serve.slo_report()
        led: Dict[str, Any] = {
            "tier": "router",
            "request_id": base_rid,
            "deployment": self._deployment,
            "tenant_class": str(req.get("tenant_class") or ""),
            "trace_id": None,
            "outcome": "abandoned",
            "resumes": 0,
            "replayed_tokens": 0,
            "stages": {},
            "flags": [],
        }
        # resumable streams observe the SLO latency histograms at THIS
        # tier, not the engine: the router sees what the client sees —
        # failover stalls count as real (slow) inter-token gaps, and the
        # samples survive a replica SIGKILL (an engine's in-memory
        # counts die with its process; the consumer's don't). The
        # replicas are told to stand down via ``slo_observer`` so one
        # request is never observed twice.
        from ray_tpu_torch.observability.slo import slo_metrics

        _slo_hist = slo_metrics()
        _slo_labels = {
            "deployment": self._deployment,
            "tenant_class": led["tenant_class"],
        }

        def _finalize_led(t_start: float, first_at: Optional[float]) -> None:
            now = time.monotonic()
            if first_at is not None:
                led["ttft_s"] = round(first_at - t_start, 6)
            led["e2e_s"] = round(now - t_start, 6)
            if led["outcome"] != "abandoned":
                # a walked-away client's e2e is its own choice, not
                # service latency; completed and failed streams count
                _slo_hist["e2e"].observe(now - t_start, labels=_slo_labels)
            flags = []
            if led["resumes"]:
                flags.append("resumed")
            if led["outcome"] == "error":
                flags.append("error")
            if (
                led.get("ttft_s") is not None
                and led["ttft_s"] > GLOBAL_CONFIG.slo_ttft_slow_s
            ):
                flags.append("slow_ttft")
            if led.get("max_itl_s", 0.0) > GLOBAL_CONFIG.slo_itl_slow_s:
                flags.append("slow_itl")
            led["flags"] = flags
            from ray_tpu_torch.observability.slo import flight_recorder

            flight_recorder().add(
                led,
                flagged=bool(flags),
                slow_key=led["e2e_s"],
            )

        def _gen():
            wire = _tracing.current_wire()
            if wire is not None:
                led["trace_id"] = wire[0]
            t_start = time.monotonic()
            first_at: Optional[float] = None
            last_tok_at: Optional[float] = None
            #: set when a failover is in progress: the wall time the
            #: death was observed — the next delivered token closes the
            #: "failover" stage (detection + re-dispatch + warm replay,
            #: measured from the LAST delivered token when one exists:
            #: that gap is exactly what the client perceived)
            failover_since: Optional[float] = None
            attempt = 0
            barren = 0
            #: tier chain computed at the LAST failover for the extended
            #: prompt (base + delivered) — attached to the next attempt
            #: so the survivor faults the stream's KV in instead of
            #: replaying it through prefill
            pending_tier: Optional[Dict[str, Any]] = None
            last_err: Optional[Exception] = None
            try:
                while True:
                    attempt_req = dict(req)
                    attempt_req["resume_from"] = gate.next_seq
                    # this tier owns the latency histograms (see above):
                    # the replica's engine must not observe its own —
                    # possibly warm-replayed — view of the same request
                    attempt_req["slo_observer"] = "router"
                    if attempt:
                        # replay identity: same logical request, new engine
                        # intake (a replica that already saw base_rid — e.g.
                        # one that stalled and recovered — must not reject
                        # the resume as a duplicate submission)
                        attempt_req["prompt"] = base_prompt + delivered
                        attempt_req["request_id"] = f"{base_rid}.r{attempt}"
                        # mark the attempt so the replica keeps its warm
                        # replay OUT of the SLO latency histograms (the
                        # failover cost the client saw is stamped on THIS
                        # tier's ledger entry below)
                        attempt_req["resume_attempt"] = attempt
                        # the KV descriptor belongs to attempt 0's dispatch:
                        # a resume survivor warm-replays through its own
                        # radix cache (PR 10) — or, preferably, faults the
                        # whole chain in from the cluster tier (PR 17):
                        # the pending_tier spec computed at failover time
                        # replaces the single-consumer kv_import
                        attempt_req.pop("kv_import", None)
                        attempt_req.pop("kv_tier", None)
                        if pending_tier is not None:
                            attempt_req["kv_tier"] = pending_tier
                    # per-attempt budget: a resume is a fresh dispatch +
                    # time-to-next-token window, not a continuation of the
                    # first attempt's (possibly spent) dispatch budget
                    deadline = Deadline.after(budget if budget is not None else 3600)
                    progress_before = gate.next_seq
                    replica = None
                    gen = None
                    try:
                        try:
                            replica = self.choose_replica(model_id, [attempt_req])
                        except RuntimeError as e:
                            # "no replicas": every candidate died and the
                            # controller's replacement hasn't registered yet
                            # — a routing condition, not a stream failure;
                            # retry under the barren-attempt bound
                            last_err = e
                            barren += 1
                            if barren >= _MAX_BARREN_RESUMES:
                                raise
                            attempt += 1
                            continue
                        self._bump(replica)
                        gen = replica.handle_request_streaming.options(
                            num_returns="streaming"
                        ).remote(
                            method, [attempt_req] + extra_args,
                            dict(kwargs or {}), model_id,
                        )
                        first = True
                        while True:
                            try:
                                if first:
                                    # bounded time-to-first(-resumed)-item
                                    ref = gen.next_with_timeout(
                                        max(1.0, deadline.remaining())
                                    )
                                else:
                                    # production wait is unbounded, like the
                                    # non-resumable path: a slow producer is
                                    # backpressure, and a DEAD one fails the
                                    # stream (waking this wait) regardless
                                    ref = gen.next_with_timeout(None)
                            except StopIteration:
                                led["outcome"] = "ok"
                                return
                            item = ray_tpu_torch.get(
                                ref,
                                timeout=max(1.0, deadline.remaining())
                                if first
                                else item_timeout,
                            )
                            first = False
                            # one stream item = one producer burst
                            # (TokenChunk of (seq, token) pairs) or a
                            # single bare pair from an older callable
                            pairs = (
                                item
                                if isinstance(item, TokenChunk)
                                else [item]
                            )
                            for pair in pairs:
                                try:
                                    seq, token = pair
                                except (TypeError, ValueError):
                                    # a redeploy swapped in a callable
                                    # that no longer speaks the seq
                                    # protocol while this stream (or a
                                    # stale cache window) was live
                                    raise RuntimeError(
                                        f"resumable stream "
                                        f"{self._deployment}.{method} "
                                        f"yielded {type(pair).__name__}, "
                                        "not a (seq, item) pair — was "
                                        "the deployment redeployed "
                                        "without resumable_streams?"
                                    ) from None
                                if not gate.admit(seq):
                                    continue
                                now = time.monotonic()
                                if first_at is None:
                                    first_at = now
                                    _slo_hist["ttft"].observe(
                                        now - t_start, labels=_slo_labels
                                    )
                                elif last_tok_at is not None:
                                    # the client-perceived gap: a
                                    # failover stall lands HERE as one
                                    # honest slow sample
                                    gap = now - last_tok_at
                                    if gap > led.get("max_itl_s", 0.0):
                                        led["max_itl_s"] = round(gap, 6)
                                    _slo_hist["itl"].observe(
                                        gap, labels=_slo_labels
                                    )
                                if failover_since is not None:
                                    # the failover stage the client saw:
                                    # last delivered token (or the death,
                                    # when none was) → first resumed token
                                    led["stages"]["failover"] = round(
                                        led["stages"].get("failover", 0.0)
                                        + (
                                            now
                                            - (
                                                last_tok_at
                                                if last_tok_at is not None
                                                else failover_since
                                            )
                                        ),
                                        6,
                                    )
                                    failover_since = None
                                last_tok_at = now
                                delivered.append(token)
                                barren = 0
                                yield token
                    except _REPLICA_GONE as e:
                        last_err = e
                        if replica is not None:
                            self._drop_replica(replica)
                        if gate.next_seq == progress_before:
                            barren += 1
                            if barren >= _MAX_BARREN_RESUMES:
                                raise
                        attempt += 1
                        led["resumes"] += 1
                        # tier-first failover: when the directory holds
                        # the stream's whole chain (dead-holder entries
                        # included — the daemon outlives the replica),
                        # the survivor faults it in and the delivered
                        # tokens are NOT replay work — both replay sinks
                        # (counter and ledger) get the same gated value.
                        # A covered chain whose fault-in then FAILS on
                        # the survivor is reconciled replica-side
                        # (LLMServer._reconcile_tier_replay books the
                        # shortfall), so replayed=0 here is not final.
                        pending_tier, covered = self._tier_resume_spec(
                            base_prompt + delivered
                        )
                        replayed = 0 if covered else len(delivered)
                        led["replayed_tokens"] += replayed
                        if failover_since is None:
                            failover_since = time.monotonic()
                        _count_stream_resume(self._deployment, replayed)
                        continue
                    except Exception as e:
                        from ray_tpu_torch.inference.kv_transfer import (
                            KV_MIGRATION_MARKER,
                        )

                        if KV_MIGRATION_MARKER not in str(e):
                            raise
                        # live decode migration: a draining replica
                        # flushed this stream's FULL KV (prompt +
                        # generated) into the tier and failed the
                        # request with the resumable marker. Same
                        # failover machinery as a death — but the
                        # replica is alive (don't drop it; its gossip
                        # says draining, so scoring routes around it)
                        # and the adverts may still be in flight, so
                        # the spec poll waits a few gossip beats.
                        last_err = e
                        if gate.next_seq == progress_before:
                            barren += 1
                            if barren >= _MAX_BARREN_RESUMES:
                                raise
                        attempt += 1
                        led["resumes"] += 1
                        pending_tier, covered = self._tier_resume_spec(
                            base_prompt + delivered,
                            wait_s=max(
                                1.0,
                                3 * GLOBAL_CONFIG.serve_replica_stats_period_s,
                            ),
                        )
                        replayed = 0 if covered else len(delivered)
                        led["replayed_tokens"] += replayed
                        if failover_since is None:
                            failover_since = time.monotonic()
                        _count_stream_resume(self._deployment, replayed)
                        continue
                    finally:
                        # every exit — normal end, failover to the next
                        # attempt, consumer close (GeneratorExit lands at the
                        # yield above) — releases this attempt's ref stream
                        # and cancels a still-running producer, so a client
                        # that disconnects mid-stream frees the engine slot
                        if gen is not None:
                            gen.abandon()
            except GeneratorExit:
                raise  # consumer walked away: outcome stays "abandoned"
            except BaseException as e:
                led["outcome"] = "error"
                led["error"] = repr(e)
                raise
            finally:
                _finalize_led(t_start, first_at)

        # prime the first token eagerly (matching the non-resumable
        # path: dispatch problems raise at call time, not first next())
        # under the serve trace root covering dispatch → first item
        with _tracing.root_span(f"serve::{self._deployment}.{method}", "serve"):
            g = _gen()
            try:
                first_token = next(g)
            except StopIteration:
                def _empty():
                    return
                    yield  # pragma: no cover
                return _empty()
        return itertools.chain([first_token], g)
