"""InferenceEngine: continuous-batching autoregressive generation (port of
``ray_tpu.inference.engine``).

One engine per process. A background step-loop thread drives ``step()``:
each step runs at most one prefill chunk plus the standing decode batch
(``scheduler.StepPlan``) on the port's ``PagedModelRunner``, samples the
new tokens host-side, and pushes them into per-request queues that
:meth:`generate` drains — so tokens stream to the caller WHILE other
requests keep decoding.

Ported with the reference's behaviour: admission, continuous batching and
chunked prefill; the prefix cache and COW; preemption and readmission,
cancellation, deadlines (the ambient ``core.deadline`` budget or
``timeout_s``), ``begin_drain`` and stream reaping; ``healthy``, ``stats``
and ``routing_stats``; speculative decoding with adaptive k; and the
deterministic sampler keyed on ``(request seed, absolute position)``
(:meth:`_sample`), so a request resubmitted with ``prompt + generated[:k]``
continues the identical token stream on any engine with the same params.
Seeded replica chaos (``util/chaos.py::ReplicaFaultPlan``, armed through
``testing_replica_chaos`` or per engine through ``testing_fault_plan``) is
consulted once per step phase, before its device work.

Inside a process of the port's cluster (a serve replica),
``attach_node_drain_listener`` subscribes to node events, and a DRAINING
push for the replica's own node starts ``begin_drain``; without a cluster it
returns None and only an explicit ``begin_drain()`` drains. Not ported yet
(each raises
``NotImplementedError`` naming the ROADMAP): KV-cache migration and the
cluster KV tier (``kv_transfer_enabled``, ``kv_tier_enabled``,
``begin_drain(migrate=True)``, ``prefill_kv``, ``import_kv_blocks``).
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import queue
import signal
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.deadline import Deadline, remaining as deadline_remaining
from ray_tpu_torch.inference.kv_cache import PagedBlockManager
from ray_tpu_torch.inference.model_runner import PagedModelRunner
from ray_tpu_torch.inference.scheduler import (
    CANCELLED,
    DECODE,
    FAILED,
    FINISHED,
    ContinuousBatchingScheduler,
    Request,
)
from ray_tpu_torch.inference.speculative import DraftModelProposer, NgramProposer
from ray_tpu_torch.models.llama import init_params
from ray_tpu_torch.observability import rpc_metrics, timeline
from ray_tpu_torch.observability import tracing as _tracing
from ray_tpu_torch.observability.metrics import Counter, Gauge
from ray_tpu_torch.observability.slo import BucketCounts, flight_recorder, slo_metrics
from ray_tpu_torch.observability import slo as _slo

_END = object()  # stream sentinel

logger = logging.getLogger(__name__)

#: where the features that are not ported yet stand
_NOT_PORTED = "is not ported yet (ROADMAP Queue A: {})"

# -- replica chaos (util/chaos.py::ReplicaFaultPlan) -------------------------
_RPLAN_CACHE = None
_RPLAN_CACHE_LOCK = threading.Lock()


def active_replica_fault_plan():
    """The process-wide seeded replica fault plan for
    ``testing_replica_chaos`` (or None); seed logged at activation
    (util/chaos.py::SeededPlanCache)."""
    global _RPLAN_CACHE
    if _RPLAN_CACHE is None:
        from ray_tpu_torch.util.chaos import ReplicaFaultPlan, SeededPlanCache

        with _RPLAN_CACHE_LOCK:
            if _RPLAN_CACHE is None:
                _RPLAN_CACHE = SeededPlanCache(
                    ReplicaFaultPlan, "replica",
                    "testing_replica_chaos", "testing_replica_chaos_seed",
                    logger,
                )
    return _RPLAN_CACHE.active()


def _stable_request_seed(request_id: str) -> int:
    """Process-independent sampling seed derived from a request id.
    ``hash()`` is salted per interpreter (PYTHONHASHSEED), which would
    make a request resumed on another replica sample a DIFFERENT stream
    — breaking exactly-once token delivery for unseeded requests."""
    return int.from_bytes(
        hashlib.blake2b(request_id.encode(), digest_size=8).digest(), "little"
    )


class EngineDrainingError(RuntimeError):
    """New request rejected because the engine is draining."""


class RequestFailedError(RuntimeError):
    """The engine gave up on a request (deadline expiry, drain cutoff)."""


#: string marker the serve router's resumable-stream failover matches on
#: (``ray_tpu.inference.kv_transfer.KV_MIGRATION_MARKER``)
KV_MIGRATION_MARKER = "kv-tier migration handoff"


@dataclass
class EngineConfig:
    """Knobs for the paged-KV continuous-batching engine (see README
    "inference" section)."""

    #: device block pool size (block 0 is the reserved null block)
    num_blocks: int = 128
    #: token positions per block
    block_size: int = 16
    #: prefill chunk-length buckets; each is one step shape, run at warmup.
    #: None → derived from the model's max_seq_len (powers of two).
    prefill_buckets: Optional[Sequence[int]] = None
    #: decode batch-size buckets; None → (1, 2, 4, ..., max_decode_batch)
    decode_buckets: Optional[Sequence[int]] = None
    max_decode_batch: int = 8
    #: prefill chunks per engine step (prefill rides WITH the decode batch)
    max_prefills_per_step: int = 1
    #: admission queue bound: submits beyond this fail fast
    max_queue_depth: int = 128
    #: run every bucket at startup so serving meets no new shape
    warmup: bool = True
    #: default cap on generated tokens per request
    max_new_tokens_default: int = 64
    #: KV cache dtype override (None → model dtype)
    cache_dtype: Any = None
    #: reap finished-but-never-drained token streams after this long; a
    #: caller that submits and walks away (own deadline hit, gave up
    #: after a tokens() timeout without cancel()) would otherwise pin its
    #: queue in the replica forever. <= 0 disables.
    finished_stream_ttl_s: float = 300.0
    #: healthy() reports False once there is pending work but the step
    #: loop hasn't completed an iteration for this long — a wedged step
    #: thread (stuck device call, injected stall) in a replica whose
    #: actor loop still answers RPCs. The serve controller polls this
    #: through replica.health() and restarts the replica. <= 0 disables
    #: the staleness check (thread liveness is still checked).
    step_stall_unhealthy_s: float = 10.0
    #: prefix caching (kv_cache.py): full blocks are indexed by token
    #: chain-hash and SHARED with later requests whose prompt prefix
    #: matches — those skip the covered prefill chunks entirely (the
    #: warm-TTFT path for fleets of conversations sharing one system
    #: prompt). Numerically inert: shared KV values are exactly what an
    #: uncached prefill would have written.
    prefix_cache_enabled: bool = True
    #: cap on indexed blocks (0 = bounded only by the pool; unreferenced
    #: cached blocks are reclaimed LRU-first whenever allocation needs
    #: them, so the cache never starves admission)
    prefix_cache_max_blocks: int = 0
    #: KV-cache migration (disaggregated prefill/decode serving) and the
    #: cluster-wide KV prefix tier of the reference: not ported yet, the
    #: engine raises NotImplementedError when either is set
    kv_transfer_enabled: bool = False
    kv_tier_enabled: bool = False
    #: speculative decoding (inference/speculative.py): drafts proposed
    #: per decode slot and verified in ONE bucketed target step
    #: (models.llama.paged_verify_step). 0 disables — plain deployments
    #: keep their exact compile count (no verify bucket, no draft
    #: runner). Acceptance is exact-match against the engine's own
    #: deterministic (seed, absolute-position) sampler, so the emitted
    #: stream is byte-identical to non-speculative decode and the
    #: resumable-stream contract survives unchanged.
    speculative_k: int = 0
    #: draft mode: "ngram" (model-free prompt-lookup decoding, zero
    #: device cost) or "model" (a scaled-down same-tokenizer draft model
    #: on its own paged runner; requires draft_config)
    speculative_draft: str = "ngram"
    #: LlamaConfig for speculative_draft="model" (same vocab as the
    #: target); ignored for "ngram"
    draft_config: Any = None
    #: draft model params (None → deterministic init from draft_config
    #: with draft_seed)
    draft_params: Any = None
    draft_seed: int = 0
    #: draft runner pool/buckets (0/None → scaled from the engine's own)
    draft_num_blocks: int = 0
    draft_prefill_buckets: Optional[Sequence[int]] = None
    #: adaptive k: the 4 Hz gauge refresh shrinks the live draft budget
    #: toward 1 while the windowed acceptance rate sits below the floor,
    #: and grows it back toward speculative_k while acceptance is high —
    #: the verify bucket stays fixed at speculative_k+1 (shorter windows
    #: pad via true_len), so adaptation never recompiles
    speculative_adaptive: bool = True
    speculative_accept_floor: float = 0.35
    #: prompt-lookup n-gram sizes for speculative_draft="ngram"
    ngram_max: int = 3
    ngram_min: int = 1

    def resolved_verify_buckets(self) -> Sequence[int]:
        """One verify bucket, sized for the full draft budget: k+1
        window positions (last committed token + k drafts); shorter
        windows (adaptive shrink, tail-of-request clamps) pad into it
        via true_len instead of compiling new shapes."""
        if self.speculative_k <= 0:
            return ()
        return (self.speculative_k + 1,)

    def resolved_prefill_buckets(self, max_seq_len: int) -> Sequence[int]:
        if self.prefill_buckets is not None:
            return tuple(sorted(self.prefill_buckets))
        out, b = [], 16
        while b < max_seq_len:
            out.append(b)
            b *= 2
        out.append(max_seq_len)
        return tuple(out)

    def resolved_decode_buckets(self) -> Sequence[int]:
        if self.decode_buckets is not None:
            return tuple(sorted(self.decode_buckets))
        out, b = [], 1
        while b < self.max_decode_batch:
            out.append(b)
            b *= 2
        out.append(self.max_decode_batch)
        return tuple(sorted(set(out)))


# -- engine metrics (registered once per process; re-registration of the
# same names returns the shared underlying metric) --------------------------


def _engine_metrics():
    slo = slo_metrics()
    return {
        # SLO-ledger sinks (observability/slo.py): aggregatable
        # log-bucket histograms + goodput/fault-cost counters, labeled
        # {deployment, tenant_class}. raytpu_llm_ttft_seconds used to be
        # a per-engine quantile GAUGE — mathematically un-aggregatable
        # across a /federate scrape; the histogram replaces it.
        "ttft": slo["ttft"],
        "itl": slo["itl"],
        "e2e": slo["e2e"],
        "goodput": slo["goodput"],
        "fault": slo["fault"],
        "deadline": slo["deadline"],
        "tps": Gauge(
            "raytpu_llm_tokens_per_s",
            "decode throughput over the trailing window",
        ),
        "cache_util": Gauge(
            "raytpu_llm_kv_cache_utilization",
            "fraction of usable KV blocks currently allocated",
        ),
        "queue_depth": Gauge(
            "raytpu_llm_queue_depth", "requests waiting for admission"
        ),
        "active": Gauge("raytpu_llm_active_requests", "admitted, unfinished"),
        "decode_batch": Gauge(
            "raytpu_llm_decode_batch_size", "slots in the last decode step"
        ),
        "tokens_total": Counter(
            "raytpu_llm_tokens_generated_total", "tokens sampled"
        ),
        "requests_total": Counter(
            "raytpu_llm_requests_total", "requests by terminal state", ("outcome",)
        ),
        "preemptions_total": Counter(
            "raytpu_llm_preemptions_total", "requests evicted for blocks"
        ),
        "prefix_hits_total": Counter(
            "raytpu_llm_prefix_hits_total",
            "admissions that reused cached prefix blocks",
        ),
        "prefix_tokens_saved_total": Counter(
            "raytpu_llm_prefix_tokens_saved_total",
            "prompt tokens whose prefill was skipped via the prefix cache",
        ),
        "cow_copies_total": Counter(
            "raytpu_llm_cow_copies_total",
            "copy-on-write block duplications (full-prompt cache hits)",
        ),
        # speculative decoding (defined in rpc_metrics so every process
        # that imports the transport layer exports consistent help text;
        # referencing them here puts them on the engine /metrics path
        # and under the catalog lint)
        "spec_proposed": rpc_metrics.LLM_SPEC_PROPOSED,
        "spec_accepted": rpc_metrics.LLM_SPEC_ACCEPTED,
        "spec_rollbacks": rpc_metrics.LLM_SPEC_ROLLBACKS,
        "spec_acceptance": rpc_metrics.LLM_SPEC_ACCEPTANCE,
    }


class InferenceEngine:
    def __init__(self, model_cfg, params, engine_cfg: Optional[EngineConfig] = None):
        self.cfg = model_cfg
        self.engine_cfg = ec = engine_cfg or EngineConfig()
        for flag, item in (("kv_transfer_enabled", "KV migration"),
                           ("kv_tier_enabled", "the cluster KV tier")):
            if getattr(ec, flag):
                raise NotImplementedError(f"EngineConfig.{flag} " + _NOT_PORTED.format(item))
        decode_buckets = ec.resolved_decode_buckets()
        if ec.max_decode_batch > max(decode_buckets):
            # catching this at runtime instead means _round_up_bucket
            # raises inside step() and _fail_all errors every in-flight
            # request, repeatedly — fail loud at init instead
            raise ValueError(
                f"max_decode_batch={ec.max_decode_batch} exceeds the largest "
                f"decode bucket {max(decode_buckets)}; add a bucket >= the "
                "batch cap or lower max_decode_batch"
            )
        self.runner = PagedModelRunner(
            model_cfg,
            params,
            num_blocks=ec.num_blocks,
            block_size=ec.block_size,
            prefill_buckets=ec.resolved_prefill_buckets(model_cfg.max_seq_len),
            decode_buckets=decode_buckets,
            verify_buckets=ec.resolved_verify_buckets(),
            cache_dtype=ec.cache_dtype,
        )
        self.blocks = PagedBlockManager(
            ec.num_blocks,
            ec.block_size,
            prefix_cache_enabled=ec.prefix_cache_enabled,
            prefix_cache_max_blocks=ec.prefix_cache_max_blocks,
        )
        self.scheduler = ContinuousBatchingScheduler(
            self.blocks,
            max_decode_batch=ec.max_decode_batch,
            max_prefill_chunk=max(ec.resolved_prefill_buckets(model_cfg.max_seq_len)),
            max_prefills_per_step=ec.max_prefills_per_step,
            max_queue_depth=ec.max_queue_depth,
        )
        self._out: Dict[str, queue.Queue] = {}
        # request id -> submitter's (trace_id, span_id): the step-loop
        # thread stamps per-request spans (admission→first-token,
        # admission→finish) under the caller's trace
        self._trace_ctx: Dict[str, tuple] = {}
        self._submitted_at: Dict[str, float] = {}
        self._first_token_at: Dict[str, float] = {}
        self._finished_at: Dict[str, float] = {}
        self._next_stream_reap = 0.0
        self._next_gauge_refresh = 0.0
        self._lock = threading.RLock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self._drain_deadline: Optional[Deadline] = None
        #: the node drain subscription (None: the port has no runtime yet)
        self._listener_backend = None
        self._node_listener = None
        #: step-loop heartbeat consumed by healthy(): stamped once per
        #: loop iteration, so a step wedged inside device code (or an
        #: injected stall) goes stale while the actor loop stays live
        self._last_beat = time.monotonic()
        #: per-engine fault-plan override (tests arm ONE replica
        #: surgically); None falls through to the env/config plan
        self.testing_fault_plan = None
        self.metrics = _engine_metrics()
        #: per-ENGINE TTFT tape (the process-registry histogram is shared
        #: by every engine in the process — tests host several): backs
        #: the stats()["ttft"] p50/p99 shape
        self._ttft_tape = BucketCounts()
        #: deployment label for the SLO series ("" for bare engines)
        self.slo_deployment = ""
        #: intake books — with the scheduler's queued/running counts,
        #: submitted == finished + failed + cancelled + in_flight holds
        #: exactly at quiesce (slo.books_balanced)
        self._books = {"submitted": 0, "finished": 0, "failed": 0, "cancelled": 0}
        self._token_times: deque = deque(maxlen=2048)
        #: recent (monotonic, value) latency samples backing the
        #: sliding-window control signals (routing_stats ttft_p99_s /
        #: itl_p99_s); the ledger tapes above are lifetime histograms
        self._recent_ttfts: deque = deque(maxlen=512)
        self._recent_itls: deque = deque(maxlen=2048)
        #: (monotonic, n_tokens) per prefill pass — windowed prefill throughput
        self._prefill_token_times: deque = deque(maxlen=2048)
        self._preempt_seen = 0
        self._replay_seen = 0
        self._prefix_seen: Dict[str, int] = {}
        # -- speculative decoding --
        #: the draft proposer (None when disabled). Only constructed for
        #: speculative_k > 0, so plain engines keep their exact compile
        #: count — no verify bucket is ever run.
        self.spec = None
        #: lifetime propose/accept/rollback books (stats() + adaptive k)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rollbacks = 0
        #: (proposed, accepted) snapshot at the last gauge refresh — the
        #: adaptive controller steers on the window delta, not lifetime
        self._spec_window_seen = (0, 0)
        self._spec_acceptance = 0.0
        if ec.speculative_k > 0:
            if ec.speculative_draft == "model":
                if ec.draft_config is None:
                    raise ValueError(
                        "speculative_draft='model' requires draft_config"
                    )
                draft_params = ec.draft_params
                if draft_params is None:
                    # seeded init where the target's params live
                    draft_params = init_params(
                        ec.draft_config, ec.draft_seed, device=self.runner.device
                    )
                self.spec = DraftModelProposer(
                    ec.draft_config,
                    draft_params,
                    num_blocks=ec.draft_num_blocks or ec.num_blocks,
                    block_size=ec.block_size,
                    prefill_buckets=(
                        tuple(ec.draft_prefill_buckets)
                        if ec.draft_prefill_buckets is not None
                        else ec.resolved_prefill_buckets(
                            ec.draft_config.max_seq_len
                        )
                    ),
                    cache_dtype=ec.cache_dtype,
                )
            elif ec.speculative_draft == "ngram":
                self.spec = NgramProposer(
                    max_ngram=ec.ngram_max, min_ngram=ec.ngram_min
                )
            else:
                raise ValueError(
                    f"unknown speculative_draft {ec.speculative_draft!r} "
                    "(expected 'ngram' or 'model')"
                )
            self.scheduler.spec_max_context = model_cfg.max_seq_len
            self.scheduler.spec_k_live = ec.speculative_k
        self.total_steps = 0
        if ec.warmup:
            self.runner.warmup()
            if self.spec is not None and hasattr(self.spec, "warmup"):
                self.spec.warmup()
        else:
            self.runner.mark_warm()
            if self.spec is not None and hasattr(self.spec, "mark_warm"):
                self.spec.mark_warm()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "InferenceEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="llm-engine-step"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # the step loop is dead: queued/running requests can never emit
        # another token — fail them so callers blocked in tokens() wake
        # instead of hanging on q.get() forever
        self._fail_all(RequestFailedError("engine stopped"))
        self.detach_node_drain_listener()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._last_beat = time.monotonic()
            did_work = False
            try:
                did_work = self.step()
            except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
                self._fail_all(e)
            self._reap_abandoned_streams()
            if not did_work:
                self._work.wait(timeout=0.005)
                self._work.clear()

    # -- submission -------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        priority: int = 0,
        eos_token: Optional[int] = None,
        request_id: Optional[str] = None,
        seed: Optional[int] = None,
        timeout_s: Optional[float] = None,
        tenant_class: str = "",
        ledger_stages: Optional[Dict[str, float]] = None,
        record_slo: bool = True,
        speculative: Optional[bool] = None,
    ) -> str:
        """Enqueue a generation request; returns its id. The ambient
        ``core.deadline`` budget (or explicit ``timeout_s``, whichever is
        tighter) bounds the request end to end. ``tenant_class`` labels
        the SLO histograms;
        ``ledger_stages`` carries stage durations measured upstream
        (e.g. the KV import that ran before this submit);
        ``record_slo=False`` keeps a resume attempt's warm-replay
        latencies out of the SLO histograms (see Request.record_slo).
        ``speculative`` is the per-request off-switch: False forces
        plain decode for this request even on a speculative engine
        (True/None follow the engine config — output bytes are
        identical either way, only throughput changes)."""
        if self._draining or not self.scheduler.admitting:
            raise EngineDrainingError("engine is draining: not admitting requests")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens is None:
            max_new = self.engine_cfg.max_new_tokens_default
        else:
            max_new = int(max_new_tokens)
            if max_new < 1:
                raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        # clamp so prompt + generation always fits the block-table width
        room = self.cfg.max_seq_len - len(prompt)
        if room < 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens >= max_seq_len {self.cfg.max_seq_len}"
            )
        max_new = min(max_new, room)
        rid = request_id or uuid.uuid4().hex[:16]
        if temperature > 0.0 and seed is None:
            # resolve ONCE, stably: sampling is keyed on (seed, position)
            # so a resumed/replayed request re-derives the identical
            # stream from its id alone (see _sample / _stable_request_seed)
            seed = _stable_request_seed(rid)
        budget = deadline_remaining()
        if timeout_s is not None:
            budget = timeout_s if budget is None else min(budget, timeout_s)
        req = Request(
            request_id=rid,
            prompt=prompt,
            max_new_tokens=max_new,
            priority=priority,
            temperature=temperature,
            eos_token=eos_token,
            deadline=Deadline.after(budget) if budget is not None else None,
            seed=seed,
            tenant_class=str(tenant_class or ""),
            ledger_stages=dict(ledger_stages or {}),
            record_slo=bool(record_slo),
            spec_k=(
                self.engine_cfg.speculative_k
                if self.spec is not None
                and speculative is not False
                else 0
            ),
        )
        trace_wire = _tracing.current_wire()
        with self._lock:
            if rid in self._out:
                raise ValueError(f"duplicate request_id {rid!r}")
            self._out[rid] = queue.Queue()
            if trace_wire is not None:
                self._trace_ctx[rid] = trace_wire
            self._submitted_at[rid] = time.monotonic()
        try:
            self.scheduler.add(req)
        except Exception:
            with self._lock:
                self._out.pop(rid, None)
                self._trace_ctx.pop(rid, None)
                self._submitted_at.pop(rid, None)
            raise
        with self._lock:
            # counted only AFTER scheduler.add succeeded: a rejected
            # submit (queue full, draining) never entered the books
            self._books["submitted"] += 1
        self._work.set()
        return rid

    def generate(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        priority: int = 0,
        eos_token: Optional[int] = None,
        request_id: Optional[str] = None,
        seed: Optional[int] = None,
        timeout_s: Optional[float] = None,
        tenant_class: str = "",
        ledger_stages: Optional[Dict[str, float]] = None,
        record_slo: bool = True,
        speculative: Optional[bool] = None,
    ) -> Iterator[int]:
        """Submit and stream tokens as they decode. Closing/abandoning
        the iterator cancels the request and frees its blocks."""
        rid = self.submit(
            prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            priority=priority,
            eos_token=eos_token,
            request_id=request_id,
            seed=seed,
            timeout_s=timeout_s,
            tenant_class=tenant_class,
            ledger_stages=ledger_stages,
            record_slo=record_slo,
            speculative=speculative,
        )
        try:
            yield from self.tokens(rid)
        finally:
            self.cancel(rid)  # no-op when already finished

    def generate_chunks(self, prompt: Sequence[int], **kw) -> Iterator[List[int]]:
        """:meth:`generate`, coalesced: yields LISTS — each the full
        burst of tokens available at wake-up. Speculative decoding
        commits up to k+1 tokens per verify step; draining the burst in
        one item lets the serve streaming path pay its per-item cost
        once per STEP instead of once per token (the router flattens, so
        clients still see a per-token stream)."""
        rid = self.submit(prompt, **kw)
        try:
            yield from self.tokens_chunked(rid)
        finally:
            self.cancel(rid)  # no-op when already finished

    def tokens_chunked(
        self, request_id: str, timeout: Optional[float] = None
    ) -> Iterator[List[int]]:
        """Chunked variant of :meth:`tokens`: one blocking wait per
        burst, then a non-blocking drain of everything already queued.
        Timeout/resume semantics match :meth:`tokens` (the timeout
        bounds the wait for the NEXT burst)."""
        q = self._out.get(request_id)
        if q is None:
            raise KeyError(f"unknown request {request_id!r}")
        drop = True
        try:
            while True:
                try:
                    item = q.get(timeout=timeout) if timeout is not None else q.get()
                except queue.Empty:
                    drop = False
                    raise TimeoutError(
                        f"no token within {timeout}s for request {request_id!r}; "
                        "still running — retry tokens_chunked() or cancel()"
                    ) from None
                terminal = None
                chunk: List[int] = []
                while True:
                    if item is _END or isinstance(item, Exception):
                        terminal = item
                        break
                    chunk.append(item)
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                if chunk:
                    yield chunk
                if terminal is _END:
                    return
                if terminal is not None:
                    raise terminal
        finally:
            # same queue-drop rule as tokens(): keep it on inter-token
            # timeout so a retry can pick the stream back up
            if drop:
                with self._lock:
                    self._out.pop(request_id, None)
                    self._finished_at.pop(request_id, None)

    def tokens(self, request_id: str, timeout: Optional[float] = None) -> Iterator[int]:
        """Drain a submitted request's token stream. ``timeout`` bounds
        each inter-token gap: on expiry a :class:`TimeoutError` is raised
        but the request keeps running and the stream stays resumable —
        call ``tokens()`` again to continue, or ``cancel()`` to give up."""
        q = self._out.get(request_id)
        if q is None:
            raise KeyError(f"unknown request {request_id!r}")
        drop = True
        try:
            while True:
                try:
                    item = q.get(timeout=timeout) if timeout is not None else q.get()
                except queue.Empty:
                    drop = False
                    raise TimeoutError(
                        f"no token within {timeout}s for request {request_id!r}; "
                        "still running — retry tokens() or cancel()"
                    ) from None
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # stream consumed (or abandoned): drop the queue — except on
            # inter-token timeout, where the request is still decoding and
            # a retry must find the queue (popping here would silently
            # drop every later token and KeyError the retry)
            if drop:
                with self._lock:
                    self._out.pop(request_id, None)
                    self._finished_at.pop(request_id, None)

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued/running request; frees its blocks. Returns
        True if something was actually cancelled."""
        req = self.scheduler.cancel(request_id)
        if req is None:
            # already finished (or unknown). The finish may still be
            # mid-flight on the step thread — scheduler.finish() done but
            # _finish_request() not yet run — so popping the queue alone
            # could strand a consumer blocked in q.get() with no _END
            # ever arriving. Wake it, then drop the dict entry.
            with self._lock:
                q = self._out.pop(request_id, None)
                self._finished_at.pop(request_id, None)
            if q is not None:
                q.put(_END)
            return False
        self._finish_request(req, CANCELLED, error=None)
        return True

    # -- drain ------------------------------------------------------------
    def begin_drain(
        self, grace_s: Optional[float] = None, *, migrate: bool = False
    ) -> None:
        """Stop admitting; in-flight (queued + running) requests keep
        decoding until done or the grace window closes, after which the
        stragglers fail with :class:`RequestFailedError`. ``migrate=True``
        (hand in-flight KV to the cluster tier) is not ported yet."""
        if migrate:
            raise NotImplementedError("begin_drain(migrate=True) " + _NOT_PORTED.format(
                "KV migration"))
        grace = GLOBAL_CONFIG.drain_grace_s if grace_s is None else grace_s
        with self._lock:
            self._draining = True
            self.scheduler.admitting = False
            self._drain_deadline = Deadline.after(grace)
        self._work.set()

    @property
    def draining(self) -> bool:
        return self._draining

    def attach_node_drain_listener(self) -> None:
        """Subscribe to node DRAINING pushes: a preemption warning on OUR
        node triggers ``begin_drain`` (serve unroutes the replica at the
        same time, so live streams finish and nothing new arrives)."""
        try:
            import ray_tpu_torch
            from ray_tpu_torch.core.api import _global_worker

            my_node = ray_tpu_torch.get_runtime_context().get_node_id()
            backend = _global_worker().backend
        except Exception:
            return  # local mode / no cluster: explicit begin_drain() only

        def _on_node_event(msg: Dict[str, Any]) -> None:
            nid = msg.get("node_id")
            nid = nid.hex() if isinstance(nid, bytes) else nid
            if msg.get("state") == "DRAINING" and nid == my_node:
                self.begin_drain()

        try:
            backend.add_node_event_listener(_on_node_event)
        except Exception:
            return
        self._listener_backend = backend
        self._node_listener = _on_node_event

    def detach_node_drain_listener(self) -> None:
        if self._listener_backend is not None and self._node_listener is not None:
            try:
                self._listener_backend.remove_node_event_listener(self._node_listener)
            except Exception:
                pass
        self._listener_backend = None
        self._node_listener = None

    # -- the step ---------------------------------------------------------
    def step(self) -> bool:
        """One engine step: ≤N prefill chunks + the decode batch. Returns
        whether any work ran."""
        if self._draining and self._drain_deadline is not None and self._drain_deadline.expired:
            self._fail_all(
                RequestFailedError("engine drain grace expired mid-generation")
            )
        plan = self.scheduler.schedule()
        for req in plan.reaped:
            # every reap here is a deadline expiry (queued or running) —
            # a fault-cost class the SLO report breaks out explicitly
            self.metrics["deadline"].inc(
                labels={"deployment": self.slo_deployment}
            )
            self._finish_request(
                req,
                req.state,
                error=RequestFailedError(
                    f"request {req.request_id} deadline expired before completion"
                ),
            )
        if not plan.prefills and not plan.decodes:
            return not plan.empty
        self._consult_replica_chaos(plan)

        # timeline timestamps share the module's wall-clock epoch so
        # engine_step events merge with every other trace
        t0_us = timeline._now_us()
        n_prefill_tokens = 0
        for req, start, chunk in plan.prefills:
            if req.pending_cow:
                # prefix-cache COW: duplicate the shared block(s) BEFORE
                # this chunk writes into the private copies, then drop
                # the source pins (the copies are live in the table now)
                self.runner.copy_blocks(req.pending_cow)
                self.blocks.cow_copied(req.request_id)
                req.pending_cow = []
            row = self.blocks.table_row(req.request_id, self.runner.max_blocks_per_seq)
            prompt = req.effective_prompt
            logits = self.runner.prefill_chunk(
                prompt[start : start + chunk], row, start
            )
            req.prefill_pos = start + chunk
            n_prefill_tokens += chunk
            if req.prefill_done and req.prefill_done_at is None:
                req.prefill_done_at = time.monotonic()
            if req.prefill_done:
                # the prompt's K/V is fully written: index its full
                # blocks so later requests sharing the prefix skip them
                self.blocks.register_prefix(req.request_id, prompt)
                req.state = DECODE
                self._emit_token(req, self._sample(req, logits))

        if plan.decodes:
            # speculative slots peel off the batch: each proposes drafts,
            # then EVERY spec slot verifies in one batched target step
            # (models.llama.paged_verify_step: B slots x k+1 positions
            # per call). Slots whose proposer came up empty ride the
            # plain batched decode unchanged — speculation is an
            # opportunistic throughput lever, never a dependency.
            spec_slots: List[tuple] = []
            plain: List[Request] = []
            for r in plan.decodes:
                drafts = self._spec_propose(r) if r.spec_step_k > 0 else []
                if drafts:
                    spec_slots.append((r, drafts))
                else:
                    plain.append(r)
            if plain:
                toks = [r.generated[-1] for r in plain]
                poss = [r.context_len - 1 for r in plain]
                rows = [
                    self.blocks.table_row(
                        r.request_id, self.runner.max_blocks_per_seq
                    )
                    for r in plain
                ]
                cls = [r.context_len for r in plain]
                logits = self.runner.decode(toks, poss, rows, cls)
                for req, lg in zip(plain, logits):
                    self._emit_token(req, self._sample(req, lg))
            if spec_slots:
                windows = [[r.generated[-1]] + d for r, d in spec_slots]
                rows = [
                    self.blocks.table_row(
                        r.request_id, self.runner.max_blocks_per_seq
                    )
                    for r, _ in spec_slots
                ]
                ctxs = [r.context_len - 1 for r, _ in spec_slots]
                all_logits = self.runner.verify_batch(windows, rows, ctxs)
                for (req, drafts), logits in zip(spec_slots, all_logits):
                    self._spec_accept(req, drafts, logits)
        if n_prefill_tokens:
            self._prefill_token_times.append((time.monotonic(), n_prefill_tokens))
        self.total_steps += 1
        timeline.record_event(
            "engine_step",
            "inference",
            t0_us,
            timeline._now_us(),
            args={
                "prefill_tokens": n_prefill_tokens,
                "decode_batch": len(plan.decodes),
            },
        )
        self._update_gauges(len(plan.decodes))
        return True


    # -- speculative decoding --------------------------------------------
    def _spec_propose(self, req: Request) -> List[int]:
        """Ask the proposer for up to ``spec_step_k`` drafts for this
        slot. An empty proposal (nothing to look up, draft pool dry, a
        broken proposer) degrades the slot to plain decode this step and
        hands back the blocks the scheduler grew for the draft window."""
        ctx = req.prompt + req.generated
        try:
            drafts = self.spec.propose(
                ctx, req.spec_step_k, request_id=req.request_id
            )
        except Exception:  # noqa: BLE001 — proposer bugs must not kill steps
            logger.exception("speculative proposer failed; plain decode")
            drafts = []
        drafts = [int(t) for t in list(drafts)[: req.spec_step_k]]
        if not drafts:
            self.blocks.trim_to(req.request_id, req.context_len)
        return drafts

    def _spec_accept(
        self, req: Request, drafts: List[int], logits: np.ndarray
    ) -> None:
        """Commit the deterministically-accepted prefix of one slot's
        verify window ``[last_committed, d_1..d_k']`` from its
        all-position target logits (``logits[i]`` is the distribution
        AFTER window position i; the batched verify already ran).

        Acceptance is exact-match: at each window position the target's
        token is realized with the engine's own (seed, absolute-position)
        sampler (:meth:`_sample` — ``pos`` advances naturally as tokens
        emit), drafts are accepted while they match it, and the first
        mismatch position emits the target's token INSTEAD (the
        bonus/correction token — every speculative step nets >= 1
        token). Emitted bytes are therefore identical to plain decode by
        construction, for greedy and seeded temperature>0 sampling
        alike, and the proposer can never affect content — only the
        acceptance rate.

        Rollback is pure host-side accounting: ``generated`` only ever
        received accepted tokens (the write cursor rewind is implicit),
        and :meth:`PagedBlockManager.trim_to` hands back the blocks
        grown past the committed context. The rejected tail's K/V stays
        stale on device, unreachable by construction — every masked
        read stops at the committed context length, and re-verification
        overwrites the slots in place. The prefix index and the KV tier
        only ever see positions below the verified cursor because both
        derive from ``generated``."""
        m = self.metrics
        accepted = 0
        for i in range(len(drafts) + 1):
            if req.finished:
                break
            tok = self._sample(req, logits[i])
            matched = i < len(drafts) and tok == drafts[i]
            self._emit_token(req, tok)
            if i < len(drafts):
                if not matched:
                    break
                accepted += 1
        self._spec_proposed += len(drafts)
        self._spec_accepted += accepted
        m["spec_proposed"].inc(len(drafts))
        if accepted:
            m["spec_accepted"].inc(accepted)
        if accepted < len(drafts):
            self._spec_rollbacks += 1
            m["spec_rollbacks"].inc()
        self.blocks.trim_to(req.request_id, req.context_len)

    # -- internals --------------------------------------------------------
    def _sample(self, req: Request, logits: np.ndarray) -> int:
        """Deterministic continuation: the RNG is keyed on
        ``(request seed, absolute position)`` instead of a stateful
        per-request stream. ``len(prompt) + len(generated)`` equals the
        original sequence position regardless of how much of the
        sequence arrived AS prompt — so a request resubmitted as
        ``prompt + generated[:k]`` provably samples token k+1
        identically, which is what makes mid-stream failover replay
        byte-exact (serve router resume; pinned by
        tests/test_stream_resume.py)."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        pos = len(req.prompt) + len(req.generated)
        seed = req.seed if req.seed is not None else 0
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, pos])
        )
        z = (logits / req.temperature).astype(np.float64)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _consult_replica_chaos(self, plan) -> None:
        """Replica fault injection at the step boundary (ReplicaFaultPlan):
        consulted once per phase this step actually runs, BEFORE the
        phase's device work — a kill lands after the last emitted token
        and before the next one samples, the boundary the router's
        seq-numbered resume must cover."""
        for phase, present in (
            ("prefill", bool(plan.prefills)),
            ("decode", bool(plan.decodes)),
        ):
            if present:
                self._consult_phase_chaos(phase)

    def _consult_phase_chaos(self, phase: str) -> None:
        """One chaos consult for a named engine phase ("prefill" |
        "decode"; the KV-migration consults "export" and "import" come
        with the KV tier, ROADMAP Queue A)."""
        chaos = self.testing_fault_plan or active_replica_fault_plan()
        if chaos is None:
            return
        fault = chaos.consult(phase)
        if fault is None:
            return
        mode, param = fault
        if mode == "stall":
            logger.warning(
                "replica chaos: stalling step loop %.2fs (seed=%d)",
                param, chaos.seed,
            )
            time.sleep(param)
        else:
            logger.warning(
                "replica chaos: %s — SIGKILL self (pid=%d seed=%d)",
                mode, os.getpid(), chaos.seed,
            )
            os.kill(os.getpid(), signal.SIGKILL)

    # -- KV-cache migration (not ported yet) -------------------------------
    def prefill_kv(self, prompt: Sequence[int], **kw) -> Optional[Dict[str, Any]]:
        """KV-migration export mode (disaggregated serving)."""
        raise NotImplementedError("prefill_kv " + _NOT_PORTED.format("KV migration"))

    def import_kv_blocks(self, tokens: Sequence[int], kv, timeout_s: float = 30.0) -> int:
        """KV-migration import mode (disaggregated serving)."""
        raise NotImplementedError("import_kv_blocks " + _NOT_PORTED.format("KV migration"))


    def _emit_token(self, req: Request, token: int) -> None:
        if req.finished:
            # cancelled/failed after this step's plan was built but before
            # its token was sampled: emitting would stream a stray token
            # and the done-path below would overwrite CANCELLED with
            # FINISHED, double-counting requests_total
            return
        req.generated.append(token)
        now = time.monotonic()
        self._token_times.append(now)
        self.metrics["tokens_total"].inc()
        first_span: Optional[tuple] = None
        ttft: Optional[float] = None
        with self._lock:
            q = self._out.get(req.request_id)
            if req.request_id not in self._first_token_at:
                self._first_token_at[req.request_id] = now
                sub = self._submitted_at.get(req.request_id)
                if sub is not None:
                    ttft = now - sub
                    self._ttft_tape.observe(ttft)
                    self._recent_ttfts.append((now, ttft))
                    wire = self._trace_ctx.get(req.request_id)
                    if wire is not None:
                        first_span = (wire, ttft)
        # SLO-ledger stamps: TTFT on the first token, the inter-token
        # gap on every later one (one histogram observe = bisect +
        # increment; the request object carries the per-token state)
        slo_labels = {
            "deployment": self.slo_deployment,
            "tenant_class": req.tenant_class,
        }
        if ttft is not None:
            if req.record_slo:
                self.metrics["ttft"].observe(ttft, labels=slo_labels)
        elif req.last_emit_at is not None:
            gap = now - req.last_emit_at
            self._recent_itls.append((now, gap))
            if gap > req.max_itl_s:
                req.max_itl_s = gap
            if req.record_slo:
                self.metrics["itl"].observe(gap, labels=slo_labels)
        req.last_emit_at = now
        if first_span is not None:
            # TTFT span under the caller's trace: engine admission +
            # queue + prefill chunks up to the first sampled token
            end_us = timeline._now_us()
            _tracing.record_span(
                first_span[0], "llm_first_token",
                end_us - first_span[1] * 1e6, end_us, category="inference",
                request_id=req.request_id,
                prompt_tokens=len(req.prompt),
                cached_prefix_tokens=req.cached_prefix_tokens,
            )
        if q is not None:
            q.put(token)
        done = (
            len(req.generated) >= req.max_new_tokens
            or (req.eos_token is not None and token == req.eos_token)
        )
        if done:
            # index the finished conversation's full blocks (multi-turn
            # reuse) BEFORE finish() releases them to the cache LRU.
            # Only positions whose K/V is actually written qualify: the
            # final sampled token's K/V never was (its decode step never
            # runs), so the registered prefix stops one token short.
            written = (req.prompt + req.generated)[: req.context_len - 1]
            self.blocks.register_prefix(req.request_id, written)
        if done and self.scheduler.finish(req, FINISHED):
            # finish() returns False when cancel() won the race after the
            # req.finished guard above — the cancel path already notified
            # the waiter and counted the outcome
            self._finish_request(req, FINISHED, error=None)

    def _finish_request(self, req: Request, state: str, error: Optional[Exception]) -> None:
        outcome = {FINISHED: "finished", CANCELLED: "cancelled"}.get(state, "failed")
        if self.spec is not None:
            try:
                self.spec.release(req.request_id)
            except Exception:  # noqa: BLE001 — draft cleanup is best-effort
                pass
        now = time.monotonic()
        with self._lock:
            q = self._out.get(req.request_id)
            submitted = self._submitted_at.pop(req.request_id, None)
            wire = self._trace_ctx.pop(req.request_id, None)
            first_token = self._first_token_at.pop(req.request_id, None)
            self._books[outcome] = self._books.get(outcome, 0) + 1
            if q is not None:
                # the queue stays for a late tokens() call; stamp it so an
                # abandoned stream is reaped instead of pinned forever
                self._finished_at[req.request_id] = now
        self._close_ledger(req, outcome, submitted, first_token, now, wire, error)
        if wire is not None and submitted is not None:
            # whole-request span under the caller's trace: admission
            # through the last decode step (covers every prefill chunk
            # and decode token the step loop ran for this request)
            end_us = timeline._now_us()
            _tracing.record_span(
                wire, "llm_request",
                end_us - (time.monotonic() - submitted) * 1e6, end_us,
                category="inference",
                request_id=req.request_id,
                outcome=outcome,
                generated_tokens=len(req.generated),
                preemptions=req.preemptions,
            )
        if q is not None:
            q.put(error if error is not None else _END)
        self.metrics["requests_total"].inc(labels={"outcome": outcome})

    def _close_ledger(
        self,
        req: Request,
        outcome: str,
        submitted: Optional[float],
        first_token: Optional[float],
        now: float,
        wire,
        error: Optional[Exception],
    ) -> None:
        """Close a request's SLO ledger: observe e2e, split its token
        work into goodput vs fault cost, and file the flight-recorder
        entry (flagged when the request violated an SLO target, was
        preempted, or ended abnormally — those are exactly the outliers
        an operator asks the recorder about)."""
        labels = {
            "deployment": self.slo_deployment,
            "tenant_class": req.tenant_class,
        }
        e2e = (now - submitted) if submitted is not None else None
        ttft = (
            first_token - submitted
            if submitted is not None and first_token is not None
            else None
        )
        if e2e is not None and req.record_slo:
            self.metrics["e2e"].observe(e2e, labels=labels)
        n_gen = len(req.generated)
        if n_gen:
            if outcome == "finished":
                self.metrics["goodput"].inc(n_gen, labels=labels)
            else:
                # decode work that never reached a satisfied client is
                # fault cost, attributed by why it was thrown away
                self.metrics["fault"].inc(
                    n_gen,
                    labels={"deployment": self.slo_deployment, "reason": outcome},
                )
        flags: List[str] = []
        if outcome != "finished":
            flags.append(outcome)
        if req.preemptions:
            flags.append("preempted")
        if ttft is not None and ttft > GLOBAL_CONFIG.slo_ttft_slow_s:
            flags.append("slow_ttft")
        if req.max_itl_s > GLOBAL_CONFIG.slo_itl_slow_s:
            flags.append("slow_itl")
        stages = {k: round(float(v), 6) for k, v in req.ledger_stages.items()}
        if submitted is not None and req.admitted_at is not None:
            stages["queue"] = round(max(0.0, req.admitted_at - submitted), 6)
        if req.admitted_at is not None and req.prefill_done_at is not None:
            stages["prefill"] = round(
                max(0.0, req.prefill_done_at - req.admitted_at), 6
            )
        if first_token is not None:
            stages["decode"] = round(max(0.0, now - first_token), 6)
        entry = {
            "tier": "engine",
            "request_id": req.request_id,
            "trace_id": wire[0] if wire else None,
            "deployment": self.slo_deployment,
            "tenant_class": req.tenant_class,
            "outcome": outcome,
            "error": repr(error) if error is not None else None,
            "ttft_s": round(ttft, 6) if ttft is not None else None,
            "e2e_s": round(e2e, 6) if e2e is not None else None,
            "max_itl_s": round(req.max_itl_s, 6),
            "prompt_tokens": len(req.prompt),
            "generated_tokens": n_gen,
            "cached_prefix_tokens": req.cached_prefix_tokens,
            "preemptions": req.preemptions,
            "stages": stages,
            "flags": flags,
        }
        # slowest-K keys on TOTAL latency (TTFT only when the request
        # never streamed): a fast-first-token request that then decoded
        # for minutes is exactly the outlier the heap must retain
        flight_recorder().add(
            entry,
            flagged=bool(flags),
            slow_key=e2e if e2e is not None else ttft,
        )

    def _fail_all(self, error: Exception) -> None:
        for req in self.scheduler.take_all():
            self.blocks.free(req.request_id)
            req.state = FAILED
            self._finish_request(req, FAILED, error=error)

    def _reap_abandoned_streams(self) -> None:
        ttl = self.engine_cfg.finished_stream_ttl_s
        if ttl <= 0:
            return
        now = time.monotonic()
        if now < self._next_stream_reap:
            return
        self._next_stream_reap = now + min(ttl, 10.0)
        with self._lock:
            dead = [r for r, t in self._finished_at.items() if now - t > ttl]
            for rid in dead:
                self._finished_at.pop(rid, None)
                self._out.pop(rid, None)

    def _tokens_per_s(self) -> float:
        # expired timestamps are dropped incrementally: the step loop calls
        # this via _update_gauges, and a full copy-and-filter of the 2048-cap
        # deque every step was measurable overhead at decode rates
        now = time.monotonic()
        tt = self._token_times
        while tt and now - tt[0] > 10.0:
            tt.popleft()
        if len(tt) < 2:
            return 0.0
        span = max(now - tt[0], 1e-6)
        return len(tt) / span

    @staticmethod
    def _recent_quantile(samples: deque, q: float, window_s: float = 30.0) -> float:
        """Quantile over the (ts, value) samples inside ``window_s`` —
        the sliding-window control signal the autopilot steers on. 0.0
        when the window is empty (callers treat that as "no signal").
        Reads a list() copy: the reporter thread computes this while the
        step thread appends."""
        now = time.monotonic()
        vals = sorted(v for ts, v in list(samples) if now - ts <= window_s)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, int(math.ceil(q * len(vals))) - 1))
        return vals[idx]

    def _prefill_tokens_per_s(self, window_s: float = 10.0) -> float:
        now = time.monotonic()
        entries = [(ts, n) for ts, n in list(self._prefill_token_times)
                   if now - ts <= window_s]
        if not entries:
            return 0.0
        span = max(now - entries[0][0], 1e-6)
        return sum(n for _ts, n in entries) / span

    def _ttft_quantiles(self) -> Dict[str, float]:
        """stats()/bench back-compat shape ({"p50", "p99"}), now derived
        from this engine's log-bucket TTFT tape instead of a sorted
        sample deque (the old deque fed quantile GAUGES, which cannot be
        aggregated across replicas — the histogram can)."""
        with self._lock:
            if self._ttft_tape.total == 0:
                return {}
            p50 = self._ttft_tape.quantile(0.50)
            p99 = self._ttft_tape.quantile(0.99)
        return {"p50": p50, "p99": p99}

    def _update_gauges(self, decode_batch: int) -> None:
        m = self.metrics
        m["decode_batch"].set(decode_batch)
        pre = self.scheduler.total_preempted - getattr(self, "_preempt_seen", 0)
        if pre > 0:
            m["preemptions_total"].inc(pre)
        self._preempt_seen = self.scheduler.total_preempted
        # fault-cost ledger: prefill tokens readmissions had to RE-RUN
        # (delta-tracked from the scheduler like the preemption counter)
        replay = self.scheduler.total_replay_prefill_tokens - self._replay_seen
        if replay > 0:
            m["fault"].inc(
                replay,
                labels={
                    "deployment": self.slo_deployment,
                    "reason": "preempt_replay",
                },
            )
            self._replay_seen = self.scheduler.total_replay_prefill_tokens
        # prefix-cache counters ride the same delta pattern (the manager
        # owns the source of truth; /metrics gets monotonic counters)
        for attr, name in (
            ("prefix_hits_total", "prefix_hits_total"),
            ("prefix_tokens_saved_total", "prefix_tokens_saved_total"),
            ("cow_copies_total", "cow_copies_total"),
        ):
            cur = getattr(self.blocks, attr)
            seen = self._prefix_seen.get(attr, 0)
            if cur > seen:
                m[name].inc(cur - seen)
                self._prefix_seen[attr] = cur
        # the remaining gauges cost lock round-trips — at hundreds of
        # steps/s that's pure step-loop overhead, so refresh them at 4 Hz
        # (first step always publishes, so metric names appear on
        # /metrics as soon as anything runs)
        now = time.monotonic()
        if now < self._next_gauge_refresh:
            return
        self._next_gauge_refresh = now + 0.25
        m["cache_util"].set(self.blocks.utilization())
        m["queue_depth"].set(self.scheduler.queue_depth())
        m["active"].set(len(self.scheduler.running))
        m["tps"].set(round(self._tokens_per_s(), 2))
        # adaptive speculative k rides the same 4 Hz refresh: steer the
        # live draft budget on the acceptance rate measured since the
        # last refresh window with enough proposals to mean something.
        # Shrinking/growing k never recompiles — the verify bucket stays
        # sized for speculative_k+1 and shorter windows pad via true_len.
        if self.spec is not None:
            prop, acc = self._spec_proposed, self._spec_accepted
            d_prop = prop - self._spec_window_seen[0]
            d_acc = acc - self._spec_window_seen[1]
            if d_prop >= 8:
                rate = d_acc / d_prop
                self._spec_acceptance = rate
                m["spec_acceptance"].set(round(rate, 4))
                self._spec_window_seen = (prop, acc)
                if self.engine_cfg.speculative_adaptive:
                    k = (
                        self.scheduler.spec_k_live
                        or self.engine_cfg.speculative_k
                    )
                    if rate < self.engine_cfg.speculative_accept_floor and k > 1:
                        self.scheduler.spec_k_live = k - 1
                    elif rate >= 0.75 and k < self.engine_cfg.speculative_k:
                        self.scheduler.spec_k_live = k + 1

    # -- introspection ----------------------------------------------------
    def set_deployment_name(self, name: str) -> None:
        """Stamp the serve deployment label onto this engine's SLO
        series (serve/replica.py calls this through the callable before
        any request arrives)."""
        self.slo_deployment = str(name or "")

    def ledger_books(self) -> Dict[str, Any]:
        """Intake conservation books (slo.books_balanced): submitted ==
        finished + failed + cancelled + queued + running, exactly, at
        quiesce — the gate that proves no fault path (chaos kill, drain
        cutoff, preemption churn, disconnect cancel) leaks a request."""
        with self._lock:
            books = dict(self._books)
        s = self.scheduler.stats()
        books.update(
            kind="engine",
            queued=s["queue_depth"],
            running=s["running"],
            total_admitted=s["total_admitted"],
            replay_prefill_tokens=self.scheduler.total_replay_prefill_tokens,
        )
        return books

    def slo_snapshot(self) -> Dict[str, Any]:
        """This process's SLO ledger state + this engine's books (the
        serve controller's ``slo_report`` fans this out per replica)."""
        snap = _slo.snapshot()
        snap["books"] = self.ledger_books()
        snap["tier"] = "engine"
        snap["deployment"] = self.slo_deployment
        return snap

    def stats(self) -> Dict[str, Any]:
        # draft + verify buckets ride the same zero-recompile gate: a
        # speculative engine's compile books count the draft runner too
        spec_compiles = self.spec.compile_count() if self.spec is not None else 0
        spec_recompiles = (
            self.spec.recompiles_after_warmup() if self.spec is not None else 0
        )
        s = {
            "scheduler": self.scheduler.stats(),
            "blocks": self.blocks.stats(),
            "prefix_cache": self.blocks.prefix_stats(),
            "total_steps": self.total_steps,
            "draining": self._draining,
            "compile_count": self.runner.compile_count() + spec_compiles,
            "recompiles_after_warmup": (
                self.runner.recompiles_after_warmup() + spec_recompiles
            ),
            "tokens_per_s": round(self._tokens_per_s(), 2),
            "ttft": {k: round(v, 6) for k, v in self._ttft_quantiles().items()},
        }
        if self.spec is not None:
            prop, acc = self._spec_proposed, self._spec_accepted
            s["speculative"] = {
                "k": self.engine_cfg.speculative_k,
                "k_live": self.scheduler.spec_k_live,
                "draft": self.engine_cfg.speculative_draft,
                "proposed_tokens": prop,
                "accepted_tokens": acc,
                "rollbacks": self._spec_rollbacks,
                "acceptance_rate": round(acc / prop, 4) if prop else 0.0,
            }
        return s

    def routing_stats(self) -> Dict[str, Any]:
        """Compact replica load + cache-locality digest, gossiped to
        routers through the serve controller's long-poll channel
        (replica -> controller push -> router). Everything here must
        stay small and picklable — it travels on every routing-set
        update. ``kv_tier`` holds no adverts: the tier is not ported
        yet, and the reference reports ``{}`` with the tier off."""
        return {
            "queue_depth": self.scheduler.queue_depth(),
            "cache_util": round(self.blocks.utilization(), 4),
            "outstanding_tokens": self.scheduler.outstanding_tokens(),
            "block_size": self.blocks.block_size,
            "prefix_digest": self.blocks.prefix_digest(),
            "kv_tier": {},
            "draining": self._draining,
            # queue-pressure export for the ingress tier: the admission
            # BOUND (so a proxy can judge fullness, not just depth) and
            # the monotonic intake count (so shed-vs-admitted reconciles
            # without a replica round-trip per request)
            "max_queue_depth": self.engine_cfg.max_queue_depth,
            "total_admitted": self.scheduler.total_admitted,
            # closed-loop control signals (serve/controller.py autopilot
            # + ingress ITL-derived shed threshold + disagg pool-ratio
            # adaptation): sliding-window latency quantiles and token
            # throughput, NOT the lifetime ledger tapes — the autopilot
            # must feel current burn, not the whole run's history
            "ttft_p99_s": round(self._recent_quantile(self._recent_ttfts, 0.99), 6),
            "itl_p99_s": round(self._recent_quantile(self._recent_itls, 0.99), 6),
            "decode_tokens_per_s": round(self._tokens_per_s(), 2),
            "prefill_tokens_per_s": round(self._prefill_tokens_per_s(), 2),
        }

    def healthy(self) -> bool:
        """Liveness the serve controller polls through ``replica.health()``:
        False once the step loop is dead, or wedged — work pending with
        no loop heartbeat inside ``step_stall_unhealthy_s``. A stalled
        step thread doesn't stop the actor's async loop from answering
        RPCs, so plain reachability checks can never catch it."""
        if self._stop.is_set():
            return False
        if self._thread is None or not self._thread.is_alive():
            return False
        stall = self.engine_cfg.step_stall_unhealthy_s
        if stall > 0 and self.scheduler.has_work():
            return time.monotonic() - self._last_beat <= stall
        return True

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no queued/running work remains (drain helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.scheduler.has_work():
                return True
            time.sleep(0.005)
        return not self.scheduler.has_work()
