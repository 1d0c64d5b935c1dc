"""Continuous-batching scheduler: per-step prefill/decode selection.

Reference shape (vLLM / the TPU inference workers in PAPERS.md): one
scheduler invocation per engine step returns a :class:`StepPlan` — at
most ``max_prefills_per_step`` prefill *chunks* plus the batch of decode
slots to advance one token. Decode and prefill coexist in a step, which
is what makes the batching "continuous": a new request's prefill rides
alongside the standing decode batch instead of draining it.

Policies, all host-side and unit-testable without jax:

* **admission control** — a request is admitted only when the block pool
  can cover its full prompt plus one decode block of headroom; otherwise
  it waits in the FIFO admission queue (bounded by ``max_queue_depth``).
* **preemption** — when a decoding request needs one more block and the
  pool is dry, the lowest-priority latest-arrival running request is
  evicted: blocks freed, request back to the FRONT of the queue with its
  generated-so-far tokens kept; readmission re-prefills prompt+generated
  (vLLM's recompute-style preemption — cheaper than swap on TPU where
  host<->HBM bandwidth is the scarce resource).
* **cancellation** — frees blocks immediately, whether the request is
  queued, prefilling, or decoding.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.inference.kv_cache import PagedBlockManager

# request lifecycle states
QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
FAILED = "FAILED"

_seq = itertools.count()


@dataclass
class Request:
    """One generation request as the scheduler sees it."""

    request_id: str
    prompt: List[int]
    max_new_tokens: int = 16
    #: larger = more important; preemption victims are chosen from the
    #: lowest priority first (ties: latest arrival)
    priority: int = 0
    temperature: float = 0.0
    eos_token: Optional[int] = None
    #: ``core.deadline.Deadline`` (or None) — the engine fails the
    #: request the step after its budget runs out
    deadline: object = None
    seed: Optional[int] = None
    #: export-after-prefill mode (disaggregated serving): the request
    #: finishes when its prompt K/V is fully written — no token is ever
    #: sampled; the engine gathers the full blocks to host and hands the
    #: payload to the waiting exporter instead
    prefill_only: bool = False
    #: SLO-ledger label: the ingress priority class that admitted this
    #: request ("" for direct callers) — rides into the latency
    #: histograms and the flight-recorder entry
    tenant_class: str = ""
    #: pre-measured stage durations stamped by upstream tiers (e.g. the
    #: decode replica's KV import ran BEFORE submit) — merged into the
    #: ledger's stage breakdown at finish
    ledger_stages: Dict[str, float] = field(default_factory=dict)
    #: False for router RESUME attempts (rid.rN): the survivor's warm
    #: replay produces an artificially fast engine-view TTFT/ITL, so
    #: observing it into the SLO histograms would make cluster quantiles
    #: look BETTER under failover. The client-perceived failover cost
    #: lives in the router-tier ledger; resume attempts still book
    #: goodput/fault tokens and file flight-recorder entries.
    record_slo: bool = True
    #: speculative-decoding draft budget for this request (0 = plain
    #: decode; the per-request off-switch). The engine stamps it from
    #: EngineConfig at submit; the scheduler may plan LESS per step
    #: (``spec_step_k``) under block pressure or adaptive-k shrink.
    spec_k: int = 0

    state: str = QUEUED
    #: prompt positions already written to the KV cache (chunked prefill
    #: cursor); on preemption this resets to 0 and the *effective* prompt
    #: becomes the prompt + generated SNAPSHOT taken at eviction
    prefill_pos: int = 0
    generated: List[int] = field(default_factory=list)
    preemptions: int = 0
    #: frozen at preemption time (prompt + generated-so-far). A live
    #: ``prompt + self.generated`` here would GROW as decode appends
    #: tokens, flipping ``prefill_done`` back to False every step and
    #: silently routing decode through ungrown prefill chunks.
    restart_prompt: Optional[List[int]] = None
    #: device block copies the engine must run BEFORE this request's
    #: next prefill chunk (prefix-cache COW: a full-prompt hit recomputes
    #: its last token into a private copy of the final shared block)
    pending_cow: List[tuple] = field(default_factory=list)
    #: prompt tokens covered by the prefix cache at (re)admission —
    #: prefill was skipped for them (observability)
    cached_prefix_tokens: int = 0
    arrival: int = field(default_factory=lambda: next(_seq))
    # -- SLO-ledger lifecycle stamps (monotonic floats on the request
    # object the scheduler/engine already pass around — the hot path
    # pays one clock read per boundary, no allocation)
    #: first admission into the running set (queue-wait ends here;
    #: readmissions after preemption keep the ORIGINAL stamp — the
    #: client-visible queue wait happened once)
    admitted_at: Optional[float] = None
    #: prompt K/V fully written (prefill stage ends here)
    prefill_done_at: Optional[float] = None
    #: last token emission (the engine derives per-token decode gaps)
    last_emit_at: Optional[float] = None
    #: worst inter-token gap seen (the request's ITL high-water mark)
    max_itl_s: float = 0.0
    #: drafts the CURRENT step may verify for this slot — set by the
    #: scheduler every plan (0 = this step decodes plainly): speculation
    #: is opportunistic, it never preempts and shrinks to zero whenever
    #: the pool can't cover the extra draft positions
    spec_step_k: int = 0

    @property
    def effective_prompt(self) -> List[int]:
        """What prefill must (re)process: the original prompt, or the
        snapshot taken when the request was last preempted."""
        return self.restart_prompt if self.restart_prompt is not None else self.prompt

    @property
    def context_len(self) -> int:
        """Token positions currently live in the KV cache."""
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= len(self.effective_prompt)

    @property
    def finished(self) -> bool:
        return self.state in (FINISHED, CANCELLED, FAILED)


@dataclass
class StepPlan:
    """What one engine step should run."""

    #: (request, chunk_start, chunk_len) prefill chunks, at most
    #: ``max_prefills_per_step``
    prefills: List[tuple] = field(default_factory=list)
    #: requests advancing one decode token this step
    decodes: List[Request] = field(default_factory=list)
    #: requests the scheduler finished/failed while planning (deadline
    #: expiry, preemption-queue overflow) — the engine must notify waiters
    reaped: List[Request] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefills and not self.decodes and not self.reaped


class ContinuousBatchingScheduler:
    def __init__(
        self,
        blocks: PagedBlockManager,
        *,
        max_decode_batch: int = 8,
        max_prefill_chunk: int = 64,
        max_prefills_per_step: int = 1,
        max_queue_depth: int = 128,
    ):
        self.blocks = blocks
        self.max_decode_batch = max_decode_batch
        self.max_prefill_chunk = max_prefill_chunk
        self.max_prefills_per_step = max_prefills_per_step
        self.max_queue_depth = max_queue_depth
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        #: engine-side speculative caps, consulted when planning decode
        #: slots: ``spec_k_live`` is the adaptive-k controller's current
        #: ceiling (None = uncapped), ``spec_max_context`` the model's
        #: max_seq_len (draft positions must stay inside the block-table
        #: row width)
        self.spec_k_live: Optional[int] = None
        self.spec_max_context: Optional[int] = None
        self._lock = threading.RLock()
        self.admitting = True
        # observability
        self.total_admitted = 0
        self.total_preempted = 0
        self.steps_with_prefill_and_decode = 0
        self.max_decode_batch_seen = 0
        #: prefill tokens RE-RUN because a preemption evicted their KV
        #: (minus what the prefix cache still covered at readmission) —
        #: the engine delta-exports this as fault-cost tokens
        self.total_replay_prefill_tokens = 0

    # -- intake -----------------------------------------------------------
    def add(self, req: Request) -> None:
        with self._lock:
            if not self.admitting:
                raise RuntimeError("engine is draining: not admitting requests")
            if len(self.waiting) >= self.max_queue_depth:
                raise RuntimeError(
                    f"admission queue full ({self.max_queue_depth} waiting)"
                )
            self.waiting.append(req)

    def cancel(self, request_id: str) -> Optional[Request]:
        """Cancel wherever the request is; frees its blocks. Returns the
        request (for waiter notification) or None if unknown/finished."""
        with self._lock:
            for pool in (self.waiting, self.running):
                for req in pool:
                    if req.request_id == request_id:
                        pool.remove(req)
                        req.state = CANCELLED
                        self.blocks.free(request_id)
                        return req
        return None

    def take_all(self) -> List[Request]:
        """Atomically strip every queued + running request (engine-level
        failure path: the caller owns notifying waiters / freeing blocks)."""
        with self._lock:
            out = list(self.waiting) + list(self.running)
            self.waiting.clear()
            self.running.clear()
            return out

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.waiting or self.running)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self.waiting)

    def outstanding_tokens(self) -> int:
        """Token-denominated backlog: prefill still owed plus decode
        still to run, across queued and running requests — the router's
        least-outstanding-tokens load signal (a queue-DEPTH count rates
        a 4-token probe and a 2k-token prompt the same; tokens don't)."""
        total = 0
        with self._lock:
            for req in self.waiting:
                total += len(req.effective_prompt) + req.max_new_tokens
            for req in self.running:
                prompt = req.effective_prompt
                total += max(0, len(prompt) - req.prefill_pos)
                total += max(0, req.max_new_tokens - len(req.generated))
        return total

    # -- planning ---------------------------------------------------------
    def _admit(self, reaped: List[Request]) -> None:
        """FIFO admission: pop waiting requests while blocks cover their
        effective prompt + one decode block of headroom."""
        # expiry sweep over the WHOLE queue first: an expired request
        # stuck behind a non-admittable head must still fail promptly —
        # a head-only check would leave it QUEUED (and its caller
        # blocked) until the head eventually admits
        for req in list(self.waiting):
            if req.deadline is not None and getattr(req.deadline, "expired", False):
                self.waiting.remove(req)
                req.state = FAILED
                reaped.append(req)
        while self.waiting:
            req = self.waiting[0]
            prompt = req.effective_prompt
            # prefix cache: attach shared blocks covering the longest
            # cached prefix; prefill then plans only the uncached tail.
            # A readmission re-queries too — its own blocks usually
            # still sit in the cache, making readmission near-free.
            cached, cow = self.blocks.acquire_prefix(req.request_id, prompt)
            need = len(prompt) + 1  # headroom: first decode token
            if not self.blocks.grow_to(req.request_id, need):
                if cached or cow:
                    # roll the acquisition back: a QUEUED request must
                    # hold nothing, or pool accounting drifts while it
                    # waits (the next tick re-acquires — the hit blocks
                    # just return to the cache LRU meanwhile)
                    self.blocks.free(req.request_id)
                break  # FIFO: don't starve the head by admitting behind it
            self.waiting.pop(0)
            req.state = PREFILL
            req.prefill_pos = cached
            req.pending_cow = list(cow)
            req.cached_prefix_tokens = cached
            self.blocks.note_prefix_hit(cached)
            self.running.append(req)
            if req.admitted_at is None:
                req.admitted_at = time.monotonic()
            if req.preemptions == 0:
                # readmissions after preemption are churn, not intake —
                # they show up in total_preempted instead
                self.total_admitted += 1
            else:
                # the fault-cost ledger: prefill work this readmission
                # must REDO (the cache-covered prefix costs nothing)
                self.total_replay_prefill_tokens += max(0, len(prompt) - cached)

    def _preempt_one(self, exclude: Request, protected_ids=frozenset()) -> bool:
        """Evict the lowest-priority, latest-arrival running request
        (other than ``exclude`` and anything in ``protected_ids`` — the
        requests already placed in THIS step's plan, which the engine
        will execute with the block tables they hold right now) and push
        it back to the queue front."""
        candidates = [
            r
            for r in self.running
            if r is not exclude and id(r) not in protected_ids
        ]
        if not candidates:
            return False
        victim = min(candidates, key=lambda r: (r.priority, -r.arrival))
        if victim.priority > exclude.priority:
            return False  # never preempt strictly-higher priority work
        self.running.remove(victim)
        self.blocks.evict(victim.request_id)  # also drops any COW pins
        victim.state = QUEUED
        victim.prefill_pos = 0
        victim.preemptions += 1
        victim.restart_prompt = victim.prompt + victim.generated
        # an unexecuted COW died with the eviction: readmission
        # re-acquires from the cache and plans a fresh copy if needed
        victim.pending_cow = []
        self.waiting.insert(0, victim)
        self.total_preempted += 1
        return True

    def schedule(self) -> StepPlan:
        plan = StepPlan()
        with self._lock:
            self._admit(plan.reaped)

            # deadline reaping for running work (budget exhausted mid-flight)
            for req in list(self.running):
                if req.deadline is not None and getattr(req.deadline, "expired", False):
                    self.running.remove(req)
                    self.blocks.free(req.request_id)
                    req.state = FAILED
                    plan.reaped.append(req)

            # prefill chunks: oldest prefill-incomplete requests first
            prefilling = sorted(
                (r for r in self.running if not r.prefill_done),
                key=lambda r: (-r.priority, r.arrival),
            )
            for req in prefilling[: self.max_prefills_per_step]:
                prompt = req.effective_prompt
                start = req.prefill_pos
                chunk = min(self.max_prefill_chunk, len(prompt) - start)
                plan.prefills.append((req, start, chunk))

            # decode batch: fully-prefilled requests, highest priority /
            # oldest first when the batch cap bites. Each needs this
            # step's write position covered by a block — grow, preempting
            # on exhaustion. A victim must never be something already in
            # the plan: the engine would run it on freed (null) blocks.
            planned_ids = {id(p[0]) for p in plan.prefills}
            decodable = sorted(
                (r for r in self.running if r.prefill_done),
                key=lambda r: (-r.priority, r.arrival),
            )
            for req in decodable[: self.max_decode_batch]:
                if req not in self.running:
                    continue  # evicted by an earlier decode's growth
                # the step writes KV at position context_len-1 (the token
                # sampled LAST step): coverage of exactly context_len
                # positions; the token emitted this step grows the table
                # next step
                need = req.context_len
                # speculative slots want k extra positions (the verify
                # window writes K/V at context_len-1 .. context_len+k-1).
                # Opportunistic only: spec growth never preempts, and a
                # dry pool degrades the slot to plain decode this step.
                k = req.spec_k
                if k > 0:
                    if self.spec_k_live is not None:
                        k = min(k, self.spec_k_live)
                    k = min(k, req.max_new_tokens - len(req.generated) - 1)
                    if self.spec_max_context is not None:
                        k = min(k, self.spec_max_context - need)
                    k = max(0, k)
                req.spec_step_k = 0
                if k > 0 and self.blocks.grow_to(req.request_id, need + k):
                    req.spec_step_k = k
                    plan.decodes.append(req)
                    planned_ids.add(id(req))
                    continue
                grown = self.blocks.grow_to(req.request_id, need)
                while not grown and self._preempt_one(req, planned_ids):
                    grown = self.blocks.grow_to(req.request_id, need)
                if grown:
                    plan.decodes.append(req)
                    planned_ids.add(id(req))
                # else: stalled this step — retried next step once a
                # finishing request returns blocks

            if plan.prefills and plan.decodes:
                self.steps_with_prefill_and_decode += 1
            self.max_decode_batch_seen = max(
                self.max_decode_batch_seen, len(plan.decodes)
            )
        return plan

    # -- completion -------------------------------------------------------
    def finish(self, req: Request, state: str = FINISHED) -> bool:
        """Move ``req`` to a terminal state and free its blocks. Returns
        False when the request is ALREADY terminal — cancel() and the
        step thread's done-path race, and both state transitions happen
        under this lock, so exactly one caller wins (the loser must not
        notify waiters or count the outcome again)."""
        with self._lock:
            if req.finished:
                return False
            if req in self.running:
                self.running.remove(req)
            self.blocks.free(req.request_id)
            req.state = state
            return True

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "queue_depth": len(self.waiting),
                "running": len(self.running),
                "admitting": self.admitting,
                "total_admitted": self.total_admitted,
                "total_preempted": self.total_preempted,
                "steps_with_prefill_and_decode": self.steps_with_prefill_and_decode,
                "max_decode_batch_seen": self.max_decode_batch_seen,
            }
