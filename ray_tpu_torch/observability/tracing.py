"""Distributed tracing: causal spans from submit to TPU step.

Reference shape: OpenTelemetry-style ``trace_id``/``span_id``/
``parent_span_id`` context propagation, carried the same two ways
``core/deadline`` already travels:

* **in-process** — a ``contextvars.ContextVar`` holds the ambient
  :class:`TraceContext`; :func:`span` mints a child span, records it
  into the existing timeline ring buffer (``observability/timeline``)
  and makes it the ambient parent for everything nested under it.
* **cross-process** — task submission stamps ``(trace_id, span_id)``
  onto ``TaskSpec.trace_ctx`` (a per-call field, so template-spliced
  hot-path submits carry it too) and RPC requests append it to the
  dedup meta slot (``core/rpc.py``); the receiving side re-enters the
  context with :func:`scope`, so its spans parent to the sender's.

Spans are ordinary :class:`timeline.ProfileEvent`\\ s whose ``args``
carry ``trace_id``/``span_id``/``parent_span_id`` — ``dump_timeline``
emits chrome-trace *flow events* for every parent→child edge it can
resolve, which is what draws the cross-process arrows in Perfetto.

SAMPLING. Everything here is gated on ``trace_sample_rate`` (default
0.0): with no ambient context and a zero rate, every entry point is a
single attribute read + compare — the submit hot path pays no span
allocation when unsampled. A root
is sampled once at a request entry point (client submit, serve router
dispatch) and the verdict is inherited causally: children of a sampled
request are always recorded, children of an unsampled one never are.

Trace ids are prefixed with a cluster-wide *trace epoch* (minted by the
submitting process, threaded through every spawned runtime process via the
``RAY_TPU_TRACE_EPOCH`` env var in ``cluster_backend``), so ids from
one cluster incarnation never collide with a restarted one's.
"""

from __future__ import annotations

import contextvars
import os
import random
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.observability import timeline as _timeline

#: env var carrying the cluster-wide trace epoch into spawned processes
TRACE_EPOCH_ENV = "RAY_TPU_TRACE_EPOCH"


class TraceContext:
    """Ambient trace position: which trace we are in, and which span is
    the current causal parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def wire(self) -> Tuple[str, str]:
        return (self.trace_id, self.span_id)

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, {self.span_id})"


_current: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)

_epoch: Optional[str] = None


def trace_epoch() -> str:
    """Cluster-wide epoch prefix for trace ids: inherited from the
    spawning process via env, minted once per process otherwise."""
    global _epoch
    if _epoch is None:
        _epoch = os.environ.get(TRACE_EPOCH_ENV) or os.urandom(4).hex()
    return _epoch


def random_bytes(n: int) -> bytes:
    return os.urandom(n)


def _new_span_id() -> str:
    return random_bytes(8).hex()


def _new_trace_id() -> str:
    return trace_epoch() + random_bytes(8).hex()


def current() -> Optional[TraceContext]:
    return _current.get()


def current_wire() -> Optional[Tuple[str, str]]:
    """The ambient (trace_id, span_id) pair, or None when untraced —
    what travels on specs and RPC meta slots."""
    ctx = _current.get()
    return None if ctx is None else ctx.wire()


def sampled() -> bool:
    """Roll the sampling dice for a NEW root (no ambient context)."""
    rate = GLOBAL_CONFIG.trace_sample_rate
    if rate <= 0.0:
        return False
    return rate >= 1.0 or random.random() < rate


def _decode_wire(wire) -> Optional[Tuple[str, str]]:
    """Normalize a wire context that may have round-tripped through
    msgpack (str → bytes) or pickle (unchanged)."""
    if not wire:
        return None
    try:
        t, s = wire[0], wire[1]
        if isinstance(t, (bytes, bytearray)):
            t = bytes(t).decode()
        if isinstance(s, (bytes, bytearray)):
            s = bytes(s).decode()
        return (t, s)
    except Exception:
        return None


@contextmanager
def scope(wire) -> Iterator[Optional[TraceContext]]:
    """Re-enter a received trace context (no span recorded): spans
    opened inside parent to the sender's span. No-op for None."""
    decoded = _decode_wire(wire)
    if decoded is None:
        yield None
        return
    token = _current.set(TraceContext(decoded[0], decoded[1]))
    try:
        yield _current.get()
    finally:
        _current.reset(token)


def _record(
    name: str,
    category: str,
    start_us: float,
    end_us: float,
    trace_id: str,
    span_id: str,
    parent_span_id: Optional[str],
    args: Optional[Dict[str, Any]],
) -> None:
    ev_args: Dict[str, Any] = dict(args or {})
    ev_args["trace_id"] = trace_id
    ev_args["span_id"] = span_id
    if parent_span_id:
        ev_args["parent_span_id"] = parent_span_id
    _timeline.record_event(name, category, start_us, end_us, args=ev_args)


@contextmanager
def span(name: str, category: str = "trace", **args) -> Iterator[Optional[TraceContext]]:
    """Record one span under the ambient context. ZERO-COST when no
    context is ambient: nothing is minted, nothing is recorded."""
    parent = _current.get()
    if parent is None:
        yield None
        return
    child = TraceContext(parent.trace_id, _new_span_id())
    token = _current.set(child)
    start = _timeline._now_us()
    try:
        yield child
    finally:
        _current.reset(token)
        _record(
            name, category, start, _timeline._now_us(),
            child.trace_id, child.span_id, parent.span_id, args or None,
        )


@contextmanager
def root_span(name: str, category: str = "trace", **args) -> Iterator[Optional[TraceContext]]:
    """Span that STARTS a trace at a request entry point (serve router
    dispatch, client-side API boundaries): a child span when a context
    is already ambient, a fresh sampled root otherwise, a no-op when the
    sampler says no."""
    if _current.get() is not None:
        with span(name, category, **args) as ctx:
            yield ctx
        return
    if not sampled():
        yield None
        return
    root = TraceContext(_new_trace_id(), _new_span_id())
    token = _current.set(root)
    start = _timeline._now_us()
    try:
        yield root
    finally:
        _current.reset(token)
        _record(
            name, category, start, _timeline._now_us(),
            root.trace_id, root.span_id, None, args or None,
        )


def record_span(
    wire,
    name: str,
    start_us: float,
    end_us: float,
    category: str = "trace",
    **args,
) -> Optional[str]:
    """Record a span parented to a WIRE context without entering it —
    for code that holds timestamps from another thread (the engine step
    loop stamping per-request spans). Returns the new span id."""
    decoded = _decode_wire(wire)
    if decoded is None:
        return None
    span_id = _new_span_id()
    _record(name, category, start_us, end_us, decoded[0], span_id, decoded[1], args or None)
    return span_id


def stamp_spec(spec) -> None:
    """Submission-side stamping (CoreWorker.submit_task /
    submit_actor_task / create_actor): inherit the ambient context, or
    sample a fresh root and record an instant ``submit::`` span for it.
    The spec's ``trace_ctx`` is a per-call field, so template-spliced
    submits carry it on the wire too. Unsampled + no ambient = one
    contextvar read and one float compare."""
    ctx = _current.get()
    if ctx is None:
        if not sampled():
            return
        trace_id = _new_trace_id()
        span_id = _new_span_id()
        now = _timeline._now_us()
        _record(
            f"submit::{spec.name}", "task", now, now,
            trace_id, span_id, None, {"task_id": spec.task_id.hex()[:16]},
        )
        spec.trace_ctx = (trace_id, span_id)
        return
    # inherit: the executing side's task span parents to the CURRENT
    # span (the submitting task / router dispatch / user span)
    spec.trace_ctx = ctx.wire()


async def carry(coro, wire):
    """Await ``coro`` inside ``scope(wire)`` — how ``IoThread.run``
    forwards the caller thread's ambient trace onto the io loop
    (run_coroutine_threadsafe does not propagate contextvars)."""
    with scope(wire):
        return await coro
