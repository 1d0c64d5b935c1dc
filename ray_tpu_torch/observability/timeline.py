"""Task timeline: chrome://tracing dump of profile events (port of
``ray_tpu.observability.timeline``, the in-process part).

Every process records ``ProfileEvent``s into a bounded in-memory ring
buffer; ``dump_timeline`` writes this process's buffer as one chrome-trace
file loadable in chrome://tracing or Perfetto. Events whose args carry
trace ids (``observability/tracing.py``) additionally yield flow events.
The reference's cluster export (worker chunks through the controller)
is not ported yet.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_MAX_EVENTS = 100_000


@dataclass
class ProfileEvent:
    name: str
    category: str
    start_us: float
    end_us: float
    pid: int = field(default_factory=os.getpid)
    tid: int = 0
    args: Optional[Dict[str, Any]] = None


_events: "deque[ProfileEvent]" = deque(maxlen=_MAX_EVENTS)
_lock = threading.Lock()


def _now_us() -> float:
    # Wall clock, not perf_counter: events from many processes are merged
    # into one trace, so timestamps need a shared epoch.
    return time.time_ns() / 1e3


def record_event(
    name: str,
    category: str,
    start_us: float,
    end_us: float,
    args: Optional[Dict[str, Any]] = None,
) -> None:
    ev = ProfileEvent(
        name=name,
        category=category,
        start_us=start_us,
        end_us=end_us,
        tid=threading.get_ident() % 1_000_000,
        args=args,
    )
    with _lock:
        _events.append(ev)


@contextmanager
def profile(name: str, category: str = "task", **args):
    """Context manager recording one complete event (cf. ray.profiling)."""
    start = _now_us()
    try:
        yield
    finally:
        record_event(name, category, start, _now_us(), args=args or None)


def timeline_events() -> List[ProfileEvent]:
    with _lock:
        return list(_events)


def clear_events() -> None:
    with _lock:
        _events.clear()


def _flow_events(events: List[ProfileEvent]) -> List[Dict[str, Any]]:
    """Chrome-trace flow events for every resolvable trace edge: spans
    (events whose args carry ``span_id``) are indexed, and each child's
    ``parent_span_id`` found in the index yields an ``s``/``f`` pair —
    the arrows Perfetto draws from the parent's slice (any process) to
    the child's. Unresolvable parents (not exported yet) are skipped."""
    by_span: Dict[str, ProfileEvent] = {}
    for ev in events:
        sid = (ev.args or {}).get("span_id")
        if sid:
            by_span[sid] = ev
    out: List[Dict[str, Any]] = []
    for ev in events:
        args = ev.args or {}
        parent_id = args.get("parent_span_id")
        sid = args.get("span_id")
        if not parent_id or not sid:
            continue
        parent = by_span.get(parent_id)
        if parent is None:
            continue
        flow_id = int(sid[:12], 16)
        common = {"name": "trace", "cat": "trace", "id": flow_id}
        # start binds to the parent's slice, finish ("e" = enclosing
        # slice) to the child's — ts must fall inside each slice
        out.append(
            dict(common, ph="s", ts=parent.start_us, pid=parent.pid, tid=parent.tid)
        )
        out.append(
            dict(common, ph="f", bp="e", ts=ev.start_us, pid=ev.pid, tid=ev.tid)
        )
    return out


def dump_timeline(filename: Optional[str] = None) -> Any:
    """Dump chrome://tracing JSON (slices + trace flow arrows). Returns
    the trace list (and writes ``filename`` if given) — matches
    ``ray.timeline`` semantics; load in Perfetto / chrome://tracing."""
    events = timeline_events()
    trace = []
    for ev in events:
        trace.append(
            {
                "name": ev.name,
                "cat": ev.category,
                "ph": "X",
                "ts": ev.start_us,
                "dur": max(0.0, ev.end_us - ev.start_us),
                "pid": ev.pid,
                "tid": ev.tid,
                "args": ev.args or {},
            }
        )
    trace.extend(_flow_events(events))
    trace.sort(key=lambda e: e["ts"])
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
