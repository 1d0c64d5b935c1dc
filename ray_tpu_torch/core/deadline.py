"""Deadline propagation: one time budget shared by nested blocking calls.

The hang class this kills: caller passes ``timeout=120`` to an outer
call, the implementation stacks *independent* inner timeouts (a 60s get
inside a retry loop inside a 30s RPC…) and the outer budget quietly
becomes minutes — or, with an inner ``timeout=None``, forever. Instead a
:class:`Deadline` is entered once at the outer boundary and every nested
``get()``/``wait()`` (and any code that asks :func:`effective_timeout`)
inherits the *remaining* budget.

Propagation is two-layer:

* in-process: a ``contextvars.ContextVar`` — async tasks and the sync
  call stack both see the ambient deadline (``deadline_scope``).
* cross-process: task submission stamps the remaining budget onto the
  ``TaskSpec`` (``deadline_remaining_s``); the executing worker re-enters
  a scope with that budget, so a ``get()`` *inside* a remote task is
  truncated by the caller's deadline too (reference analogue: gRPC
  deadline propagation, which the reference leans on implicitly).

Absolute wall/monotonic timestamps never cross process boundaries —
only remaining seconds, re-anchored on arrival (clocks differ; in-flight
time is eroded from the budget by construction on the worker side only
after the spec lands, which is the same slack gRPC accepts).
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Iterator, Optional


class Deadline:
    """An absolute monotonic deadline with remaining-budget arithmetic."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @classmethod
    def after(cls, timeout_s: Optional[float]) -> Optional["Deadline"]:
        if timeout_s is None:
            return None
        return cls(time.monotonic() + max(0.0, timeout_s))

    def remaining(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "ray_tpu_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _current_deadline.get()


def remaining() -> Optional[float]:
    """Seconds left in the ambient deadline, or None if none is set."""
    d = _current_deadline.get()
    return None if d is None else d.remaining()


def effective_timeout(timeout_s: Optional[float]) -> Optional[float]:
    """Clamp an explicit timeout by the ambient deadline: the tighter of
    the two wins; ``None`` defers entirely to the ambient budget (and
    stays None when there is none). An exhausted budget returns 0.0 —
    callers' timeout machinery turns that into an immediate timeout
    instead of a hang."""
    d = _current_deadline.get()
    if d is None:
        return timeout_s
    left = max(0.0, d.remaining())
    if timeout_s is None:
        return left
    return min(timeout_s, left)


@contextmanager
def deadline_scope(timeout_s: Optional[float]) -> Iterator[Optional[Deadline]]:
    """Enter a deadline of ``timeout_s`` seconds (no-op for None). Nested
    scopes never EXTEND the ambient budget — the effective deadline is
    the tighter of the new and inherited ones, so an inner
    ``deadline_scope(300)`` cannot escape an outer 10s budget."""
    new = Deadline.after(timeout_s)
    inherited = _current_deadline.get()
    if new is None or (inherited is not None and inherited.at <= new.at):
        new = inherited
    token = _current_deadline.set(new)
    try:
        yield new
    finally:
        _current_deadline.reset(token)
