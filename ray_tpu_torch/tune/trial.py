"""Trial state + the trial-runner actor.

Reference: ``tune/experiment/trial.py:248`` (Trial FSM) and the
function-trainable session (``tune/trainable/function_trainable.py``):
the user function runs in a thread inside a per-trial actor, streaming
``tune.report(...)`` metrics through a buffered queue the controller
polls."""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"  # ran to completion
STOPPED = "STOPPED"  # early-stopped by the scheduler
ERRORED = "ERRORED"


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    last_metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    iterations: int = 0
    error: Optional[str] = None
    actor: Any = None
    #: latest checkpoint payload reported by the trainable (PBT exploit
    #: source + experiment-resume restore point)
    last_checkpoint: Any = None


# ---- in-trial session (set inside the trial actor process) -------------
_session_lock = threading.Lock()
_session: Optional["_TrialSession"] = None


class _TrialSession:
    def __init__(self, config: Dict[str, Any], trial_id: str = "", checkpoint: Any = None):
        self.config = config
        self.trial_id = trial_id
        self.start_checkpoint = checkpoint
        self._reports: List[Dict[str, Any]] = []
        self._checkpoints: List[Any] = []  # aligned with reports (or None)
        self._lock = threading.Lock()

    def report(self, metrics: Dict[str, Any], checkpoint: Any = None) -> None:
        with self._lock:
            self._reports.append(dict(metrics))
            self._checkpoints.append(checkpoint)

    def drain(self):
        with self._lock:
            out, self._reports = self._reports, []
            cks, self._checkpoints = self._checkpoints, []
            return out, cks


def report(metrics: Dict[str, Any] = None, *, checkpoint: Any = None, **kwargs) -> None:
    """Report trial metrics (``ray.tune.report``). Accepts a dict and/or
    keyword metrics; one report = one iteration for the scheduler.
    ``checkpoint`` is any picklable payload — it becomes the trial's
    restore point for PBT exploits and experiment resume."""
    merged = dict(metrics or {})
    merged.update(kwargs)
    with _session_lock:
        s = _session
    if s is None:
        raise RuntimeError("tune.report() called outside a trial")
    s.report(merged, checkpoint)


def get_checkpoint() -> Any:
    """The checkpoint this trial was (re)started with — None on a fresh
    start (reference ``tune.get_checkpoint``). A PBT exploit restarts the
    trial with the exploited peer's checkpoint here."""
    with _session_lock:
        s = _session
    if s is None:
        raise RuntimeError("tune.get_checkpoint() called outside a trial")
    return s.start_checkpoint


def get_config() -> Dict[str, Any]:
    with _session_lock:
        s = _session
    if s is None:
        raise RuntimeError("tune.get_config() called outside a trial")
    return s.config


def get_trial_id() -> str:
    """Unique id of the running trial (``tune.get_context().get_trial_id``
    in the reference) — e.g. for per-trial output directories."""
    with _session_lock:
        s = _session
    if s is None:
        raise RuntimeError("tune.get_trial_id() called outside a trial")
    return s.trial_id


class _TrialRunner:
    """One trial: runs the trainable function in a thread; the controller
    polls buffered reports (mirrors the Train worker session shape).

    Defined undecorated so cloudpickle exports it by module reference
    (the decorator would rebind the name to the ActorClass wrapper,
    forcing by-value pickling that drags in the module's session lock)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[_TrialSession] = None
        self._done = threading.Event()
        self._error: Optional[str] = None

    def run(self, trainable, config: Dict[str, Any], trial_id: str = "", checkpoint: Any = None) -> bool:
        global _session
        self._session = _TrialSession(config, trial_id, checkpoint)
        with _session_lock:
            _session = self._session

        def _run():
            try:
                result = trainable(config)
                # A returned dict counts as a final report (reference
                # function-trainable semantics).
                if isinstance(result, dict):
                    self._session.report(result)
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self._done.set()

        self._thread = threading.Thread(target=_run, daemon=True, name="trial")
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        done = self._done.is_set()  # snapshot BEFORE drain (see train)
        error = self._error
        reports, checkpoints = (
            self._session.drain() if self._session else ([], [])
        )
        return {
            "reports": reports,
            "checkpoints": checkpoints,
            "done": done,
            "error": error,
        }


TrialRunner = ray_tpu_torch.remote(_TrialRunner)
