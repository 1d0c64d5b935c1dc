"""Seeded replica fault plans (port of the replica part of
``ray_tpu.util.chaos``).

Only what the engine's replica chaos reads: ``derive_plan_seed``,
``SeededPlanCache`` (the process-wide lazy plan behind
``engine.active_replica_fault_plan``, reading the port's
``GLOBAL_CONFIG``), ``REPLICA_FAULT_MODES`` and ``ReplicaFaultPlan``. The
worker and node killers, the RPC, pull, KV-tier and controller plans wait
for the runtime and the KV tier (ROADMAP Queue A).
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
from typing import List, Optional, Tuple


def derive_plan_seed(master_seed: int, label: str) -> int:
    """Per-plan seed derived from the MASTER chaos seed
    (``RAY_TPU_testing_chaos_seed``): keyed blake2b of the plan label so
    the three plans (rpc / pull / replica) get distinct but fully
    deterministic streams from one logged number. Forced odd (never 0 —
    0 means "generate" in the config grammar)."""
    digest = hashlib.blake2b(
        f"{int(master_seed)}:{label}".encode(), digest_size=4
    ).digest()
    return int.from_bytes(digest, "little") | 1


class SeededPlanCache:
    """Process-wide lazy singleton for one env/config-driven seeded
    fault plan (the shared shape behind ``rpc.active_fault_plan``,
    ``pull_manager.active_pull_fault_plan`` and
    ``engine.active_replica_fault_plan``): built once per (spec, seed)
    config value, rebuilt when either changes, seed generated-and-LOGGED
    at activation so any failure reproduces from the log alone."""

    def __init__(self, plan_cls, label: str, spec_attr: str, seed_attr: str, logger):
        self._plan_cls = plan_cls
        self._label = label
        self._spec_attr = spec_attr
        self._seed_attr = seed_attr
        self._logger = logger
        self._lock = threading.Lock()
        self._key: Optional[Tuple[str, int, int]] = None
        self._plan = None

    def active(self):
        """The current plan, or None when the spec knob is empty."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        spec = getattr(GLOBAL_CONFIG, self._spec_attr)
        if not spec:
            return None
        master = int(getattr(GLOBAL_CONFIG, "testing_chaos_seed", 0) or 0)
        key = (spec, getattr(GLOBAL_CONFIG, self._seed_attr), master)
        if self._key == key:
            return self._plan
        with self._lock:
            if self._key == key:
                return self._plan
            # explicit per-plan seed > master-derived > generated: an
            # armed master seed makes the whole composite chaos run
            # reproduce from ONE logged number
            if key[1]:
                seed, origin = key[1], ""
            elif master:
                seed = derive_plan_seed(master, self._label)
                origin = f" [derived from RAY_TPU_testing_chaos_seed={master}]"
            else:
                seed = int.from_bytes(os.urandom(4), "little") | 1
                origin = ""
            plan = self._plan_cls(spec, seed)
            self._logger.warning(
                "%s chaos plan ACTIVE: spec=%r seed=%d "
                "(reproduce: RAY_TPU_%s=%r RAY_TPU_%s=%d)%s",
                self._label, spec, seed,
                self._spec_attr, spec, self._seed_attr, seed, origin,
            )
            self._plan, self._key = plan, key
            return plan


#: Replica/engine chaos fault modes (consulted by the LLM engine's step
#: loop once per executed step phase — see ``inference/engine.py``).
#: kill_mid_decode — SIGKILL the replica process right before a planned
#:   decode batch runs: the last emitted token reached (or is in flight
#:   to) the owner, the next one never samples — the exact boundary the
#:   router's seq-numbered resume protocol exists for.
#: kill_mid_prefill — SIGKILL before a planned prefill chunk runs
#:   (exercises resume before/while the first token is produced).
#: kill_mid_export — SIGKILL while a prefill replica is gathering a
#:   request's KV blocks for migration (disaggregated serving): the
#:   exported segment never publishes, the router's handoff dispatch
#:   fails, and the request must degrade to plain generation.
#: kill_mid_import — SIGKILL while a decode replica is scattering
#:   migrated KV into its cache: the stream dies before its first token
#:   and the resumable-stream machinery replays it (without the
#:   descriptor) on a survivor.
#: stall — the step loop sleeps ``param`` seconds mid-step: the actor's
#:   async loop keeps answering RPCs while the engine wedges, which is
#:   exactly what the serve controller's health poll (not liveness
#:   checks) must catch and restart.
REPLICA_FAULT_MODES = (
    "kill_mid_decode",
    "kill_mid_prefill",
    "kill_mid_export",
    "kill_mid_import",
    "stall",
)


class ReplicaFaultPlan:
    """Seeded replica-death fault plan for LLM serving
    (``RAY_TPU_testing_replica_chaos``).

    Spec grammar::

        "<mode>:<prob>[:<param>][:<max>][, ...]"

    e.g. ``"kill_mid_decode:1.0:8"`` (deterministically kill on the 9th
    decode-phase consult) or ``"stall:0.2:5.0:1"``. Fields:

    * ``param`` — for ``stall``: seconds to sleep (default 1.0); for the
      kill modes: number of matching-phase consults to SKIP before the
      rule becomes eligible (default 0) — what lets a test land the kill
      mid-stream instead of on the first token.
    * ``max`` — injection cap per process (default 1). The plan is
      usually installed via env/system-config, so EVERY replica —
      including every controller-spawned replacement — runs the same
      schedule; an uncapped stall rule would wedge each incarnation
      forever and the deployment would never converge. (A kill ends the
      process anyway; the cap matters for ``stall``.)

    Consults happen once per engine-step phase that has work: the engine
    calls ``consult("prefill")`` when the step runs prefill chunks and
    ``consult("decode")`` when it runs a decode batch.

    DETERMINISM CONTRACT (same as :class:`RpcFaultPlan`): exactly one
    RNG draw per consult, whether or not any rule matches — the full
    injection schedule is a pure function of (seed, the ordered sequence
    of consulted phases). A failure log carrying the seed plus the spec
    reproduces the exact fault schedule.
    """

    def __init__(self, spec: str, seed: int):
        self.spec = spec
        self.seed = seed
        #: [mode, prob, param, max_injections]
        self.rules: List[List[float]] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(
                    f"bad replica chaos rule {part!r} (need mode:prob)"
                )
            mode, prob = fields[0], float(fields[1])
            if mode not in REPLICA_FAULT_MODES:
                raise ValueError(
                    f"unknown replica chaos mode {mode!r} "
                    f"(one of {REPLICA_FAULT_MODES})"
                )
            param = float(fields[2]) if len(fields) > 2 else (
                1.0 if mode == "stall" else 0.0
            )
            cap = int(fields[3]) if len(fields) > 3 else 1
            self.rules.append([mode, prob, param, cap])
        self._rng = random.Random(seed)
        self.consults = 0
        self.injections = 0
        #: matching-phase consults seen per rule (the kill-mode skip
        #: window counts these, not global consults)
        self._phase_consults = [0] * len(self.rules)
        self._injected = [0] * len(self.rules)

    @staticmethod
    def _matches(mode: str, phase: str) -> bool:
        if mode == "stall":
            return True
        return mode == f"kill_mid_{phase}"

    def consult(self, phase: str) -> Optional[Tuple[str, float]]:
        """One deterministic consult for an engine-step phase
        (``"prefill"`` | ``"decode"``): ``(mode, param)`` to inject,
        else None. Exactly one RNG draw regardless of outcome."""
        draw = self._rng.random()  # ALWAYS one draw (see class docstring)
        self.consults += 1
        for i, (mode, prob, param, cap) in enumerate(self.rules):
            if not self._matches(mode, phase):
                continue
            self._phase_consults[i] += 1
            if mode != "stall" and self._phase_consults[i] <= param:
                return None  # inside the skip window
            if self._injected[i] >= cap:
                return None
            if draw < prob:
                self._injected[i] += 1
                self.injections += 1
                return (mode, param)
            return None  # first matching rule owns the draw
        return None
