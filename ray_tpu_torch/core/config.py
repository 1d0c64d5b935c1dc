"""Typed runtime configuration flags (port of ``ray_tpu.core.config``).

Only the flags the port's serving path reads, with the reference's
defaults. Each is overridable per process through a ``RAY_TPU_<name>``
environment variable, as in the reference; flags are plain attributes on
the singleton ``GLOBAL_CONFIG`` so hot paths read them without dict
lookups.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Any

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class GlobalConfig:
    # --- observability ---
    #: serve a Prometheus /metrics endpoint (LLMServer starts its own)
    metrics_export_enabled: bool = True
    #: bind address for /metrics ("0.0.0.0" for off-host Prometheus)
    metrics_bind_host: str = "127.0.0.1"
    #: distributed-tracing sample rate in [0, 1]: a fresh trace root is
    #: sampled at request entry points with this probability; children
    #: inherit the verdict causally. 0 keeps the hot path span-free.
    trace_sample_rate: float = 0.0

    # --- SLO ledger (observability/slo.py) ---
    #: flight-recorder slowest-K slots per process (0 keeps only flagged)
    slo_flight_recorder_slots: int = 32
    #: flight-recorder ring capacity for FLAGGED requests — newest win
    slo_flight_flagged_slots: int = 128
    #: TTFT above this flags a request into the flight recorder
    slo_ttft_slow_s: float = 2.0
    #: max inter-token gap above this flags a request (ITL SLO target)
    slo_itl_slow_s: float = 1.0

    # --- drain ---
    #: how long a draining engine lets in-flight requests finish
    drain_grace_s: float = 30.0

    # --- testing / chaos ---
    #: seeded REPLICA fault plan consulted by the LLM engine's step loop
    #: once per executed step phase: "mode:prob[:param][:max],..." with
    #: mode in {kill_mid_decode, kill_mid_prefill, stall} — see
    #: util/chaos.py::ReplicaFaultPlan. Empty = no injection.
    testing_replica_chaos: str = ""
    #: RNG seed for the replica fault plan; 0 = generate one (logged at
    #: activation for replay)
    testing_replica_chaos_seed: int = 0
    #: MASTER chaos seed: when non-zero, a fault plan whose own seed knob
    #: is 0 derives its seed from this one value
    #: (util/chaos.py::derive_plan_seed). Explicit per-plan seeds win.
    testing_chaos_seed: int = 0

    def apply_env(self) -> None:
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name)
            if env is None:
                continue
            setattr(self, f.name, _parse(env, f.type))


def _parse(raw: str, typ: Any) -> Any:
    typ = str(typ)
    if "bool" in typ:
        return raw.lower() in ("1", "true", "yes", "on")
    if "int" in typ:
        return int(raw)
    if "float" in typ:
        return float(raw)
    return raw


GLOBAL_CONFIG = GlobalConfig()
GLOBAL_CONFIG.apply_env()
