"""Serve configuration dataclasses.

Reference: ``serve/config.py`` + ``serve/schema.py`` (DeploymentConfig,
autoscaling config). TPU note: replicas may reserve ``{"TPU": n}`` so a
deployment maps onto chips exactly like any other actor."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-length autoscaling (reference ``autoscaling_state.py:262``,
    ``serve/autoscaling_policy.py:100``): scale toward
    total_ongoing / target_ongoing_requests replicas.

    SLO autopilot mode: when ``target_ttft_p99_s`` is set the controller
    scales on TTFT-p99 BUDGET BURN (worst fresh replica's windowed p99
    divided by the target) instead of raw queue depth — burn at or above
    ``ttft_burn_high`` forces a scale-out, burn at or below
    ``ttft_burn_low`` releases capacity down to the queue-derived floor,
    and the band between them HOLDS the current target so a chaos blip
    (one replica kill inflating p99 for a window) doesn't thrash
    replicas. See ``serve/controller.py::autoscale_decision``."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    #: TTFT p99 budget (seconds); None = legacy queue-depth autoscaling
    target_ttft_p99_s: Optional[float] = None
    #: burn ratio (measured p99 / target) at/above which to scale OUT
    ttft_burn_high: float = 1.0
    #: burn ratio at/below which scale-IN is allowed; the gap between
    #: low and high is the hysteresis dead band (hold the target)
    ttft_burn_low: float = 0.5


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling: Optional[AutoscalingConfig] = None
    route_prefix: Optional[str] = None
    #: rolling updates key on this (reference deployment_state.py:2331):
    #: redeploying the SAME version is an in-place config update;
    #: a different (or absent) version rolls replicas start-before-kill
    version: Optional[str] = None
    #: disaggregated prefill/decode serving: name of the PREFILL-pool
    #: deployment paired with this (decode) deployment. Routers read it
    #: through ``deployment_meta`` and run the two-stage dispatch —
    #: prefill_export on the prefill pool, then the stream on this pool
    #: with the KV descriptor attached (inference/serve_llm.py).
    disagg_prefill: Optional[str] = None
