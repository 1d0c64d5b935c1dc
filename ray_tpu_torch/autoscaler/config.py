"""Autoscaler configuration.

Reference: the ``available_node_types`` section of the cluster YAML
(``python/ray/autoscaler/ray-schema.json``) reduced to what scaling
decisions actually consume: per-type resources, instance bounds, and the
slice size for TPU pod types."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class NodeTypeConfig:
    name: str
    #: resources ONE host of this type advertises (e.g. {"CPU": 8} or
    #: {"CPU": 8, "TPU": 4})
    resources: Dict[str, float]
    max_workers: int = 4
    min_workers: int = 0
    #: hosts launched atomically per node of this type (TPU slice size in
    #: hosts; 1 for plain CPU/GPU boxes)
    hosts: int = 1


@dataclass
class AutoscalerConfig:
    node_types: List[NodeTypeConfig] = field(default_factory=list)
    #: terminate a provider node after this long at zero utilization
    idle_timeout_s: float = 30.0
    #: reconcile interval
    update_interval_s: float = 1.0
    #: cluster-wide cap on provider-launched nodes
    max_workers: int = 8
    #: how long a launched node gets credited as booting supply before
    #: it's treated as failed (stops double-launching during boot
    #: without trusting a hung/dead launch forever)
    boot_grace_s: float = 120.0
