"""Train configuration dataclasses (port of ``ray_tpu.train.config``).

Reference: ``python/ray/air/config.py`` (`ScalingConfig`, `RunConfig`,
`FailureConfig`, `CheckpointConfig`). The JAX package's ``use_tpu`` +
``topology`` become Ray's ``use_gpu``: one GPU per worker.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


def _topology_error(topology: str) -> ValueError:
    return ValueError(
        f"topology={topology!r} names a TPU pod slice; the port places one worker "
        "per GPU: set num_workers (and use_gpu)"
    )


@dataclass
class ScalingConfig:
    """How many training workers, and what each one holds.

    Reference: ``air/config.py`` ScalingConfig (num_workers, use_gpu,
    resources_per_worker, placement_strategy). ``use_gpu`` gives each
    worker one GPU (the default: training runs on the card unless the
    caller asks for the CPU); ``topology`` is the JAX package's TPU
    pod-slice type and raises here.
    """

    num_workers: int = 1
    use_gpu: bool = True
    #: a TPU pod-slice type in the JAX package; raises in the port
    topology: Optional[str] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        if self.topology:
            raise _topology_error(self.topology)
        if self.resources_per_worker is not None:
            res = dict(self.resources_per_worker)
        elif self.use_gpu:
            res = {"CPU": 1.0, "GPU": 1.0}
        else:
            res = {"CPU": 1.0}
        return res

    def resolved_num_workers(self) -> int:
        if self.topology:
            raise _topology_error(self.topology)
        return self.num_workers

    def bundles(self) -> List[Dict[str, float]]:
        per_worker = self.worker_resources()
        n = self.resolved_num_workers()
        return [dict(per_worker) for _ in range(n)]

    def pg_strategy(self) -> str:
        # One worker per host for real slices; tests pack on one machine.
        if self.topology:
            return "STRICT_SPREAD"
        return self.placement_strategy


@dataclass
class FailureConfig:
    """Reference: ``air/config.py:394-408`` — how many times fit() may
    restart the worker group from the latest checkpoint."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: ``air/config.py`` CheckpointConfig (num_to_keep etc.)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    #: LoggerCallback instances (reference ``RunConfig.callbacks`` —
    #: CSV/JSON/TensorBoard in ``ray_tpu_torch.tune.loggers``)
    callbacks: list = field(default_factory=list)
