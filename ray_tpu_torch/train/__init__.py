"""ray_tpu_torch.train — distributed training orchestration on GPUs (port of
``ray_tpu.train``).

Reference: ``python/ray/train`` (Trainer/BackendExecutor/WorkerGroup/
session — see trainer.py docstring for the mapping). The entry point is
``TorchTrainer``; sharding *inside* the training step lives in
``ray_tpu_torch.parallel`` (DeviceMesh and DTensor placements) and the
kernels in ``ray_tpu_torch.ops`` — the trainer orchestrates processes,
``torch.distributed`` moves bytes.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchBackend, TorchBackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_mesh,
    get_sharding_rules,
    report,
    urgent_checkpoint_requested,
)
from ray_tpu_torch.train.trainer import TorchTrainer, Result, TrainingFailedError
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup

__all__ = [
    "Backend",
    "BackendConfig",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "FailureConfig",
    "TorchBackend",
    "TorchBackendConfig",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "TrainingFailedError",
    "TrainWorker",
    "WorkerGroup",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_mesh",
    "get_sharding_rules",
    "report",
    "urgent_checkpoint_requested",
]
