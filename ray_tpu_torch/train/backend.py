"""Training backends: per-framework worker-group setup hooks (port of
``ray_tpu.train.backend``).

Reference: ``train/_internal/backend_executor.py`` Backend plugin protocol
+ ``train/torch/config.py:66-116`` (the NCCL/gloo rendezvous). The JAX
package's backend runs ``jax.distributed.initialize``; the port's runs
``torch.distributed.init_process_group``: rank 0 publishes its host and a
free port as ``MASTER_ADDR``/``MASTER_PORT``, and every worker joins the
group before its training loop starts, so ``train.get_mesh()`` builds one
DeviceMesh over the gang.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclass
class BackendConfig:
    """Base; subclasses pick the backend class."""

    def backend_cls(self):
        return Backend


class Backend:
    """Hooks around the worker group lifecycle."""

    def on_start(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass


@dataclass
class TorchBackendConfig(BackendConfig):
    """``torch.distributed`` bootstrap config (Ray's ``TorchConfig``).

    distributed=None → auto: every gang joins a process group, one worker
    included (as Ray's TorchTrainer), so the step's mesh and collectives
    are the same at any size. False skips the rendezvous.
    platform: ``"cpu"`` runs the group on gloo (workers without a GPU);
    otherwise it runs on nccl, on each worker's GPU. There is no fallback
    from one to the other: nccl without a GPU fails the start.

    mesh_spec/sharding: the gang's unified parallelism plan. When set,
    every worker can call ``train.get_mesh()`` /
    ``train.get_sharding_rules()`` after the rendezvous and receive the
    SAME mesh (over all gang ranks; ``-1`` axes resolve against the world
    size) and the same canonical rules table ("ddp" | "fsdp" | "tp"), the
    one named-sharding source of truth the constrained train step
    (``models/llama.py::make_train_step``) derives every param, grad and
    optimizer-state placement from."""

    distributed: Optional[bool] = None
    platform: Optional[str] = None
    extra_env: Optional[Dict[str, str]] = None
    mesh_spec: Optional[MeshSpec] = None
    sharding: Optional[str] = None  # "ddp" | "fsdp" | "tp"

    def backend_cls(self):
        return TorchBackend


def _torch_distributed_init(backend: str, context) -> None:
    """Runs inside each worker, before the user loop (setup_fn): joins the
    gang's process group at ``MASTER_ADDR:MASTER_PORT`` (rank 0's), after
    leaving any group an earlier run left in this process."""
    import os

    if not os.environ.get("MASTER_ADDR"):
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if backend == "nccl":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a GPU in every worker: set "
                               "TorchBackendConfig(platform='cpu') to train on the CPU")
        torch.cuda.set_device(0)  # the worker's one visible GPU
    dist.init_process_group(
        backend, init_method="env://", world_size=context.world_size, rank=context.world_rank
    )


def _torch_distributed_shutdown() -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class TorchBackend(Backend):
    _distributed = False

    def on_start(self, worker_group: WorkerGroup, backend_config: TorchBackendConfig) -> None:
        self._distributed = backend_config.distributed is not False
        env: Dict[str, str] = dict(backend_config.extra_env or {})
        if self._distributed:
            # rank 0's host + a free port (reference
            # train/torch/config.py:66-116)
            addr = worker_group.execute_single(0, "get_address", timeout=30)
            env["MASTER_ADDR"] = addr["host"]
            env["MASTER_PORT"] = str(addr["free_port"])
        if env:
            worker_group.execute("set_env", env, timeout=30)
        self._setup = functools.partial(
            _torch_distributed_init, "gloo" if backend_config.platform == "cpu" else "nccl"
        )

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: TorchBackendConfig) -> None:
        if worker_group is not None and worker_group.workers and self._distributed:
            worker_group.execute("run_fn", _torch_distributed_shutdown, timeout=10)

    def setup_fn(self):
        """Per-worker pre-loop hook handed to start_training."""
        return self._setup
