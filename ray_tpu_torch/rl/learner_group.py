"""LearnerGroup: a gang of learner processes over one ``torch.distributed``
group (port of ``ray_tpu.rl.learner_group``).

Reference: ``rllib/core/learner/learner_group.py:81`` — remote Learner
actors whose module updates are synchronized with DDP all-reduce
(``torch_learner.py:576-590``). The JAX package compiles one SPMD program
over a global mesh and XLA inserts the gradient psum. Torch inserts
nothing, so the update contract carries the reduction:

* ``init_fn(device) -> state`` builds the state on the learner's device,
  the same values on every learner (same seed → replicated state);
* ``update_builder() -> update``, where ``update(state, local_batch,
  mean_grads) -> (state, stats)`` takes this learner's shard of the global
  batch (tensors on its device) and calls ``mean_grads(grads)`` between
  the backward and the optimizer step: it averages the tensors over the
  gang in place (the identity for a gang of one). The shards are equal in
  size (``LearnerGroup.update`` trims the batch to a multiple of the gang),
  so the mean of the local mean gradients is the global batch's, and an
  N-learner update equals a 1-learner update on the concatenated batch
  up to float rounding. The gang also averages the returned stats.

The learners are dedicated actors (one fresh process each) that join the
group through the port's rendezvous (``train/backend.py``'s
``_torch_distributed_init``: rank 0's host and a free port): gloo for
``platform="cpu"``, nccl on the card. ``platform`` defaults to the card
(the reference's to ``"cpu"``), where each learner leases one GPU
(``resources_per_learner`` defaults to ``{"GPU": 1}``) and sees it as
``cuda:0`` through the ``CUDA_VISIBLE_DEVICES`` the node daemon sets.
Params and state leave a learner as numpy snapshots.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch


class _LearnerWorker:
    """One gang member. Defined undecorated for by-reference pickling."""

    def __init__(self, rank: int, world: int, platform: Optional[str]):
        self._rank = rank
        self._world = world
        self._platform = platform
        self._device = None
        self._state = None
        self._update = None

    def get_coordinator(self) -> str:
        """Rank 0's rendezvous address: the trainer's host and a free port."""
        import socket

        from ray_tpu_torch.train.worker_group import _node_ip_address

        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        return f"{_node_ip_address()}:{port}"

    def initialize(self, coordinator: Optional[str]) -> Dict[str, Any]:
        """Resolve the device (raises on ``cuda`` without a card) and join
        the gang's group; returns what this learner sees."""
        import os
        import types

        import torch

        from ray_tpu_torch.models.llama import resolve_device
        from ray_tpu_torch.train.backend import _torch_distributed_init

        self._device = resolve_device(self._platform)
        if self._device.type == "cuda":
            torch.cuda.set_device(0)  # the learner's one visible GPU
        if self._world > 1:
            os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = coordinator.rsplit(":", 1)
            _torch_distributed_init(
                "gloo" if self._device.type == "cpu" else "nccl",
                types.SimpleNamespace(world_size=self._world, world_rank=self._rank),
            )
        return {
            "rank": self._rank,
            "device": str(self._device),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": (torch.cuda.get_device_name(0)
                            if self._device.type == "cuda" else None),
        }

    def _mean(self, tensors) -> None:
        """Average ``tensors`` over the gang, in place."""
        import torch.distributed as dist

        if self._world == 1:
            return
        for t in tensors:
            dist.all_reduce(t)
            t.div_(self._world)

    def build(self, init_fn_b: bytes, update_builder_b: bytes) -> bool:
        init_fn = cloudpickle.loads(init_fn_b)
        self._update = cloudpickle.loads(update_builder_b)()
        self._state = init_fn(self._device)
        return True

    def update(self, local_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One gang update: every learner must call this with its shard of
        the same global batch (the gradient all-reduce synchronizes the
        gang)."""
        import torch

        # copies: an array from the object store is read-only
        batch = {k: torch.from_numpy(np.array(v)).to(self._device)
                 for k, v in local_batch.items()}
        self._state, stats = self._update(self._state, batch, self._mean)
        names = sorted(stats)
        values = torch.stack([torch.as_tensor(stats[k], dtype=torch.float32,
                                              device=self._device) for k in names])
        self._mean([values])
        return dict(zip(names, values.tolist()))

    def get_params(self):
        """Weight-broadcast payload: params only (opt state stays put)."""
        from ray_tpu_torch.rl.models import to_host

        return to_host(self._state[0])

    def get_state(self):
        from ray_tpu_torch.rl.utils import state_to_host

        return state_to_host(self._state)

    def set_state(self, state) -> None:
        from ray_tpu_torch.rl.utils import load_state_

        load_state_(self._state, state)

    def shutdown(self) -> bool:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return True


LearnerWorker = ray_tpu_torch.remote(_LearnerWorker)


class LearnerGroup:
    """The caller's handle on the learner gang."""

    def __init__(
        self,
        *,
        num_learners: int,
        init_fn: Callable[[Any], Any],
        update_builder: Callable[[], Callable],
        platform: Optional[str] = None,
        resources_per_learner: Optional[Dict[str, float]] = None,
    ):
        self.num_learners = max(1, num_learners)
        if resources_per_learner is None:
            resources_per_learner = {} if platform == "cpu" else {"GPU": 1}
        res = dict(resources_per_learner)
        num_cpus = res.pop("CPU", 1.0)
        self._learners = [
            LearnerWorker.options(num_cpus=num_cpus, resources=res or None).remote(
                rank, self.num_learners, platform
            )
            for rank in range(self.num_learners)
        ]
        coordinator = None
        if self.num_learners > 1:
            coordinator = ray_tpu_torch.get(
                self._learners[0].get_coordinator.remote(), timeout=120
            )
        # initialize CONCURRENTLY: the group's rendezvous blocks until the
        # whole gang arrives
        self.learner_info = ray_tpu_torch.get(
            [l.initialize.remote(coordinator) for l in self._learners],
            timeout=300,
        )
        init_b = cloudpickle.dumps(init_fn)
        upd_b = cloudpickle.dumps(update_builder)
        ray_tpu_torch.get(
            [l.build.remote(init_b, upd_b) for l in self._learners], timeout=300
        )

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Shard ``batch`` on its leading axis and run one gang update.
        The leading dimension is trimmed to a multiple of the gang size
        (every learner's shard has the same shape)."""
        n = self.num_learners
        first = next(iter(batch.values()))
        usable = (len(first) // n) * n
        if usable == 0:
            raise ValueError(
                f"batch of {len(first)} rows cannot feed {n} learners"
            )
        refs = []
        for i in range(n):
            shard = {k: v[i * usable // n : (i + 1) * usable // n] for k, v in batch.items()}
            refs.append(self._learners[i].update.remote(shard))
        stats = ray_tpu_torch.get(refs, timeout=600)
        return stats[0]

    def get_state(self):
        return ray_tpu_torch.get(self._learners[0].get_state.remote(), timeout=120)

    def get_params(self):
        """Params only — the per-fragment weight broadcast must not drag
        optimizer moments (~3x the bytes) across the wire."""
        return ray_tpu_torch.get(self._learners[0].get_params.remote(), timeout=120)

    def set_state(self, state) -> None:
        ray_tpu_torch.get(
            [l.set_state.remote(state) for l in self._learners], timeout=120
        )

    def shutdown(self) -> None:
        for l in self._learners:
            try:
                ray_tpu_torch.get(l.shutdown.remote(), timeout=30)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(l)
            except Exception:
                pass
        self._learners = []
