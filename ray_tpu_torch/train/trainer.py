"""TorchTrainer: the data-parallel trainer driving a GPU worker gang (port
of ``ray_tpu.train.trainer``'s ``JaxTrainer``, named after Ray's
``ray.train.torch.TorchTrainer``).

Reference shape: ``train/data_parallel_trainer.py:428`` (training_loop) +
``train/_internal/backend_executor.py:68,135,451``:
  * the worker gang is one process per GPU, gang-reserved via a placement
    group;
  * backend bootstrap is ``torch.distributed.init_process_group``
    (TorchBackend) — gradient reduction happens inside the user's step
    (DTensor collectives over NCCL), the control plane only carries
    metrics/checkpoints;
  * results flow by polling worker queues; failures restart the whole gang
    from the latest checkpoint (``FailureConfig.max_failures``), matching
    the reference's stop-the-world recovery semantics.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchBackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclass
class Result:
    """Reference: ``ray.train.Result``."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[BaseException] = None
    metrics_history: list = field(default_factory=list)


class TrainingFailedError(RuntimeError):
    pass


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend_config: Optional[BackendConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._train_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or TorchBackendConfig()
        self.datasets = datasets or {}
        self._resume_checkpoint = resume_from_checkpoint

    # -- paths -----------------------------------------------------------
    def _run_dir(self) -> str:
        base = self.run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results"
        )
        name = self.run_config.name or f"TorchTrainer_{int(time.time())}"
        return os.path.join(base, name)

    # -- main ------------------------------------------------------------
    def fit(self) -> Result:
        run_dir = self._run_dir()
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager.restore(
            run_dir,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        max_failures = self.run_config.failure_config.max_failures
        failures = 0
        last_error: Optional[BaseException] = None
        resume = self._resume_checkpoint or manager.latest()
        while True:
            try:
                result = self._run_attempt(manager, run_dir, resume)
                result.path = run_dir
                return result
            except TrainingFailedError as e:
                failures += 1
                last_error = e
                if max_failures >= 0 and failures > max_failures:
                    result = Result(
                        metrics={}, checkpoint=manager.latest(), path=run_dir, error=e
                    )
                    raise TrainingFailedError(
                        f"training failed after {failures} attempt(s): {e}"
                    ) from e
                logger.warning(
                    "training attempt failed (%d/%d): %s — restarting from "
                    "latest checkpoint", failures, max_failures, e,
                )
                resume = manager.latest()

    def _run_attempt(
        self,
        manager: CheckpointManager,
        run_dir: str,
        resume: Optional[Checkpoint],
    ) -> Result:
        # Reap orphaned session-staged checkpoint copies from prior failed
        # attempts — queued reports that never drained leave their _staged
        # dirs behind, and nothing else ever deletes them.
        staged_root = os.path.join(run_dir, "_staged")
        if os.path.isdir(staged_root):
            import shutil

            shutil.rmtree(staged_root, ignore_errors=True)
        scaling = self.scaling_config
        n = scaling.resolved_num_workers()
        backend: Backend = self.backend_config.backend_cls()()
        group: Optional[WorkerGroup] = None
        try:
            try:
                group = WorkerGroup(n, scaling.bundles(), scaling.pg_strategy())
                backend.on_start(group, self.backend_config)
            except Exception as e:  # noqa: BLE001
                raise TrainingFailedError(f"worker group start failed: {e!r}") from e
            setup_fn = getattr(backend, "setup_fn", lambda: None)()
            name = self.run_config.name or os.path.basename(run_dir)
            # unified parallelism plan (TorchBackendConfig.mesh_spec/
            # sharding): declared ONCE on the trainer, delivered to every
            # rank via context metadata so train.get_mesh()/
            # get_sharding_rules() hand all workers the identical plan
            shared_meta: Dict[str, Any] = {"datasets": list(self.datasets)}
            mesh_spec = getattr(self.backend_config, "mesh_spec", None)
            if mesh_spec is not None:
                from dataclasses import asdict

                shared_meta["mesh_spec"] = asdict(mesh_spec)
            sharding = getattr(self.backend_config, "sharding", None)
            if sharding is not None:
                shared_meta["sharding_rules"] = sharding
            contexts = [
                TrainContext(
                    world_size=n,
                    world_rank=rank,
                    local_rank=0,
                    node_rank=rank,
                    experiment_name=name,
                    trial_dir=run_dir,
                    checkpoint=resume,
                    metadata=dict(shared_meta),
                )
                for rank in range(n)
            ]
            # dataset shards: each worker rank gets an iterator over its split
            shard_args: Dict[int, Dict[str, Any]] = {rank: {} for rank in range(n)}
            for ds_name, ds in self.datasets.items():
                try:
                    splits = ds.streaming_split(n)
                except AttributeError:
                    splits = [ds] * n
                for rank in range(n):
                    shard_args[rank][ds_name] = splits[rank]
            for rank in range(n):
                contexts[rank].metadata["dataset_shards"] = shard_args[rank]
            try:
                import ray_tpu_torch

                ray_tpu_torch.get(
                    [
                        group.workers[rank].start_training.remote(
                            self._train_fn, self._train_config, contexts[rank], setup_fn
                        )
                        for rank in range(n)
                    ],
                    timeout=120,
                )
            except Exception as e:  # noqa: BLE001
                raise TrainingFailedError(f"start_training failed: {e!r}") from e
            return self._poll_loop(group, manager)
        finally:
            try:
                backend.on_shutdown(group, self.backend_config)
            except Exception:
                pass
            if group is not None:
                group.shutdown()

    def _poll_loop(self, group: WorkerGroup, manager: CheckpointManager) -> Result:
        """Drain worker report queues until every rank finishes.

        Reference: ``backend_executor.get_next_results`` — rank 0's metrics
        win; any rank may attach the checkpoint (TPU SPMD: rank 0 saves).

        Preemption awareness: subscribes to controller node-state pushes
        for the run's duration; a node entering DRAINING triggers an
        urgent-checkpoint request on every rank (SPMD: rank 0 saves), so
        a preempted run loses at most steps-since-warning, not
        steps-since-the-last periodic checkpoint."""
        import threading

        drained_nodes: set = set()
        drain_lock = threading.Lock()
        drain_seen = threading.Event()

        def _on_node_event(msg: Dict[str, Any]) -> None:
            if msg.get("state") == "DRAINING" and msg.get("node_id") is not None:
                with drain_lock:
                    drained_nodes.add(msg["node_id"])
                drain_seen.set()

        listener_backend = None
        try:
            from ray_tpu_torch.core.api import _global_worker

            listener_backend = _global_worker().backend
            listener_backend.add_node_event_listener(_on_node_event)
        except Exception:
            listener_backend = None  # local mode: no node events
        try:
            return self._poll_loop_inner(
                group, manager, drain_seen, drained_nodes, drain_lock,
                listener_backend,
            )
        finally:
            if listener_backend is not None:
                try:
                    listener_backend.remove_node_event_listener(_on_node_event)
                except Exception:
                    pass

    @staticmethod
    def _gang_node_ids(backend, group: WorkerGroup) -> set:
        """Node ids currently hosting the gang's workers (actor table)."""
        out = set()
        for w in group.workers:
            try:
                info = backend.io.run(
                    backend.controller.call(
                        "get_actor_info", {"actor_id": w.actor_id}
                    ),
                    timeout=5,
                )
                nid = getattr((info or {}).get("address"), "node_id", None)
                if nid is not None:
                    out.add(nid)
            except Exception:
                pass
        return out

    def _poll_loop_inner(
        self,
        group: WorkerGroup,
        manager: CheckpointManager,
        drain_seen,
        drained_nodes: set,
        drain_lock,
        listener_backend,
    ) -> Result:
        last_metrics: Dict[str, Any] = {}
        history = []
        done = [False] * group.num_workers
        while not all(done):
            if drain_seen.is_set():
                drain_seen.clear()
                with drain_lock:
                    pending = set(drained_nodes)
                    drained_nodes.clear()
                # only a drain of a node HOSTING this gang warrants the
                # checkpoint I/O — unrelated nodes (serve/data capacity)
                # drain without interrupting training
                gang_nodes = (
                    self._gang_node_ids(listener_backend, group)
                    if listener_backend is not None
                    else set()
                )
                if pending & gang_nodes:
                    # fire-and-forget: a rank already dying must not
                    # stall the warning to the survivors (SPMD: every
                    # rank flips its flag, rank 0 saves)
                    for w in group.workers:
                        try:
                            w.request_urgent_checkpoint.remote()
                        except Exception:
                            pass
                    logger.warning(
                        "drain of a gang-hosting node detected — requested "
                        "urgent checkpoint from all ranks"
                    )
            try:
                polls = group.execute("poll_results", timeout=60)
            except Exception as e:  # noqa: BLE001
                raise TrainingFailedError(f"worker poll failed: {e!r}") from e
            # pair up reports across ranks by arrival batch; rank 0 wins.
            # Reports are processed BEFORE any error is raised: a crashing
            # worker may have queued its final checkpoint, which the restart
            # needs.
            errors = []
            errors_drained = True
            for rank, poll in enumerate(polls):
                if poll["error"] is not None:
                    errors.append(poll["error"])
                    if poll["reports"]:
                        errors_drained = False
                for report in poll["reports"]:
                    ckpt = report.get("checkpoint")
                    if rank == 0:
                        last_metrics = report["metrics"]
                        history.append(report["metrics"])
                    if ckpt is not None:
                        final = manager.register(
                            ckpt, report["metrics"] if rank == 0 else {}
                        )
                        if rank == 0:
                            last_metrics["_checkpoint_path"] = final.path
                # A finished rank may still hold >drain-cap queued reports
                # (poll drains at most 64 at a time) — only count it done
                # once its queue comes back empty, so the final checkpoint
                # is never dropped.
                done[rank] = poll["done"] and not poll["reports"]
            if errors and errors_drained:
                # Raise once every *erroring* rank's queue came back empty:
                # a crashing worker may have >drain-cap reports queued with
                # its final checkpoint in the tail, which the restart needs.
                # Healthy ranks still streaming reports must not defer the
                # gang restart indefinitely.
                raise TrainingFailedError(str(pickle.loads(errors[0])))
            if not all(done):
                time.sleep(0.05)
        group.execute("finish", timeout=30)
        return Result(
            metrics=last_metrics,
            checkpoint=manager.latest(),
            metrics_history=history,
        )
