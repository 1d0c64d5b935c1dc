"""Worker-side training session: context + report channel.

Reference: ``train/_internal/session.py:111,403,667`` — the per-worker
session object behind ``train.report`` / ``train.get_context``. Redesign:
the user loop runs on a plain thread inside the TrainWorker actor; each
``report(metrics, checkpoint=...)`` enqueues onto a thread-safe queue the
trainer drains via the ``poll_results`` actor method (pull, not push — the
driver controls pacing, and a dead driver can't wedge a worker).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_dir: str = ""
    #: checkpoint to resume from (set on group restart)
    checkpoint: Optional[Checkpoint] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name


class _Session:
    """One per worker process while a training run is active."""

    def __init__(self, context: TrainContext):
        self.context = context
        self.results: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self._report_seq = 0
        # preemption warning: set when the trainer learns a node hosting
        # this gang is DRAINING — the user loop checkpoints at its next
        # step boundary instead of waiting for the periodic cadence
        self.urgent_checkpoint = threading.Event()

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
        checkpoint = self._stage_checkpoint(checkpoint)
        if checkpoint is not None:
            # any checkpoint satisfies an outstanding urgent request
            self.urgent_checkpoint.clear()
        self.results.put({"metrics": dict(metrics), "checkpoint": checkpoint})

    def _stage_checkpoint(self, checkpoint: Optional[Checkpoint]) -> Optional[Checkpoint]:
        """Re-home a node-local checkpoint under the shared trial dir.

        A Checkpoint pickles as a bare path; one created in a worker's
        /tmp is unreadable from the driver on a multi-host gang. The
        trial_dir is on shared storage (the same assumption orbax makes),
        so copying there at report time makes the path valid everywhere.
        """
        trial_dir = self.context.trial_dir
        if checkpoint is None or not trial_dir:
            return checkpoint
        import os
        import shutil

        abs_path = os.path.abspath(checkpoint.path)
        if abs_path.startswith(os.path.abspath(trial_dir) + os.sep):
            return checkpoint
        dest = os.path.join(
            trial_dir,
            "_staged",
            f"rank_{self.context.world_rank:04d}_{self._report_seq:06d}",
        )
        self._report_seq += 1
        shutil.copytree(abs_path, dest, dirs_exist_ok=True)
        return Checkpoint(dest)

    def drain(self, max_items: int = 64):
        out = []
        while len(out) < max_items:
            try:
                out.append(self.results.get_nowait())
            except queue.Empty:
                break
        return out


_session: Optional[_Session] = None
_session_lock = threading.Lock()


def _start_session(context: TrainContext) -> _Session:
    global _session
    with _session_lock:
        _session = _Session(context)
        return _session


def _end_session() -> None:
    global _session
    with _session_lock:
        _session = None


def _get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "No training session active — report()/get_context() must be "
            "called inside a train_loop_per_worker"
        )
    return _session


# --- public API (``ray_tpu_torch.train.report`` etc.) --------------------------


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Reference: ``train.report`` (``_internal/session.py:667``)."""
    _get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return _get_session().context


def get_dataset_shard(name: str = "train"):
    """This rank's split of a Dataset passed to ``TorchTrainer(datasets=)``
    (reference ``ray.train.get_dataset_shard``). Returns a
    ``ray_tpu_torch.data.DataShard`` with ``iter_batches`` /
    ``iter_device_batches``, or None if no such dataset was configured."""
    ctx = get_context()
    shards = ctx.metadata.get("dataset_shards", {})
    return shards.get(name)


def get_checkpoint() -> Optional[Checkpoint]:
    """Checkpoint to resume from, if the group restarted after a failure."""
    return _get_session().context.checkpoint


def get_mesh():
    """The gang's global device mesh, built from the
    ``TorchBackendConfig.mesh_spec`` the trainer declared — every rank
    gets the SAME mesh over all gang devices (call AFTER the rendezvous,
    i.e. anywhere inside the user loop; the backend setup_fn ran
    ``torch.distributed.init_process_group`` before the loop started).
    ``-1`` axes resolve against the group's world size. Returns None when
    no mesh_spec was configured."""
    ctx = get_context()
    spec_fields = ctx.metadata.get("mesh_spec")
    if spec_fields is None:
        return None
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**spec_fields))


def get_sharding_rules():
    """The gang's canonical ``ShardingRules`` table (from
    ``TorchBackendConfig.sharding``: "ddp" | "fsdp" | "tp") — pass it with
    ``get_mesh()`` into ``models.llama.make_train_step(mesh=, rules=)``
    for the unified constrained step. None when not configured."""
    ctx = get_context()
    name = ctx.metadata.get("sharding_rules")
    if name is None:
        return None
    from ray_tpu_torch.parallel import sharding as _sh

    try:
        return {"ddp": _sh.ddp_rules, "fsdp": _sh.fsdp_rules, "tp": _sh.tp_rules}[name]()
    except KeyError:
        raise ValueError(
            f"unknown sharding rules table {name!r} (expected ddp|fsdp|tp)"
        ) from None


def urgent_checkpoint_requested() -> bool:
    """True when a preemption warning landed (a node hosting this gang is
    DRAINING): save a checkpoint with the next ``report()`` so the run
    loses at most steps-since-warning instead of steps-since-the-last
    periodic checkpoint. Cleared automatically once any checkpoint is
    reported."""
    return _get_session().urgent_checkpoint.is_set()
