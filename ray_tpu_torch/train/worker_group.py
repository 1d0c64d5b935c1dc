"""Worker group: the gang of training-worker actors.

Reference: ``train/_internal/worker_group.py:19,102`` (actor gang in a
placement group) + ``train/_internal/backend_executor.py:68`` (start,
env setup, poll). Redesign: the user loop runs on a thread inside each
actor; the trainer pulls buffered reports via ``poll_results`` instead of
the reference's blocking session queue handoff.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _end_session, _start_session
from ray_tpu_torch.util.placement_group import PlacementGroup, placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


def _node_ip_address() -> str:
    """The address a gang's rendezvous listens on. The port's runtime runs
    its processes on one host and serves every RPC on the loopback
    (``core_worker.py``, ``cluster_backend.py``), so rank 0's store binds
    there too. No socket is opened towards another host to find it (the
    reference probes a public address to learn its routed interface)."""
    return "127.0.0.1"


class TrainWorker:
    """Actor hosting one training process (one slice host on TPU)."""

    def __init__(self):
        self._session = None
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._error: Optional[bytes] = None

    # -- host/topology info (backend rendezvous) ------------------------
    def get_address(self) -> Dict[str, Any]:
        host = _node_ip_address()
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            free_port = s.getsockname()[1]
        return {"host": host, "free_port": free_port, "pid": os.getpid()}

    def set_env(self, env: Dict[str, str]) -> bool:
        """Backend env setup, before the training loop starts."""
        os.environ.update(env)
        return True

    def run_fn(self, fn: Callable, *args):
        """Run an arbitrary function in-actor (backend hooks)."""
        return fn(*args)

    # -- training lifecycle ---------------------------------------------
    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict[str, Any]],
        context: TrainContext,
        setup_fn: Optional[Callable] = None,
    ) -> bool:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("training already running on this worker")
        self._done.clear()
        self._error = None
        self._session = _start_session(context)

        def _run():
            try:
                if setup_fn is not None:
                    setup_fn(context)
                if config is not None:
                    train_fn(config)
                else:
                    train_fn()
            except BaseException as e:  # noqa: BLE001
                self._session.error = e
                self._error = pickle.dumps(
                    RuntimeError(
                        f"train_loop_per_worker failed on rank "
                        f"{context.world_rank}: {e!r}\n{traceback.format_exc()}"
                    )
                )
            finally:
                self._done.set()

        self._thread = threading.Thread(target=_run, daemon=True, name="train-loop")
        self._thread.start()
        return True

    def request_urgent_checkpoint(self) -> bool:
        """Preemption warning relay (trainer → session): the user loop
        sees ``train.urgent_checkpoint_requested()`` flip and saves at
        its next step boundary."""
        if self._session is not None:
            self._session.urgent_checkpoint.set()
            return True
        return False

    def poll_results(self) -> Dict[str, Any]:
        """Drain buffered ``report()`` calls; reference
        ``backend_executor.get_next_results``."""
        # Snapshot done and error BEFORE draining: the train thread enqueues
        # its last report and only then sets _error/_done, so snapshotting
        # first guarantees that when done/error shows up in a poll, every
        # report enqueued before it is visible to this or a later drain —
        # the trainer raises only once the erroring rank's queue is empty.
        done = self._done.is_set()
        error = self._error
        reports = self._session.drain() if self._session else []
        return {
            "reports": reports,
            "done": done,
            "error": error,
        }

    def finish(self) -> bool:
        if self._thread is not None:
            self._thread.join(timeout=5)
        _end_session()
        self._session = None
        return True


class WorkerGroup:
    """N TrainWorker actors gang-placed in a placement group."""

    def __init__(
        self,
        num_workers: int,
        bundles: List[Dict[str, float]],
        pg_strategy: str,
        *,
        max_restarts: int = 0,
    ):
        self.num_workers = num_workers
        self.pg: PlacementGroup = placement_group(bundles, strategy=pg_strategy)
        self.workers = []
        # A gang left half made (an error, or a SystemExit from a stopped
        # job's SIGTERM while the workers come up) goes before the error
        # leaves: the caller never gets the group to shut down, and its
        # placement group and actors would hold their GPUs after the driver.
        try:
            self.pg.ready(timeout=60)
            cls = ray_tpu_torch.remote(TrainWorker)
            for rank in range(num_workers):
                strategy = PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=rank
                )
                res = dict(bundles[rank])
                num_cpus = res.pop("CPU", 1.0)
                self.workers.append(
                    cls.options(
                        num_cpus=num_cpus,
                        resources=res or None,
                        scheduling_strategy=strategy,
                        max_restarts=0,
                    ).remote()
                )
            # block until every worker process is up
            ray_tpu_torch.get([w.__ray_ready__() for w in self.workers], timeout=120)
        except BaseException:
            self.shutdown()
            raise

    def execute(self, method: str, *args, timeout: Optional[float] = None, **kwargs) -> List[Any]:
        """Call an actor method on every worker, gather results."""
        refs = [getattr(w, method).remote(*args, **kwargs) for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, rank: int, method: str, *args, timeout: Optional[float] = None, **kwargs) -> Any:
        ref = getattr(self.workers[rank], method).remote(*args, **kwargs)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w, no_restart=True)
            except Exception:
                pass
        self.workers = []
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
