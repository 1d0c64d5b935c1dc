"""JobManager: driver-side orchestration of job supervisors.

Reference: ``dashboard/modules/job/job_manager.py:59`` — allocates
submission ids, spawns the per-job supervisor actor, reads status/logs
(from KV once the supervisor is gone), stops jobs.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.job.supervisor import (
    JobSupervisor,
    read_job_status,
    read_persisted_logs,
)

_SUPERVISOR_NAME = "_job_supervisor_%s"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = frozenset({SUCCEEDED, FAILED, STOPPED})


def _derive_cluster_address() -> str:
    """The connected cluster's ``host:cport:dport`` (what entrypoints
    get as RAY_TPU_ADDRESS) — empty for local/in-process backends."""
    try:
        from ray_tpu_torch.core.api import _global_worker

        be = _global_worker().backend
        c, d = getattr(be, "controller", None), getattr(be, "daemon", None)
        if c is not None and d is not None:
            return f"{c.host}:{c.port}:{d.port}"
    except Exception:
        pass
    return ""


class JobManager:
    def __init__(self, cluster_address: str = ""):
        self.cluster_address = cluster_address or _derive_cluster_address()
        # serializes the duplicate-id check against the PENDING write —
        # concurrent REST submits share one manager. (Submits from
        # DIFFERENT processes could still race; a KV compare-and-set
        # would be needed for that.)
        import threading

        self._submit_lock = threading.Lock()

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        entrypoint_num_retries: int = 0,
        working_dir: Optional[str] = None,
    ) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        # write PENDING synchronously — the supervisor spawn is async and
        # a status poll racing it must see the job, not a 404 (reference:
        # JobManager records the job info row before starting the actor)
        from ray_tpu_torch.job.supervisor import write_job_status

        with self._submit_lock:
            if read_job_status(job_id) is not None:
                raise ValueError(f"job {job_id!r} already exists")
            write_job_status(job_id, entrypoint, JobStatus.PENDING)
        JobSupervisor.options(
            name=_SUPERVISOR_NAME % job_id,
            lifetime="detached",
            num_cpus=0,
        ).remote(
            job_id,
            entrypoint,
            cluster_address=self.cluster_address,
            env=env,
            num_retries=entrypoint_num_retries,
            working_dir=working_dir,
        )
        return job_id

    def _supervisor(self, job_id: str):
        try:
            return ray_tpu_torch.get_actor(_SUPERVISOR_NAME % job_id)
        except Exception:
            return None

    def get_job_status(self, job_id: str) -> Optional[Dict[str, Any]]:
        return read_job_status(job_id)

    def get_job_logs(self, job_id: str) -> str:
        sup = self._supervisor(job_id)
        if sup is not None:
            try:
                return ray_tpu_torch.get(sup.logs.remote(), timeout=30)
            except Exception:
                pass  # supervisor died — fall back to persisted logs
        return read_persisted_logs(job_id) or ""

    def stop_job(self, job_id: str) -> bool:
        sup = self._supervisor(job_id)
        if sup is None:
            return False
        try:
            return ray_tpu_torch.get(sup.stop.remote(), timeout=30)
        except Exception:
            return False

    def list_jobs(self) -> List[Dict[str, Any]]:
        from ray_tpu_torch.core.api import _global_worker

        backend = _global_worker().backend
        keys = backend.kv_keys(b"job:")
        out = []
        for k in keys:
            if k.endswith(b":status"):
                import json

                raw = backend.kv_get(k)
                if raw:
                    out.append(json.loads(raw))
        return sorted(out, key=lambda j: j.get("start_time", 0))

    def delete_job(self, job_id: str) -> bool:
        """Remove a TERMINAL job's records (reference delete semantics)."""
        status = read_job_status(job_id)
        if status is None or status.get("status") not in JobStatus.TERMINAL:
            return False
        from ray_tpu_torch.core.api import _global_worker

        backend = _global_worker().backend
        backend.kv_del(f"job:{job_id}:status".encode())
        backend.kv_del(f"job:{job_id}:logs".encode())
        sup = self._supervisor(job_id)
        if sup is not None:
            try:
                ray_tpu_torch.kill(sup)
            except Exception:
                pass
        return True
