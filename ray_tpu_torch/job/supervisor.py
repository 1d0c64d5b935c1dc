"""JobSupervisor: a detached actor running one job's entrypoint.

Reference: ``dashboard/modules/job/job_supervisor.py:54`` — the
supervisor subprocess-spawns the entrypoint with the cluster address in
its env, pumps combined stdout/stderr to a log file, publishes status
transitions to the controller KV (so status survives the supervisor),
honors stop requests (SIGTERM → SIGKILL), and retries the entrypoint
``entrypoint_num_retries`` times on nonzero exit.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._host import TMP_ROOT

_STATUS_KEY = "job:%s:status"
_LOGS_KEY = "job:%s:logs"


def _kv():
    from ray_tpu_torch.core.api import _global_worker

    return _global_worker().backend


def read_job_status(job_id: str) -> Optional[Dict[str, Any]]:
    raw = _kv().kv_get((_STATUS_KEY % job_id).encode())
    return json.loads(raw) if raw else None


def read_persisted_logs(job_id: str) -> Optional[str]:
    raw = _kv().kv_get((_LOGS_KEY % job_id).encode())
    return raw.decode(errors="replace") if raw is not None else None


def write_job_status(
    job_id: str, entrypoint: str, status: str, message: str = ""
) -> None:
    """THE status-row writer (shared by manager-submit and supervisor —
    one schema, no drift)."""
    entry = read_job_status(job_id) or {
        "job_id": job_id,
        "entrypoint": entrypoint,
        "start_time": time.time(),
    }
    entry["status"] = status
    entry["message"] = message
    if status in ("SUCCEEDED", "FAILED", "STOPPED"):
        entry["end_time"] = time.time()
    _kv().kv_put((_STATUS_KEY % job_id).encode(), json.dumps(entry).encode())


class _JobSupervisor:
    """One per submitted job; ``lifetime="detached"`` + named
    ``_job_supervisor_{id}`` so SDK/REST find it after the submitting
    driver exits."""

    def __init__(
        self,
        job_id: str,
        entrypoint: str,
        *,
        cluster_address: str = "",
        env: Optional[Dict[str, str]] = None,
        num_retries: int = 0,
        working_dir: Optional[str] = None,
    ):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.cluster_address = cluster_address
        self.env = dict(env or {})
        self.num_retries = max(0, num_retries)
        self.working_dir = working_dir
        self.log_path = os.path.join(TMP_ROOT, "jobs", f"{job_id}.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        self._proc: Optional[subprocess.Popen] = None
        self._stop_requested = False
        # serializes stop() against the run loop's Popen assignment — a
        # stop racing the spawn must either kill the fresh process or be
        # seen by the loop before it spawns (no orphaned 600s entrypoint)
        self._proc_lock = threading.Lock()
        self._set_status("PENDING")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"job-{job_id}"
        )
        self._thread.start()

    # -- state -----------------------------------------------------------
    def _set_status(self, status: str, message: str = "") -> None:
        write_job_status(self.job_id, self.entrypoint, status, message)

    def _persist_logs(self) -> None:
        """Terminal state: copy the log file into KV so logs outlive
        this actor (the reference streams to GCS-backed files)."""
        try:
            with open(self.log_path, "rb") as f:
                data = f.read()
            _kv().kv_put((_LOGS_KEY % self.job_id).encode(), data[-2_000_000:])
        except OSError:
            pass

    # -- run loop --------------------------------------------------------
    def _run(self) -> None:
        attempts = self.num_retries + 1
        code = -1
        for attempt in range(attempts):
            if self._stop_requested:
                break
            env = dict(os.environ)
            env.update(self.env)
            if self.cluster_address:
                env["RAY_TPU_ADDRESS"] = self.cluster_address
            env["RAY_TPU_JOB_ID"] = self.job_id
            log_f = open(self.log_path, "ab")
            if attempt:
                log_f.write(
                    f"\n--- entrypoint retry {attempt}/{self.num_retries} ---\n".encode()
                )
                log_f.flush()
            self._set_status("RUNNING")
            try:
                with self._proc_lock:
                    if self._stop_requested:
                        log_f.close()
                        break  # stop raced the spawn: never start it
                    self._proc = subprocess.Popen(
                        self.entrypoint,
                        shell=True,
                        stdout=log_f,
                        stderr=subprocess.STDOUT,
                        cwd=self.working_dir or None,
                        env=env,
                        start_new_session=True,  # stop() kills the whole tree
                    )
            except OSError as e:
                log_f.close()
                self._set_status("FAILED", f"failed to spawn entrypoint: {e!r}")
                self._persist_logs()
                return
            code = self._proc.wait()
            log_f.close()
            if self._stop_requested:
                break
            if code == 0:
                self._set_status("SUCCEEDED")
                self._persist_logs()
                return
        if self._stop_requested:
            self._set_status("STOPPED", "stopped by user")
        else:
            self._set_status("FAILED", f"entrypoint exited with code {code}")
        self._persist_logs()

    # -- API -------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        return read_job_status(self.job_id) or {"status": "PENDING"}

    def logs(self) -> str:
        try:
            with open(self.log_path, "r", errors="replace") as f:
                return f.read()
        except OSError:
            return ""

    def stop(self) -> bool:
        """Request a stop. True = the stop took effect (either a live
        entrypoint was signalled or the run loop will see the flag
        before/without spawning); False only if the job ALREADY reached
        a terminal state."""
        with self._proc_lock:
            already_done = not self._thread.is_alive()
            self._stop_requested = True
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except OSError:
                pass

            def _escalate():
                time.sleep(3.0)
                if proc.poll() is None:
                    try:
                        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                    except OSError:
                        pass

            threading.Thread(target=_escalate, daemon=True).start()
            return True
        return not already_done

    def done(self) -> bool:
        return not self._thread.is_alive()


JobSupervisor = ray_tpu_torch.remote(_JobSupervisor)
