"""JobSubmissionClient: HTTP client for the job REST API.

Reference: ``dashboard/modules/job/sdk.py:125`` (``submit_job``) — the
operator-facing entry: submit an entrypoint over HTTP, poll status,
fetch/tail logs, stop.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional


class JobSubmissionClient:
    def __init__(self, address: str = "http://127.0.0.1:8265"):
        self.address = address.rstrip("/")

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.address + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            payload = e.read()
            try:
                detail = json.loads(payload).get("error", payload.decode())
            except Exception:
                detail = payload.decode(errors="replace")
            raise RuntimeError(f"{method} {path}: {e.code} {detail}") from None

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        entrypoint_num_retries: int = 0,
        working_dir: Optional[str] = None,
    ) -> str:
        body: Dict[str, Any] = {"entrypoint": entrypoint}
        if submission_id:
            body["submission_id"] = submission_id
        if env:
            body["env"] = env
        if entrypoint_num_retries:
            body["entrypoint_num_retries"] = entrypoint_num_retries
        if working_dir:
            body["working_dir"] = working_dir
        return self._request("POST", "/api/jobs/", body)["submission_id"]

    def get_job_status(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}")["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/api/jobs/{job_id}")

    def get_job_logs(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def stop_job(self, job_id: str) -> bool:
        return self._request("POST", f"/api/jobs/{job_id}/stop")["stopped"]

    def delete_job(self, job_id: str) -> bool:
        return self._request("DELETE", f"/api/jobs/{job_id}")["deleted"]

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/api/jobs/")["jobs"]

    def wait_until_terminal(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        status = None
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {status!r} after {timeout}s")

    def tail_job_logs(self, job_id: str, poll_s: float = 0.5) -> Iterator[str]:
        """Yield log increments until the job reaches a terminal state
        (reference async tail, polled over plain HTTP here)."""
        seen = 0
        while True:
            logs = self.get_job_logs(job_id)
            if len(logs) > seen:
                yield logs[seen:]
                seen = len(logs)
            if self.get_job_status(job_id) in ("SUCCEEDED", "FAILED", "STOPPED"):
                logs = self.get_job_logs(job_id)
                if len(logs) > seen:
                    yield logs[seen:]
                return
            time.sleep(poll_s)
