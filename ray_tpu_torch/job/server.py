"""Job REST API: aiohttp server exposing reference-compatible routes.

Reference: ``dashboard/modules/job/job_head.py`` — the dashboard-hosted
REST surface the ``JobSubmissionClient`` speaks:

  POST /api/jobs/                      submit
  GET  /api/jobs/                      list
  GET  /api/jobs/{submission_id}       status
  GET  /api/jobs/{submission_id}/logs  logs
  POST /api/jobs/{submission_id}/stop  stop
  DELETE /api/jobs/{submission_id}     delete

Runs on a thread inside a connected driver process (mirrors
``serve/proxy.py``), or standalone: ``python -m ray_tpu_torch.job.server
--address <cluster> --port 8265``.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional

from ray_tpu_torch.job.manager import JobManager

_server = None
_lock = threading.Lock()


class JobServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265, cluster_address: str = ""):
        self.manager = JobManager(cluster_address)
        self.host = host
        self.port = port
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread = threading.Thread(target=self._serve, daemon=True, name="job-server")
        self._thread.start()
        if not self._started.wait(15):
            raise RuntimeError("job REST server failed to start")

    async def _submit(self, request):
        from aiohttp import web

        try:
            body = json.loads(await request.read() or b"{}")
            entrypoint = body["entrypoint"]
        except (json.JSONDecodeError, KeyError):
            return web.json_response(
                {"error": "body must be JSON with an 'entrypoint'"}, status=400
            )
        loop = asyncio.get_event_loop()
        try:
            job_id = await loop.run_in_executor(
                None,
                lambda: self.manager.submit_job(
                    entrypoint=entrypoint,
                    submission_id=body.get("submission_id"),
                    env=body.get("env"),
                    entrypoint_num_retries=int(body.get("entrypoint_num_retries", 0)),
                    working_dir=body.get("working_dir"),
                ),
            )
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"submission_id": job_id})

    async def _list(self, request):
        from aiohttp import web

        loop = asyncio.get_event_loop()
        jobs = await loop.run_in_executor(None, self.manager.list_jobs)
        return web.json_response({"jobs": jobs})

    async def _status(self, request):
        from aiohttp import web

        job_id = request.match_info["job_id"]
        loop = asyncio.get_event_loop()
        status = await loop.run_in_executor(None, self.manager.get_job_status, job_id)
        if status is None:
            return web.json_response({"error": f"no job {job_id!r}"}, status=404)
        return web.json_response(status)

    async def _logs(self, request):
        from aiohttp import web

        job_id = request.match_info["job_id"]
        loop = asyncio.get_event_loop()
        if await loop.run_in_executor(None, self.manager.get_job_status, job_id) is None:
            return web.json_response({"error": f"no job {job_id!r}"}, status=404)
        logs = await loop.run_in_executor(None, self.manager.get_job_logs, job_id)
        return web.json_response({"logs": logs})

    async def _stop(self, request):
        from aiohttp import web

        job_id = request.match_info["job_id"]
        loop = asyncio.get_event_loop()
        ok = await loop.run_in_executor(None, self.manager.stop_job, job_id)
        return web.json_response({"stopped": ok})

    async def _delete(self, request):
        from aiohttp import web

        job_id = request.match_info["job_id"]
        loop = asyncio.get_event_loop()
        ok = await loop.run_in_executor(None, self.manager.delete_job, job_id)
        status = 200 if ok else 400
        return web.json_response({"deleted": ok}, status=status)

    def _serve(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        app = web.Application()
        app.router.add_post("/api/jobs/", self._submit)
        app.router.add_get("/api/jobs/", self._list)
        app.router.add_get("/api/jobs/{job_id}", self._status)
        app.router.add_get("/api/jobs/{job_id}/logs", self._logs)
        app.router.add_post("/api/jobs/{job_id}/stop", self._stop)
        app.router.add_delete("/api/jobs/{job_id}", self._delete)
        runner = web.AppRunner(app)

        async def _start():
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            # resolve the real port when started with port=0
            for sock in site._server.sockets:  # type: ignore[union-attr]
                self.port = sock.getsockname()[1]
                break
            self._started.set()

        loop.run_until_complete(_start())
        loop.run_forever()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)


def start_job_server(host: str = "127.0.0.1", port: int = 8265, cluster_address: str = "") -> JobServer:
    global _server
    with _lock:
        if _server is None:
            _server = JobServer(host, port, cluster_address)
        return _server


def stop_job_server() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None


def main() -> None:
    import argparse
    import time

    import ray_tpu_torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True, help="cluster address host:cport:dport")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8265)
    args = parser.parse_args()
    ray_tpu_torch.init(address=args.address)
    server = start_job_server(args.host, args.port, args.address)
    print(json.dumps({"job_server_port": server.port}), flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
