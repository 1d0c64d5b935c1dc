"""HTTP proxy: aiohttp server routing requests to deployments.

Reference: ``serve/_private/proxy.py`` (uvicorn/starlette ASGI proxy +
``proxy_router``). Here: one aiohttp app per node (started on demand by
``serve.start_http``), routes ``{route_prefix}`` → deployment via the
controller's routing table, JSON in/out."""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.router import Router

_proxy = None
_lock = threading.Lock()
_SENTINEL = object()


class HttpProxy:
    def __init__(self, controller, host: str = "127.0.0.1", port: int = 8000):
        self._controller = controller
        self._routers: Dict[str, Router] = {}
        self.host = host
        self.port = port
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread = threading.Thread(target=self._serve, daemon=True, name="serve-proxy")
        self._thread.start()
        if not self._started.wait(15):
            raise RuntimeError("http proxy failed to start")

    def _router_for(self, deployment: str) -> Router:
        r = self._routers.get(deployment)
        if r is None:
            r = self._routers[deployment] = Router(self._controller, deployment)
        return r

    def _routes_cached(self) -> Dict[str, str]:
        import time

        now = time.monotonic()
        if now - getattr(self, "_routes_ts", 0.0) > 1.0:
            self._routes = ray_tpu_torch.get(self._controller.routes.remote(), timeout=30)
            self._routes_ts = now
        return self._routes

    async def _handle(self, request):
        from aiohttp import web

        loop = asyncio.get_event_loop()
        # the controller RPC blocks — never run it on the proxy loop (one
        # slow controller would freeze ALL in-flight HTTP traffic)
        routes = await loop.run_in_executor(None, self._routes_cached)
        path = request.path
        target = None
        for prefix, name in sorted(routes.items(), key=lambda kv: -len(kv[0])):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                target = name
                break
        if target is None:
            return web.json_response({"error": f"no route for {path}"}, status=404)
        model_id = request.headers.get("serve-multiplexed-model-id", "")
        streaming = "text/event-stream" in request.headers.get("Accept", "")
        try:
            body: Any = None
            if request.can_read_body:
                raw = await request.read()
                if raw:
                    try:
                        body = json.loads(raw)
                    except json.JSONDecodeError:
                        body = raw.decode()
            router = self._router_for(target)
            loop = asyncio.get_event_loop()
            if streaming:
                return await self._handle_stream(
                    request, router, body, model_id
                )
            # retry-until-executed: replica death mid-rolling-update must
            # not surface to the HTTP client (reference router semantics)
            result = await loop.run_in_executor(
                None,
                lambda: router.execute(
                    "__call__", (body,), {}, model_id=model_id, timeout=60
                ),
            )
            if isinstance(result, Exception):
                raise result
            return web.json_response({"result": result})
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": repr(e)}, status=500)

    async def _handle_stream(self, request, router, body, model_id):
        """SSE: each yielded item becomes one ``data:`` event (reference
        gRPC/HTTP streaming proxy responses, proxy.py:536). Once the
        response is prepared this method ALWAYS returns it — a client
        disconnect mid-stream must not bubble to the outer handler
        (which would try to send a second response) and must close the
        value generator so the replica stops producing."""
        from aiohttp import web

        loop = asyncio.get_event_loop()
        values = await loop.run_in_executor(
            None,
            lambda: router.execute_stream(
                "__call__", (body,), {}, model_id=model_id, timeout=60
            ),
        )
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        it = iter(values)
        try:
            while True:
                try:
                    item = await loop.run_in_executor(None, next, it, _SENTINEL)
                except Exception as e:  # noqa: BLE001 — mid-stream failure
                    await resp.write(
                        f"event: error\ndata: {json.dumps(repr(e))}\n\n".encode()
                    )
                    break
                if item is _SENTINEL:
                    break
                await resp.write(f"data: {json.dumps(item)}\n\n".encode())
            await resp.write_eof()
        except (ConnectionError, asyncio.CancelledError):
            pass  # client went away mid-stream
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                await loop.run_in_executor(None, close)
        return resp

    def _serve(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app)

        async def _start():
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            self._started.set()

        loop.run_until_complete(_start())
        loop.run_forever()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)


def start_http(controller, host: str = "127.0.0.1", port: int = 8000) -> HttpProxy:
    global _proxy
    with _lock:
        if _proxy is None:
            _proxy = HttpProxy(controller, host, port)
        return _proxy


def stop_http() -> None:
    global _proxy
    with _lock:
        if _proxy is not None:
            _proxy.stop()
            _proxy = None
