"""Replica actor: hosts one copy of the user callable.

Reference: ``serve/_private/replica.py`` — wraps the deployment's
class (or function), counts ongoing requests (the router's pow-2 signal
and the autoscaler's input), supports sync, async, and STREAMING
callables (generator/async-generator methods stream tokens back through
the runtime's streaming-generator path), plus model multiplexing
(``multiplex.py:22``): requests carry a model id, the replica reports
its loaded ids so the router can route model-local."""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.multiplex import _model_id_ctx, loaded_model_ids


class _Replica:
    """Defined undecorated so cloudpickle exports by module reference
    (see tune/trial.py for the rationale)."""

    def __init__(self, cls_or_fn, init_args, init_kwargs, deployment: str = "", controller_namespace=None):
        if inspect.isclass(cls_or_fn):
            self._callable = cls_or_fn(*init_args, **(init_kwargs or {}))
        else:
            self._callable = cls_or_fn
        self._ongoing = 0
        self._total = 0
        self._deployment = deployment
        self._controller_namespace = controller_namespace
        self._reported_models: list = []
        # SLO-ledger label hook: a callable that wants its metrics
        # labeled by deployment (the LLM engine's TTFT/ITL/e2e series)
        # learns its name here, BEFORE any request can arrive
        if deployment and hasattr(self._callable, "set_deployment_name"):
            try:
                self._callable.set_deployment_name(deployment)
            except Exception:  # noqa: BLE001 — labeling must not fail init
                pass
        # routing-stats gossip (cache-affinity routing): a callable that
        # exposes routing_stats() gets a reporter thread pushing load +
        # prefix digest to the controller on a timer — request-driven
        # reporting alone would leave an IDLE replica invisible to the
        # scored router (fresh stats are the fallback gate), so a cold
        # scale-up replica would never attract traffic
        self._stats_stop = threading.Event()
        if (
            deployment
            and hasattr(self._callable, "routing_stats")
            and GLOBAL_CONFIG.serve_replica_stats_period_s > 0
        ):
            threading.Thread(
                target=self._stats_report_loop,
                daemon=True,
                name=f"replica-stats-{deployment}",
            ).start()

    def _stats_report_loop(self) -> None:
        period = GLOBAL_CONFIG.serve_replica_stats_period_s
        controller = None
        me = ""
        while not self._stats_stop.wait(period):
            try:
                if controller is None:
                    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

                    me = ray_tpu_torch.get_runtime_context().get_actor_id() or ""
                    controller = ray_tpu_torch.get_actor(
                        CONTROLLER_NAME, namespace=self._controller_namespace
                    )
                stats = dict(self._callable.routing_stats())
                stats["ongoing"] = self._ongoing
                controller.report_replica_stats.remote(
                    self._deployment, me, stats
                )
            except Exception:
                # controller briefly unreachable (failover, startup
                # race): drop this tick, keep the loop alive
                controller = None

    def _resolve(self, method: str):
        if method == "__call__":
            return self._callable
        return getattr(self._callable, method)

    def _maybe_report_models(self) -> None:
        """Push the loaded-model set to the controller when it changes
        (reference: multiplexed model ids flow replica -> controller ->
        routers through the long-poll, so model-local routing reacts to
        loads/evictions immediately, not on a stats-poll TTL)."""
        models = loaded_model_ids(self._callable)
        if models == self._reported_models or not self._deployment:
            return
        try:
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME

            me = ray_tpu_torch.get_runtime_context().get_actor_id() or ""
            controller = ray_tpu_torch.get_actor(
                CONTROLLER_NAME, namespace=self._controller_namespace
            )
            controller.report_models.remote(self._deployment, me, models)
        except Exception:
            # controller briefly unreachable: leave _reported_models
            # unchanged so the NEXT request retries the report
            return
        self._reported_models = list(models)

    async def handle_request(self, method: str, args, kwargs, model_id: str = "") -> Any:
        self._ongoing += 1
        self._total += 1
        token = _model_id_ctx.set(model_id) if model_id else None
        try:
            fn = self._resolve(method)
            if inspect.iscoroutinefunction(fn) or (
                not inspect.isfunction(fn)
                and not inspect.ismethod(fn)
                and inspect.iscoroutinefunction(getattr(fn, "__call__", None))
            ):
                return await fn(*args, **(kwargs or {}))
            # Sync callables run on a worker thread: executing them inline
            # would block this actor's single async loop and serialize all
            # max_concurrent_queries requests (and starve stats()).
            loop = asyncio.get_event_loop()
            ctx = _model_id_ctx.get()

            def _call():
                t = _model_id_ctx.set(ctx)
                try:
                    return fn(*args, **(kwargs or {}))
                finally:
                    _model_id_ctx.reset(t)

            result = await loop.run_in_executor(None, _call)
            if inspect.iscoroutine(result):
                result = await result
            return result
        finally:
            if token is not None:
                _model_id_ctx.reset(token)
            self._ongoing -= 1
            if model_id:
                self._maybe_report_models()

    def handle_request_streaming(self, method: str, args, kwargs, model_id: str = ""):
        """Generator entry: invoked with ``num_returns="streaming"`` so
        every yielded item streams to the caller immediately (reference:
        streaming replica responses, ``replica.py`` + the
        ObjectRefStream protocol). Runs on a lane thread — blocking
        user generators don't stall the actor's async loop."""
        self._ongoing += 1
        self._total += 1
        token = _model_id_ctx.set(model_id) if model_id else None
        try:
            fn = self._resolve(method)
            out = fn(*args, **(kwargs or {}))
            if inspect.isasyncgen(out):
                from ray_tpu_torch.core.task_executor import _drain_async_gen

                yield from _drain_async_gen(out)
            elif inspect.isgenerator(out) or hasattr(out, "__iter__"):
                yield from out
            else:
                raise TypeError(
                    f"streaming call to {method!r} needs a generator/"
                    f"iterable return, got {type(out).__name__}"
                )
        finally:
            if token is not None:
                _model_id_ctx.reset(token)
            self._ongoing -= 1
            if model_id:
                self._maybe_report_models()

    def stats(self):
        return {
            "ongoing": self._ongoing,
            "total": self._total,
            "models": loaded_model_ids(self._callable),
        }

    def health(self) -> bool:
        check = getattr(self._callable, "check_health", None)
        if check is None:
            return True
        result = check()
        return bool(result) if not inspect.iscoroutine(result) else True


Replica = ray_tpu_torch.remote(_Replica)
