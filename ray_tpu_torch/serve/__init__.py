"""ray_tpu_torch.serve — model serving: deployments, replicas, routing, HTTP
(a copy of ``ray_tpu.serve`` on the port's runtime).

Reference: ``python/ray/serve/`` — the controller/replica/router/proxy
architecture (``_private/controller.py:84``, ``replica.py``,
``pow_2_scheduler.py:52``, ``proxy.py``) on ray_tpu_torch actors.

    import ray_tpu_torch
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __init__(self, scale):
            self.scale = scale
        def __call__(self, x):
            return self.scale * x

    handle = serve.run(Model.bind(3))
    assert ray_tpu_torch.get(handle.remote(2), timeout=30) == 6

A deployment's ``ray_actor_options={"num_gpus": 1}`` puts each replica on
a GPU of its own; ``max_concurrent_queries`` maps to actor
``max_concurrency`` so batched inference saturates a replica's card."""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import (
    CONTROLLER_NAME,
    get_or_create_controller,
)
from ray_tpu_torch.serve.ingress import (
    HttpIngress,
    IngressConfig,
    TenantPolicy,
    ingress_addresses,
    ingress_deployment,
    pick_ingress,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.proxy import start_http, stop_http
from ray_tpu_torch.serve.router import Router


class Application:
    """A deployment bound to its init args (reference ``.bind()``)."""

    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class DisaggApplication(Application):
    """A disaggregated two-pool application (decode deployment + its
    paired prefill deployment, ``llm_deployment(disaggregated=True)``).
    ``serve.run`` deploys ``prefill_app`` first, then this (decode)
    application, and returns the decode handle — the router discovers
    the pairing through the deployment's ``disagg_prefill`` meta, so
    any handle to the decode deployment (including one built later by
    an ingress replica) gets the two-stage dispatch."""

    def __init__(self, deployment: "Deployment", args, kwargs):
        super().__init__(deployment, args, kwargs)
        self.prefill_app: Optional[Application] = None


class Deployment:
    def __init__(self, cls_or_fn, name: str, config: DeploymentConfig):
        self._cls_or_fn = cls_or_fn
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **updates) -> "Deployment":
        import dataclasses

        cfg_fields = {f.name for f in dataclasses.fields(DeploymentConfig)}
        cfg = dataclasses.replace(
            self.config, **{k: v for k, v in updates.items() if k in cfg_fields}
        )
        name = updates.get("name", self.name)
        return Deployment(self._cls_or_fn, name, cfg)


def deployment(
    _cls=None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 8,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    autoscaling_config: Optional[AutoscalingConfig] = None,
    route_prefix: Optional[str] = None,
    version: Optional[str] = None,
):
    """Class/function decorator → Deployment (reference ``@serve.deployment``)."""

    def wrap(cls_or_fn):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling=autoscaling_config,
            route_prefix=route_prefix,
            version=version,
        )
        return Deployment(cls_or_fn, name or cls_or_fn.__name__, cfg)

    if _cls is not None:
        return wrap(_cls)
    return wrap


class DeploymentHandle:
    """Client-side handle: pow-2 routed calls returning ObjectRefs
    (reference ``DeploymentHandle``/``Router``).

    ``remote()`` is at-most-once and returns an ObjectRef;
    ``call()`` is retry-until-executed (reference router semantics);
    ``stream()`` iterates a streaming (generator) deployment's values;
    ``options(multiplexed_model_id=...)`` routes model-local
    (reference ``handle.options``)."""

    def __init__(self, deployment_name: str, controller=None, *, _shared_router=None, _model_id: str = ""):
        self._name = deployment_name
        self._controller = controller or get_or_create_controller()
        self._router = _shared_router or Router(self._controller, deployment_name)
        self._model_id = _model_id

    def options(self, *, multiplexed_model_id: str = "") -> "DeploymentHandle":
        # shares the router (and its long-poll thread + stats cache)
        return DeploymentHandle(
            self._name,
            self._controller,
            _shared_router=self._router,
            _model_id=multiplexed_model_id or self._model_id,
        )

    def remote(self, *args, **kwargs):
        return self._router.dispatch("__call__", args, kwargs, self._model_id)

    def call(self, *args, _timeout: Optional[float] = 60.0, _idempotent: bool = True, **kwargs):
        """Blocking retry-until-executed call (survives replica death
        mid-rolling-update). Exactly-once-effective while the replica is
        reachable (request-id dedup at the RPC layer absorbs lost
        replies and connection resets); AT-LEAST-ONCE across replica
        DEATH by default — see ``Router.execute`` for the full contract.
        Pass ``_idempotent=False`` for non-idempotent requests so a
        post-dispatch replica death propagates instead of re-executing
        on a survivor."""
        return self._router.execute(
            "__call__", args, kwargs, model_id=self._model_id,
            timeout=_timeout, idempotent=_idempotent,
        )

    def stream(self, *args, _method: str = "__call__", _timeout: Optional[float] = 60.0, **kwargs):
        """Iterate a generator deployment's yielded values (token
        streaming; reference streaming DeploymentResponseGenerator)."""
        return self._router.execute_stream(
            _method, args, kwargs, model_id=self._model_id, timeout=_timeout
        )

    def method(self, method_name: str):
        def call(*args, **kwargs):
            return self._router.dispatch(method_name, args, kwargs, self._model_id)

        return call

    def __reduce__(self):
        # Carry the controller's ACTOR HANDLE, not just the name: a
        # handle deserialized inside a worker (namespace "") cannot find
        # the named controller registered under the driver's namespace —
        # name-only reconstruction silently created a SECOND, empty
        # serve controller and every call failed with "no replicas".
        # The router (and its long-poll thread) is rebuilt lazily; the
        # multiplexed model id survives via the state dict.
        return (
            DeploymentHandle,
            (self._name, self._controller),
            {"_model_id": self._model_id},
        )


def run(app: Application, *, name: Optional[str] = None, _blocking_ready: bool = True) -> DeploymentHandle:
    """Deploy an application; returns its handle (reference ``serve.run``).
    A :class:`DisaggApplication` deploys its prefill pool first, then
    the decode pool, and returns the decode handle."""
    if isinstance(app, Deployment):
        app = app.bind()
    controller = get_or_create_controller()
    prefill = getattr(app, "prefill_app", None)
    if prefill is not None:
        pdep = prefill.deployment
        ray_tpu_torch.get(
            controller.deploy.remote(
                pdep.name, pdep._cls_or_fn, list(prefill.args),
                dict(prefill.kwargs), pdep.config,
            ),
            timeout=120,
        )
    dep = app.deployment
    ray_tpu_torch.get(
        controller.deploy.remote(
            dep.name, dep._cls_or_fn, list(app.args), dict(app.kwargs), dep.config
        ),
        timeout=120,
    )
    handle = DeploymentHandle(dep.name, controller)
    if _blocking_ready:
        if prefill is not None:
            # the prefill pool must be routable too, or the first
            # requests burn their whole handoff budget waiting on a
            # replica that is still warming up
            DeploymentHandle(pdep.name, controller)._router.choose_replica()
        handle._router.choose_replica()  # wait for ≥1 replica
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> None:
    controller = get_or_create_controller()
    # disaggregated deployments pair with a prefill pool serve.run
    # deployed alongside them — deleting only the decode pool would
    # orphan full engine replicas until serve.shutdown()
    try:
        meta = ray_tpu_torch.get(controller.deployment_meta.remote(name), timeout=30)
        prefill = (meta or {}).get("disagg_prefill")
    except Exception:
        prefill = None
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)
    if prefill:
        ray_tpu_torch.get(controller.delete_deployment.remote(prefill), timeout=60)


def status() -> Dict[str, Dict[str, Any]]:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def slo_report(*, flight_limit: int = 100, timeout: float = 60.0) -> Dict[str, Any]:
    """Cluster-wide SLO report (observability/slo.py): one call answers
    "what were TTFT/ITL/e2e p50/p99/p99.9 per deployment (and tenant
    class), how much of the token work was goodput vs fault cost, do the
    intake books balance, and which stage made the slow requests slow".

    The serve controller fans out to every replica for its ledger
    snapshot (aggregatable log-bucket histogram counts + flight-recorder
    ring + books); THIS process's own snapshot merges in too — the
    driver-side router is a tier of the serving path (its ledger holds
    the failover stage of resumed streams consumed here).

    Report shape: ``{"deployments": {name: {"ttft_s"/"itl_s"/"e2e_s":
    {p50, p99, p999, count}, "by_class": {...}, "goodput_tokens",
    "fault_tokens": {reason: n}, "goodput_fraction", "deadline_expired",
    "books": [...], "books_balanced", "restarts", "shed_total"}},
    "flight_recorder": [joined per-request records, slowest first, each
    with a per-tier stage breakdown, flags, resume counts, and the
    trace id when sampled], "counters": raw merged counter values}``.

    Degrades instead of erroring: with no serve controller (idle
    cluster, or serve never used — we look the actor up rather than
    CREATE one just to ask it for nothing), or with the fan-out timing
    out mid-restart, the report is built from the driver-local snapshot
    alone — well-formed and empty, under the caller's deadline."""
    from ray_tpu_torch.observability import slo as _slo

    collected: Dict[str, Any] = {}
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 — no controller / no cluster
        controller = None
    if controller is not None:
        try:
            # the controller-side fan-out budget rides INSIDE the
            # driver-side get timeout, so a wedged replica sweep
            # returns the survivors' snapshots instead of timing the
            # whole call out
            collected = ray_tpu_torch.get(
                controller.slo_snapshots.remote(
                    max(1.0, float(timeout) * 0.8)
                ),
                timeout=timeout,
            ) or {}
        except Exception:  # noqa: BLE001 — controller dead/slow: degrade
            collected = {}
    snapshots = list(collected.get("snapshots") or ())
    local = _slo.snapshot()
    local["tier"] = "driver"
    snapshots.append(local)
    return _slo.build_report(
        snapshots, collected.get("status"), flight_limit=flight_limit
    )


def shutdown() -> None:
    stop_http()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


def __getattr__(name: str):
    # lazy: the LLM deployment pulls in torch via the inference engine —
    # plain serve users (and control-plane processes) must not pay that
    if name == "llm_deployment":
        from ray_tpu_torch.inference.serve_llm import llm_deployment

        return llm_deployment
    if name == "LLMServer":
        from ray_tpu_torch.inference.serve_llm import LLMServer

        return LLMServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Application",
    "AutoscalingConfig",
    "batch",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DisaggApplication",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "HttpIngress",
    "IngressConfig",
    "TenantPolicy",
    "ingress_addresses",
    "ingress_deployment",
    "pick_ingress",
    # llm_deployment/LLMServer stay OUT of __all__: star-imports resolve
    # every listed name, which would trigger the lazy __getattr__ above
    # and drag torch into plain serve users. Reach them by attribute.
    "multiplexed",
    "run",
    "shutdown",
    "slo_report",
    "start_http",
    "status",
    "stop_http",
]
