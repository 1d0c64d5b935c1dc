"""Actor classes, handles, and methods.

Reference: ``python/ray/actor.py`` — ``ActorClass._remote`` (``:869``)
registers the actor with the control plane and returns a serializable
``ActorHandle``; method calls flow through per-handle ordered submission
(sequence numbers assigned at submit, enforced server-side — reference
``SequentialActorSubmitQueue``). ``@method`` sets per-method options such as
``num_returns`` and ``concurrency_group``.
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core.api import _global_worker
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.refs import Address, ObjectRef
from ray_tpu_torch.core.task_spec import TaskKind, TaskOptions


def method(**opts):
    """Decorator for actor methods: ``@method(num_returns=2)``."""

    def wrap(fn):
        fn.__ray_tpu_method_opts__ = opts
        return fn

    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, opts: Dict[str, Any]):
        self._handle = handle
        self._name = name
        self._opts = opts

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._name, args, kwargs, self._opts)

    def options(self, **updates) -> "ActorMethod":
        merged = dict(self._opts)
        merged.update(updates)
        return ActorMethod(self._handle, self._name, merged)

    def bind(self, *args, **kwargs):
        try:
            from ray_tpu_torch.dag.node import ActorMethodNode
        except ImportError as e:
            raise NotImplementedError(
                "ray_tpu_torch.dag (compiled graphs) is not available in this build"
            ) from e

        return ActorMethodNode(self._handle, self._name, args, kwargs, self._opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name}() cannot be called directly; use "
            f".{self._name}.remote()"
        )


class ActorHandle:
    """Serializable reference to a running actor.

    Lifetime (reference ``actor.py`` handle semantics): the handle
    returned by ``Cls.remote()`` OWNS an anonymous non-detached actor —
    when it is garbage-collected the actor is terminated, freeing its
    resources. Deserialized copies and ``get_actor`` lookups are borrowed
    and never terminate on drop. NAMED actors are registry-reachable
    (``get_actor``) and therefore exempt, as are ``lifetime="detached"``
    actors — both die only via ``kill``/job end. (The reference refcounts
    every live handle cluster-wide; creator-handle ownership is this
    build's approximation.)"""

    def __init__(
        self,
        actor_id: ActorID,
        method_opts: Dict[str, Dict[str, Any]],
        owner: Optional[Address],
        name: Optional[str] = None,
        namespace: Optional[str] = None,
        owned: bool = False,
        max_concurrency: int = 1,
    ):
        self._actor_id = actor_id
        self._method_opts = method_opts
        self._owner = owner
        self._name = name
        self._namespace = namespace
        self._owned = owned
        # carried in the handle so a BORROWER's first calls dispatch
        # concurrently instead of serializing through the ordered pump
        # until an actor-info round-trip resolves it
        self._max_concurrency = max(1, max_concurrency)
        self._seq_lock = threading.Lock()
        self._seq_no = 0
        # per-method cached task-spec templates (invariant fields spliced
        # with per-call args/seq at submit); False = method not
        # templatable. Rebuilt lazily, never serialized with the handle.
        self._templates: Dict[str, Any] = {}

    def __del__(self):
        if not getattr(self, "_owned", False):
            return
        try:
            from ray_tpu_torch.core.api import get_global_worker_or_none

            w = get_global_worker_or_none()
            if w is None:
                return
            # Graceful out-of-scope termination (reference actor GC):
            # __ray_terminate__ rides the per-actor ORDERED submit queue,
            # so every call submitted before the handle dropped drains
            # first; restarts are disabled via a non-blocking control
            # message. Everything here is fire-and-forget — cyclic GC can
            # run __del__ on any thread (including the io loop), where a
            # blocking RPC wait would deadlock the driver.
            w.backend.mark_actor_no_restart(self._actor_id)
            self._submit_method("__ray_terminate__", (), {}, {})
        except Exception:
            pass  # interpreter teardown / backend already gone

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        opts = self._method_opts.get(name)
        if opts is None:
            raise AttributeError(f"actor has no method {name!r}")
        return ActorMethod(self, name, opts)

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq_no += 1
            return self._seq_no

    def _submit_method(self, method_name: str, args, kwargs, opts: Dict[str, Any]):
        worker = _global_worker()
        # Fast path — cached spec template. Only the DEFAULT method opts
        # (the dict stored in method_opts, handed out by __getattr__) are
        # templatable: an .options() override builds a fresh merged dict,
        # which falls through to the slow path below. Built-in __ray_*
        # methods stay on the slow path — __ray_terminate__ runs from
        # __del__ (possibly ON the io loop), where first-call template
        # registration (a blocking kv_put) could deadlock.
        if not method_name.startswith("__ray_") and (
            opts is self._method_opts.get(method_name) or not opts
        ):
            tmpl = self._templates.get(method_name)
            if tmpl is not False:
                if not worker.template_current(tmpl):
                    topts0 = TaskOptions().merged_with(
                        **{
                            k: v
                            for k, v in opts.items()
                            if k in TaskOptions.__dataclass_fields__
                        }
                    )
                    tmpl = worker.make_spec_template(
                        TaskKind.ACTOR_TASK,
                        None,
                        method_name,
                        topts0,
                        actor_id=self._actor_id,
                        method_name=method_name,
                        default_cpus=0.0,
                        max_concurrency=self._max_concurrency,
                        concurrency_group=opts.get("concurrency_group"),
                    )
                    self._templates[method_name] = tmpl if tmpl is not None else False
                if tmpl:
                    return worker.submit_from_template(
                        tmpl, args, kwargs, next_seq=self._next_seq
                    )
        topts = TaskOptions().merged_with(
            **{k: v for k, v in opts.items() if k in TaskOptions.__dataclass_fields__}
        )
        spec = worker.make_task_spec(
            TaskKind.ACTOR_TASK,
            None,
            f"{method_name}",
            args,
            kwargs,
            topts,
            actor_id=self._actor_id,
            method_name=method_name,
            default_cpus=0.0,
        )
        spec.seq_no = self._next_seq()
        spec.concurrency_group = opts.get("concurrency_group")
        spec.max_concurrency = self._max_concurrency  # dispatch-path hint
        if spec.num_returns == "streaming":
            # generator method: items stream back over the push connection
            # exactly like normal streaming tasks (task_manager.h:102)
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            worker.backend.create_stream(spec)
            worker.backend.submit_actor_task(spec)
            return ObjectRefGenerator(
                worker.backend, spec.task_id.binary(), worker.address
            )
        worker.backend.submit_actor_task(spec)
        refs = [ObjectRef(oid, worker.address) for oid in spec.return_ids]
        worker.backend.release_hold(spec.return_ids)
        if spec.num_returns == 0:
            return None
        return refs[0] if spec.num_returns == 1 else refs

    def __ray_ready__(self) -> ObjectRef:
        return self._submit_method("__ray_ready__", (), {}, {})

    def __ray_terminate__(self) -> ObjectRef:
        return self._submit_method("__ray_terminate__", (), {}, {})

    def __reduce__(self):
        # Serializing a handle HANDS THE ACTOR OFF: without distributed
        # handle refcounting, auto-reclaim on creator-handle drop would
        # kill an actor another process is using (factory pattern). A
        # shared actor's lifetime falls back to kill()/job end.
        self._owned = False
        return (
            ActorHandle,
            (
                self._actor_id,
                self._method_opts,
                self._owner,
                self._name,
                self._namespace,
                False,
                self._max_concurrency,
            ),
        )

    def __repr__(self) -> str:
        return f"ActorHandle({self._actor_id.hex()}, name={self._name!r})"


def _collect_method_opts(cls: type) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for name, member in inspect.getmembers(cls, predicate=callable):
        if name.startswith("__") and name not in ("__call__",):
            continue
        out[name] = dict(getattr(member, "__ray_tpu_method_opts__", {}))
    out["__ray_ready__"] = {}
    out["__ray_terminate__"] = {}
    return out


class ActorClass:
    def __init__(self, cls: type, opts: Optional[TaskOptions] = None):
        if not inspect.isclass(cls):
            raise TypeError("@remote on non-class; use RemoteFunction")
        self._cls = cls
        self._opts = opts or TaskOptions()
        self.__name__ = cls.__name__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()"
        )

    def options(self, **updates) -> "ActorClass":
        return ActorClass(self._cls, self._opts.merged_with(**updates))

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = _global_worker()
        opts = self._opts
        if opts.name and opts.get_if_exists:
            try:
                return get_actor(opts.name, opts.namespace)
            except ValueError:
                pass
        actor_id = ActorID.of(worker.job_id)
        spec = worker.make_task_spec(
            TaskKind.ACTOR_CREATION,
            self._cls,
            f"{self._cls.__name__}.__init__",
            args,
            kwargs,
            opts,
            actor_id=actor_id,
            default_cpus=1.0,
        )
        spec.method_opts = _collect_method_opts(self._cls)
        try:
            worker.backend.create_actor(spec)
        except ValueError:
            if opts.name and opts.get_if_exists:
                # lost the name race — someone created it first
                return get_actor(opts.name, opts.namespace)
            raise
        return ActorHandle(
            actor_id,
            spec.method_opts,
            worker.address,
            name=opts.name,
            namespace=opts.namespace or worker.namespace,
            owned=opts.lifetime != "detached" and opts.name is None,
            max_concurrency=opts.max_concurrency or 1,
        )

    def bind(self, *args, **kwargs):
        try:
            from ray_tpu_torch.dag.node import ActorClassNode
        except ImportError as e:
            raise NotImplementedError(
                "ray_tpu_torch.dag (compiled graphs) is not available in this build"
            ) from e

        return ActorClassNode(self, args, kwargs)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    worker = _global_worker()
    info = worker.backend.get_named_actor(name, namespace or worker.namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    actor_id, method_opts, owner = info[:3]
    maxc = info[3] if len(info) > 3 else 1
    return ActorHandle(
        actor_id, method_opts, owner, name=name, namespace=namespace,
        max_concurrency=maxc,
    )


def kill(actor_or_handle, *, no_restart: bool = True) -> None:
    if not isinstance(actor_or_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _global_worker().backend.kill_actor(actor_or_handle.actor_id, no_restart)
