"""The driver/worker-side runtime core and public API implementation.

Equivalent of the reference's ``python/ray/_private/worker.py``: a global
``Worker`` owns the connection to a runtime backend, performs argument
serialization/inlining on submit, creates return refs (ownership lives with
the submitter — reference ownership model), and implements
get/put/wait/kill/cancel on top of the backend.

Two backends implement ``RuntimeBackend``:
  * ``LocalBackend`` — in-process eager execution (``local_mode``).
  * ``ClusterBackend`` — the real multiprocess runtime (controller + node
    daemons + workers, shared-memory object store).
"""

from __future__ import annotations

import atexit
import contextvars
import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.exceptions import GetTimeoutError, TaskError
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.refs import Address, ObjectRef, set_refcount_hooks
from ray_tpu_torch.core.function_manager import FunctionTable, TemplateTable
from ray_tpu_torch.core.task_spec import (
    DefaultScheduling,
    SpecTemplate,
    TaskKind,
    TaskOptions,
    TaskSpec,
)


class RuntimeBackend(ABC):
    """What a runtime must provide to the API layer."""

    @abstractmethod
    def put_object(self, object_id: ObjectID, value: serialization.SerializedValue) -> None: ...

    @abstractmethod
    def get_objects(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]: ...

    @abstractmethod
    def wait(self, refs: Sequence[ObjectRef], num_returns: int, timeout: Optional[float], fetch_local: bool) -> Tuple[List[ObjectRef], List[ObjectRef]]: ...

    @abstractmethod
    def submit_task(self, spec: TaskSpec) -> None: ...

    @abstractmethod
    def create_actor(self, spec: TaskSpec) -> None: ...

    @abstractmethod
    def submit_actor_task(self, spec: TaskSpec) -> None: ...

    @abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None: ...

    def kill_actor_nowait(self, actor_id: ActorID) -> None:
        """Fire-and-forget kill, safe from GC/finalizer contexts."""
        self.kill_actor(actor_id, True)

    def mark_actor_no_restart(self, actor_id: ActorID) -> None:
        """Disable restarts ahead of a graceful termination (no-op where
        restarts don't exist)."""

    @abstractmethod
    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None: ...

    @abstractmethod
    def get_named_actor(self, name: str, namespace: str) -> Any: ...

    @abstractmethod
    def list_named_actors(self, all_namespaces: bool) -> List[Any]: ...

    @abstractmethod
    def kv_put(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def kv_get(self, key: bytes) -> Optional[bytes]: ...

    def kv_keys(self, prefix: bytes = b"") -> List[bytes]:
        return []

    @abstractmethod
    def free(self, object_ids: Sequence[ObjectID]) -> None: ...

    @abstractmethod
    def add_local_ref(self, ref: ObjectRef) -> None: ...

    @abstractmethod
    def remove_local_ref(self, ref: ObjectRef) -> None: ...

    def register_borrow(self, ref: ObjectRef) -> None:
        """A ref was deserialized into this process (borrower protocol)."""
        self.add_local_ref(ref)

    def release_hold(self, object_ids: Sequence[ObjectID]) -> None:
        """Release the submission hold after real ObjectRefs exist."""

    @abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    @abstractmethod
    def nodes(self) -> List[Dict[str, Any]]: ...

    @abstractmethod
    def shutdown(self) -> None: ...


class Worker:
    """Per-process runtime state (driver, worker, or local mode)."""

    MODE_LOCAL = "local"
    MODE_DRIVER = "driver"
    MODE_WORKER = "worker"

    def __init__(self, mode: str, backend: RuntimeBackend, job_id: JobID, namespace: str):
        self.mode = mode
        self.backend = backend
        self.job_id = job_id
        self.namespace = namespace
        self.worker_id = WorkerID.from_random()
        self.address: Optional[Address] = None  # set by cluster runtime
        self._put_counter = 0
        self._task_counter = 0
        self._packaged_envs: Dict[Any, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.fn_table = FunctionTable(backend.kv_put, backend.kv_get)
        self.tmpl_table = TemplateTable(backend.kv_put)
        # Pre-warm the None-function export (actor-method specs carry
        # function_obj=None; its FIRST export does a blocking kv_put).
        # Without this, the first slow-path actor submit in a process can
        # be ActorHandle.__del__'s __ray_terminate__ — and cyclic GC can
        # run that __del__ ON the io-loop thread (any allocation there can
        # trigger it), where a blocking io.run() deadlocks the driver: the
        # loop waits on a future only the loop itself could resolve.
        try:
            self.fn_table.export(None)
        except Exception:
            pass  # backend not reachable yet: __del__'s own guard remains
        set_refcount_hooks(self._on_ref_created, self._on_ref_deleted, self._on_ref_borrowed)

    # ---- task context --------------------------------------------------
    # A ContextVar (not threading.local) so the context is correct both on
    # lane threads AND per-coroutine on the async-actor lane — each asyncio
    # task carries its own copy, so concurrent async methods can't cross
    # puts into each other's ObjectID namespace. Entries are job-scoped:
    # a cached driver TaskID from a previous init()/shutdown() cycle (the
    # ContextVar is module-level and outlives the Worker) must not leak
    # into a new job's ObjectID namespace.
    @property
    def current_task_id(self) -> TaskID:
        entry = _current_task_id.get()
        # Auto-created driver entries are invalidated when the job changed
        # (a module-level ContextVar outlives init()/shutdown() cycles);
        # executor-set entries carry their own job and are always valid —
        # the shared self.job_id attr must not leak across concurrent tasks.
        if entry is None or (entry[2] and entry[0] != self.job_id):
            tid = TaskID.for_driver(self.job_id)
            _current_task_id.set((self.job_id, tid, True))
            return tid
        return entry[1]

    def set_task_context(self, task_id: TaskID, job_id: Optional[JobID] = None) -> None:
        _current_task_id.set((job_id or self.job_id, task_id, False))

    # ---- refcounting hooks --------------------------------------------
    def _on_ref_created(self, ref: ObjectRef) -> None:
        try:
            self.backend.add_local_ref(ref)
        except Exception:
            pass

    def _on_ref_deleted(self, ref: ObjectRef) -> None:
        try:
            self.backend.remove_local_ref(ref)
        except Exception:
            pass

    def _on_ref_borrowed(self, ref: ObjectRef) -> None:
        try:
            self.backend.register_borrow(ref)
        except Exception:
            pass

    # ---- object API ----------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("calling put on an ObjectRef is not allowed")
        with self._lock:
            self._put_counter += 1
            idx = self._put_counter
        object_id = ObjectID.for_put(self.current_task_id, idx)
        ser = serialization.serialize(value)
        self.backend.put_object(object_id, ser)
        ref = ObjectRef(object_id, self.address)
        self.backend.release_hold([object_id])
        return ref

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("get() expects an ObjectRef or a list of ObjectRefs")
        # ambient Deadline (core/deadline.py): the tighter of the explicit
        # timeout and the caller's remaining budget wins — a timeout=None
        # get inside a deadline scope cannot park past the budget
        from ray_tpu_torch.core.deadline import effective_timeout

        values = self.backend.get_objects(refs, effective_timeout(timeout))
        out = []
        for v in values:
            if isinstance(v, Exception):
                raise v
            out.append(v)
        return out[0] if single else out

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        if len(set(refs)) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        if num_returns <= 0 or num_returns > len(refs):
            raise ValueError(f"num_returns must be in [1, {len(refs)}]")
        from ray_tpu_torch.core.deadline import effective_timeout

        return self.backend.wait(
            list(refs), num_returns, effective_timeout(timeout), fetch_local
        )

    # ---- task submission ----------------------------------------------
    def _serialize_args(self, args, kwargs):
        """Inline small args; implicit-put large ones (reference
        DependencyResolver inlining)."""
        threshold = GLOBAL_CONFIG.max_direct_call_object_size
        sargs = []
        for a in args:
            if isinstance(a, ObjectRef):
                sargs.append(("ref", a))
                continue
            if callable(a):
                serialization.ensure_importable_or_by_value(a)
            ser = serialization.serialize(a)
            if ser.total_bytes <= threshold and not ser.contained_refs:
                sargs.append(("val", ser.to_bytes()))
            else:
                ref = self._put_serialized(ser)
                sargs.append(("ref", ref))
        skwargs = []
        for k, a in (kwargs or {}).items():
            if isinstance(a, ObjectRef):
                skwargs.append(("ref", k, a))
                continue
            if callable(a):
                serialization.ensure_importable_or_by_value(a)
            ser = serialization.serialize(a)
            if ser.total_bytes <= threshold and not ser.contained_refs:
                skwargs.append(("val", k, ser.to_bytes()))
            else:
                ref = self._put_serialized(ser)
                skwargs.append(("ref", k, ref))
        return sargs, skwargs

    def _put_serialized(self, ser: serialization.SerializedValue) -> ObjectRef:
        with self._lock:
            self._put_counter += 1
            idx = self._put_counter
        object_id = ObjectID.for_put(self.current_task_id, idx)
        self.backend.put_object(object_id, ser)
        ref = ObjectRef(object_id, self.address)
        self.backend.release_hold([object_id])
        return ref

    def new_task_id(self) -> TaskID:
        return TaskID.for_task(ActorID.nil_for_job(self.job_id))

    def make_task_spec(
        self,
        kind: TaskKind,
        function_obj: Any,
        name: str,
        args,
        kwargs,
        opts: TaskOptions,
        *,
        actor_id: Optional[ActorID] = None,
        method_name: Optional[str] = None,
        default_cpus: float = 1.0,
    ) -> TaskSpec:
        function_id = self.fn_table.export(function_obj)
        task_id = self.new_task_id()
        sargs, skwargs = self._serialize_args(args, kwargs)
        num_returns = opts.num_returns if opts.num_returns is not None else 1
        if isinstance(num_returns, int):
            return_ids = [ObjectID.from_index(task_id, i + 1) for i in range(num_returns)]
        elif num_returns == "streaming":
            if kind not in (TaskKind.NORMAL, TaskKind.ACTOR_TASK):
                raise ValueError(
                    'num_returns="streaming" is only supported on tasks '
                    "and actor methods"
                )
            return_ids = []  # item ids are generated as the task yields
        else:
            return_ids = [ObjectID.from_index(task_id, 1)]
        max_retries = (
            opts.max_retries
            if opts.max_retries is not None
            else (GLOBAL_CONFIG.task_max_retries if kind == TaskKind.NORMAL else 0)
        )
        runtime_env = opts.runtime_env
        if runtime_env:
            from ray_tpu_torch.runtime_env import validate_runtime_env

            validate_runtime_env(runtime_env)  # fail at submit, not on-worker
        if runtime_env and any(
            k in runtime_env for k in ("working_dir", "py_modules")
        ):
            # ship code at submission: zip -> content-addressed KV upload;
            # workers extract per hash (runtime_env/packaging.py). The
            # driver-side cache keys on path + a tree mtime/size signature
            # so EDITING the directory re-ships it (path-only keying
            # would silently pin the first upload for the driver's life).
            from ray_tpu_torch.runtime_env import package_runtime_env

            key = tuple(sorted(
                (k, str(v), _tree_signature(v))
                for k, v in runtime_env.items()
            ))
            packaged = self._packaged_envs.get(key)
            if packaged is None:
                packaged = package_runtime_env(
                    runtime_env, self.backend.kv_put, self.backend.kv_get
                )
                self._packaged_envs[key] = packaged
            runtime_env = packaged
        if num_returns == "streaming":
            # re-executing a partially-consumed stream has replay
            # semantics this build doesn't implement — no retries
            max_retries = 0
        from ray_tpu_torch.core.deadline import remaining as _deadline_remaining

        return TaskSpec(
            kind=kind,
            task_id=task_id,
            job_id=self.job_id,
            name=name,
            function_id=function_id,
            args=sargs,
            kwargs=skwargs,
            num_returns=num_returns,
            return_ids=return_ids,
            resources=opts.resource_request(default_cpus).to_dict(),
            scheduling_strategy=opts.scheduling_strategy,
            owner=self.address,
            max_retries=max_retries,
            retry_exceptions=opts.retry_exceptions,
            runtime_env=runtime_env,
            deadline_remaining_s=_deadline_remaining(),
            actor_id=actor_id,
            max_restarts=opts.max_restarts,
            max_task_retries=opts.max_task_retries,
            max_concurrency=opts.max_concurrency or 1,
            concurrency_groups=dict(opts.concurrency_groups),
            actor_name=opts.name if kind == TaskKind.ACTOR_CREATION else None,
            namespace=opts.namespace or self.namespace,
            lifetime=opts.lifetime,
            method_name=method_name,
        )

    # ---- cached task-spec templates (submit fast path) -----------------
    def make_spec_template(
        self,
        kind: TaskKind,
        function_obj: Any,
        name: str,
        opts: TaskOptions,
        *,
        actor_id: Optional[ActorID] = None,
        method_name: Optional[str] = None,
        default_cpus: float = 1.0,
        max_concurrency: int = 1,
        concurrency_group: Optional[str] = None,
    ) -> Optional[SpecTemplate]:
        """Capture the invariant spec fields of one remote function /
        actor method ONCE (reference: cached serialized task-spec
        prefix). Returns None for shapes the fast path doesn't cover
        (streaming/dynamic returns, runtime_env — its packaging is
        re-signatured per submit)."""
        num_returns = opts.num_returns if opts.num_returns is not None else 1
        if not isinstance(num_returns, int) or opts.runtime_env:
            return None
        max_retries = (
            opts.max_retries
            if opts.max_retries is not None
            else (GLOBAL_CONFIG.task_max_retries if kind == TaskKind.NORMAL else 0)
        )
        return self.tmpl_table.register(
            dict(
                kind=kind,
                name=name,
                function_id=self.fn_table.export(function_obj),
                num_returns=num_returns,
                resources=opts.resource_request(default_cpus).to_dict(),
                scheduling_strategy=opts.scheduling_strategy,
                owner=self.address,
                job_id=self.job_id,
                max_retries=max_retries,
                retry_exceptions=opts.retry_exceptions,
                runtime_env=None,
                actor_id=actor_id,
                method_name=method_name,
                max_concurrency=max_concurrency,
                concurrency_group=concurrency_group,
            )
        )

    def template_current(self, tmpl: Optional[SpecTemplate]) -> bool:
        """A cached template is reusable only while its captured process
        identity holds (job and owner address change across init cycles
        and across tasks on a reused worker)."""
        return (
            tmpl is not None
            and tmpl.job_id == self.job_id
            and tmpl.owner is self.address
        )

    def submit_from_template(self, tmpl: SpecTemplate, args, kwargs, next_seq=None):
        """Hot-path submit: splice per-call fields into a cached template
        — no TaskOptions merging, resource normalization, or descriptor
        re-export per call. ``next_seq`` (an actor handle's) takes the
        call's turn only once its arguments are serialized: a call that
        fails there, or that a signal cuts there, leaves no hole in the
        caller's order for every later call to wait on."""
        from ray_tpu_torch.core.deadline import remaining as _deadline_remaining

        task_id = self.new_task_id()
        sargs, skwargs = self._serialize_args(args, kwargs)
        seq_no = next_seq() if next_seq is not None else 0
        return_ids = [
            ObjectID.from_index(task_id, i + 1) for i in range(tmpl.num_returns)
        ]
        spec = tmpl.instantiate(
            task_id, sargs, skwargs, return_ids, _deadline_remaining(), seq_no
        )
        if tmpl.kind == TaskKind.ACTOR_TASK:
            self.backend.submit_actor_task(spec)
        else:
            self.backend.submit_task(spec)
        refs = [ObjectRef(oid, self.address) for oid in spec.return_ids]
        self.backend.release_hold(spec.return_ids)
        if tmpl.num_returns == 0:
            return None
        return refs[0] if tmpl.num_returns == 1 else refs

    def submit_task(self, function_obj, name, args, kwargs, opts: TaskOptions):
        spec = self.make_task_spec(TaskKind.NORMAL, function_obj, name, args, kwargs, opts)
        if spec.num_returns == "streaming":
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            self.backend.create_stream(spec)
            self.backend.submit_task(spec)
            return ObjectRefGenerator(
                self.backend, spec.task_id.binary(), self.address
            )
        self.backend.submit_task(spec)
        refs = [ObjectRef(oid, self.address) for oid in spec.return_ids]
        self.backend.release_hold(spec.return_ids)
        if spec.num_returns == 0:
            return None
        if spec.num_returns == 1:
            return refs[0]
        return refs

    # ---- futures -------------------------------------------------------
    def to_future(self, ref: ObjectRef):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self.get(ref))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    async def await_ref(self, ref: ObjectRef):
        import asyncio

        return await asyncio.wrap_future(self.to_future(ref))

    def shutdown(self) -> None:
        set_refcount_hooks(None, None, None)
        self.backend.shutdown()


_current_task_id: contextvars.ContextVar[Optional[Tuple[JobID, TaskID]]] = (
    contextvars.ContextVar("ray_tpu_current_task_id", default=None)
)


# --- global worker singleton -------------------------------------------

_worker: Optional[Worker] = None
_worker_lock = threading.Lock()


def _global_worker() -> Worker:
    if _worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _worker


def get_global_worker_or_none() -> Optional[Worker]:
    return _worker


def is_initialized() -> bool:
    return _worker is not None


def set_global_worker(worker: Optional[Worker]) -> None:
    global _worker
    _worker = worker


#: (path -> (computed_at_monotonic, sig)) — every ``.remote()`` carrying
#: a working_dir/py_modules runtime_env asks for the tree signature; a
#: stat-walk of the whole directory per SUBMIT is the dominant cost of
#: runtime_env task loops. Within the TTL the cached signature answers
#: instead; an edit is still re-shipped at most ``tree_signature_ttl_s``
#: late (the reference accepts the same staleness in its working_dir
#: upload cache). TTL 0 disables caching (tests / paranoid callers).
_tree_sig_cache: Dict[str, Tuple[float, int]] = {}


def _tree_signature(value) -> int:
    """Cheap change signature for runtime_env path values: hash of every
    file's (relpath, mtime_ns, size), cached per path for a short TTL.
    Non-path values signature as 0."""
    paths = value if isinstance(value, (list, tuple)) else [value]
    ttl = GLOBAL_CONFIG.tree_signature_ttl_s
    now = time.monotonic()
    sig = 0
    for p in paths:
        if not isinstance(p, str) or not os.path.exists(p):
            continue
        if ttl > 0:
            cached = _tree_sig_cache.get(p)
            if cached is not None and now - cached[0] < ttl:
                sig = hash((sig, cached[1]))
                continue
        psig = _stat_walk_signature(p)
        if ttl > 0:
            _tree_sig_cache[p] = (now, psig)
        sig = hash((sig, psig))
    return sig


def _stat_walk_signature(p: str) -> int:
    sig = 0
    if os.path.isfile(p):
        st = os.stat(p)
        return hash((p, st.st_mtime_ns, st.st_size))
    for root, dirs, files in os.walk(p):
        dirs.sort()
        for f in sorted(files):
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:
                continue
            sig = hash((sig, os.path.join(root, f), st.st_mtime_ns, st.st_size))
    return sig


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    local_mode: bool = False,
    namespace: Optional[str] = None,
    object_store_memory: Optional[int] = None,
    system_config: Optional[Dict[str, Any]] = None,
    num_nodes: int = 1,
    ignore_reinit_error: bool = False,
) -> Dict[str, Any]:
    """Start (or connect to) a runtime. Returns context info.

    Reference: ``ray.init`` (``python/ray/_private/worker.py:1262``).
    With no ``address`` a local cluster is started in-process
    (controller + node daemon + workers); ``local_mode=True`` executes
    everything eagerly in the driver process.
    """
    global _worker
    if address is None:
        # job entrypoints get the cluster address injected by their
        # supervisor (reference: RAY_ADDRESS; job/supervisor.py)
        address = os.environ.get("RAY_TPU_ADDRESS") or None
    with _worker_lock:
        if _worker is not None:
            if ignore_reinit_error:
                return {"namespace": _worker.namespace}
            raise RuntimeError("ray_tpu_torch.init() called twice")
        if system_config:
            GLOBAL_CONFIG.apply_system_config(system_config)
        if object_store_memory:
            GLOBAL_CONFIG.object_store_memory_bytes = object_store_memory
        import uuid

        ns = namespace or uuid.uuid4().hex[:12]
        job_id = JobID.from_random()
        if local_mode:
            from ray_tpu_torch.core.local_backend import LocalBackend

            backend = LocalBackend(num_cpus=num_cpus or 8, resources=resources)
            _worker = Worker(Worker.MODE_LOCAL, backend, job_id, ns)
            backend.bind_worker(_worker)
        elif address is None:
            from ray_tpu_torch.core.cluster_backend import ClusterBackend

            backend = ClusterBackend.start_cluster(
                num_cpus=num_cpus, resources=resources, num_nodes=num_nodes
            )
            _worker = Worker(Worker.MODE_DRIVER, backend, job_id, ns)
            backend.bind_worker(_worker)
        else:
            from ray_tpu_torch.core.cluster_backend import ClusterBackend

            backend = ClusterBackend.connect(address)
            _worker = Worker(Worker.MODE_DRIVER, backend, job_id, ns)
            backend.bind_worker(_worker)
        atexit.register(shutdown)
        return {"namespace": ns, "job_id": job_id.hex()}


def shutdown() -> None:
    global _worker
    with _worker_lock:
        if _worker is None:
            return
        try:
            _worker.shutdown()
        finally:
            _worker = None
