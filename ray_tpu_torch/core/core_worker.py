"""CoreWorker: the per-process worker library for cluster mode.

Reference: ``src/ray/core_worker/`` — the library linked into every worker
and driver (``core_worker.h:163``): object put/get/wait against the dual
store (in-process memory store + node shm store), normal-task submission
through the raylet lease protocol with spillback
(``transport/normal_task_submitter.h:108``), per-actor ordered submission
with restart handling (``transport/actor_task_submitter``), the execution
callback path (``HandlePushTask``, ``core_worker.cc:3617``), and the
owner services (object status, borrower registration) backing the
ownership model.

One CoreWorker instance implements ``RuntimeBackend``, so drivers and
workers share every code path; workers additionally run a ``TaskExecutor``
(see ``task_executor.py``) behind their ``push_task`` service.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.api import RuntimeBackend
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.controller import (
    ACTOR_PUSH_CHANNEL,
    LOG_PUSH_CHANNEL,
    NODE_PUSH_CHANNEL,
    PG_PUSH_CHANNEL,
)
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    OwnerDiedError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import MemoryStore, StoreClient
from ray_tpu_torch.core.object_store import segment_name as _segment_name
from ray_tpu_torch.core.ownership import ObjState, ReferenceCounter
from ray_tpu_torch.core.refs import Address, ObjectRef
from ray_tpu_torch.core.rpc import (
    ChaosInjectedError,
    ConnectionLost,
    IoThread,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch.core.task_spec import TaskKind, TaskSpec, encode_spec
from ray_tpu_torch.observability import timeline as _timeline
from ray_tpu_torch.observability import tracing as _tracing

logger = logging.getLogger(__name__)


def _loop_event_setter(loop, ev: "asyncio.Event"):
    """Completion callback that sets an asyncio.Event from ANY thread:
    plain set() when already on the target loop (the common case — reply
    processing runs there, and call_soon_threadsafe's self-pipe write is
    a ~1ms syscall under load), threadsafe wakeup otherwise."""

    def cb():
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            ev.set()
        else:
            loop.call_soon_threadsafe(ev.set)

    return cb


class _ClassQueue:
    """Pending normal tasks of one scheduling class + active pump count."""

    __slots__ = ("specs", "pumps", "work")

    def __init__(self):
        import asyncio as _asyncio
        from collections import deque

        self.specs = deque()
        self.pumps = 0
        self.work = _asyncio.Event()  # set on enqueue: wakes lingering pumps


class _ActorState:
    def __init__(self):
        self.state: str = "PENDING"
        self.address: Optional[Address] = None
        self.reason: str = ""
        self.max_task_retries: int = 0
        self.max_concurrency: int = 1
        self.creation_spec = None  # pins implicit-put creation args
        self.event = threading.Event()  # set whenever state changes


class CoreWorker(RuntimeBackend):
    def __init__(
        self,
        controller_host: str,
        controller_port: int,
        daemon_host: str,
        daemon_port: int,
        *,
        io: Optional[IoThread] = None,
        executor=None,  # TaskExecutor for worker processes
    ):
        self.io = io or IoThread()
        self.executor = executor
        self.worker_id = WorkerID.from_random()
        self.memory = MemoryStore()
        self.shm = StoreClient()
        self.refcounter = ReferenceCounter(self._on_free)
        self.node_id: bytes = b""
        self.daemon_addr = (daemon_host, daemon_port)
        self.address: Optional[Address] = None
        self._actors: Dict[ActorID, _ActorState] = {}
        self._actors_lock = threading.Lock()
        #: highest controller incarnation epoch seen on state pushes —
        #: pushes stamped lower come from a deposed controller racing
        #: its own takeover and are dropped (worker half of fencing)
        self._controller_epoch_seen = 0
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._pg_states: Dict[bytes, str] = {}
        self._pg_events: Dict[bytes, threading.Event] = {}
        self._actor_queues: Dict[ActorID, Any] = {}
        self._pump_tasks: List[Any] = []
        self._stopping = False
        # cancellation state (``CoreWorker::CancelTask``): task ids marked
        # cancelled + where each inflight normal task currently executes.
        # Bounded FIFO: cancels of actor tasks / already-freed refs have no
        # finalize path to reclaim their entries.
        self._cancelled_tasks: "OrderedDict[bytes, None]" = OrderedDict()
        self._inflight_workers: Dict[bytes, Tuple[str, int]] = {}
        # lease-reuse submission (per scheduling class)
        self._class_queues: Dict[Any, "_ClassQueue"] = {}
        self._retries_left: Dict[bytes, int] = {}
        # submit batching: specs buffer on the caller thread and drain in
        # one loop callback — call_soon_threadsafe once per burst instead
        # of run_coroutine_threadsafe (a new Task) per task.
        self._submit_buf: List[Tuple[bool, TaskSpec]] = []
        self._submit_lock = threading.Lock()
        self._submit_scheduled = False
        # streaming generators (``task_manager.h:102`` ObjectRefStream).
        # Locked: item pushes land on the io loop while abandon runs on
        # the consumer/GC thread — an unordered pop could leak the hold
        # created for an in-flight item. Re-entrant: a collection that
        # runs while a thread holds it may finalise a dropped generator,
        # whose __del__ abandons its stream on that same thread.
        self._streams: Dict[bytes, Any] = {}
        self._streams_lock = threading.RLock()
        # node membership/drain event listeners (Train drain watch etc.)
        self._node_event_listeners: List[Any] = []
        # nodes the controller has pushed as dead: fetches skip these
        # sources and go straight to the relocation directory instead of
        # burning the chunk-retry ladder against a corpse
        self._dead_nodes: set = set()
        # borrowed refs observed ready via a status RPC: lets a
        # wait(timeout=0) poll answer from cache instead of paying the
        # borrowed-status grace window every call (bounded FIFO)
        self._borrowed_ready: "OrderedDict[bytes, None]" = OrderedDict()
        # executor-side cache of task-spec templates (template_id →
        # SpecTemplate): pushes carry (template_id, per-call fields);
        # the full invariant prefix is fetched from the KV once
        self._tmpl_cache: Dict[bytes, Any] = {}
        # task-event buffer (``core_worker/task_event_buffer`` →
        # ``GcsTaskManager``): batched lifecycle events for `list tasks`.
        # Locked: emitters run on lane/user threads, the flusher swaps the
        # list on the io loop — an unguarded append could land on an
        # already-sent list and silently vanish.
        self._task_events: List[Dict[str, Any]] = []
        self._task_events_lock = threading.Lock()
        self._task_events_flushing = False
        # blocked-worker resource release (satellite of the zero-copy
        # data plane PR; reference NotifyDirectCallTaskBlocked): worker
        # processes tell their daemon when a get is about to PARK so the
        # daemon can lend the held CPUs out, and again on wake. Depth-
        # counted — concurrent lane threads blocking notify once.
        self._spawn_token = (
            os.environ.get("RAY_TPU_SPAWN_TOKEN", "") if executor is not None else ""
        )
        self._blocked_depth = 0
        self._blocked_lock = threading.Lock()

        async def _setup():
            self.server = RpcServer()
            for name in [m for m in dir(self) if m.startswith("w_")]:
                self.server.register(name[2:], getattr(self, name))
            port = await self.server.start()
            # retry-by-default toward the control plane: mutating calls
            # are dedup-stamped (core/rpc.py), so a controller restart or
            # a lost reply is a transparent retry, never a duplicate
            self.controller = RpcClient(
                controller_host, controller_port, name="controller",
                default_retries=GLOBAL_CONFIG.rpc_max_retries,
                role="controller",
            )
            self.daemon = RpcClient(
                daemon_host, daemon_port, name="noded", role="noded"
            )
            self.controller.subscribe_push(ACTOR_PUSH_CHANNEL, self._on_actor_push)
            self.controller.subscribe_push(PG_PUSH_CHANNEL, self._on_pg_push)
            self.controller.subscribe_push(NODE_PUSH_CHANNEL, self._on_node_push)
            channels = [ACTOR_PUSH_CHANNEL, PG_PUSH_CHANNEL, NODE_PUSH_CHANNEL]
            if executor is None and GLOBAL_CONFIG.log_to_driver:
                # drivers print forwarded worker logs (reference
                # LogMonitor → pubsub → driver stdout); workers never
                # subscribe the log channel, so the controller doesn't
                # waste pushes on processes that would drop them
                self.controller.subscribe_push(LOG_PUSH_CHANNEL, self._on_log_push)
                channels.append(LOG_PUSH_CHANNEL)
            # push subscriptions are per-connection server-side: a
            # controller restart silently drops them, so re-subscribe on
            # every reconnect (reconnect-and-reconcile)
            self._push_channels = channels
            self.controller.on_reconnect = self._on_controller_reconnect
            await self.controller.call(
                "subscribe",
                {"channels": channels},
                retries=GLOBAL_CONFIG.rpc_max_retries,
            )
            return port

        self.port = self.io.run(_setup())
        self.host = "127.0.0.1"

    async def _on_controller_reconnect(self) -> None:
        """The controller connection was re-established (restart or
        transient reset): re-subscribe push channels — server-side
        subscription state died with the old connection."""
        from ray_tpu_torch.observability.rpc_metrics import CONTROLLER_RECONNECTS

        CONTROLLER_RECONNECTS.inc(
            labels={"role": "worker" if self.executor is not None else "driver"}
        )
        if self._stopping:
            return
        await self.controller.call(
            "subscribe",
            {"channels": self._push_channels},
            retries=GLOBAL_CONFIG.rpc_max_retries,
        )

    def finish_init(self, node_id: bytes) -> None:
        self.node_id = node_id
        self.address = Address(
            worker_id=self.worker_id.binary(),
            node_id=node_id,
            host=self.host,
            port=self.port,
        )

    # ------------------------------------------------------------------
    # client cache
    def _client(self, host: str, port: int, role: Optional[str] = None) -> RpcClient:
        """Cached peer client. ``role`` tags the SERVER's role for the
        per-role idempotent-method classification (core/rpc.py) — one
        address is one server, so a later tagged lookup may upgrade an
        untagged cache entry, never flip an existing tag."""
        key = (host, port)
        c = self._clients.get(key)
        if c is None:
            c = self._clients[key] = RpcClient(
                host, port, name=f"peer-{port}", role=role
            )
            # stream items ride back over the submission connection
            from ray_tpu_torch.core.streaming import STREAM_PUSH_CHANNEL

            c.subscribe_push(STREAM_PUSH_CHANNEL, self._on_stream_item)
        elif c.role is None and role is not None:
            c.role = role
        return c

    def _owner_client(self, ref: ObjectRef) -> RpcClient:
        addr = ref.owner_address
        if addr is None:
            raise OwnerDiedError(ref.id(), "ref has no owner address")
        return self._client(addr.host, addr.port, role="worker")

    # ------------------------------------------------------------------
    # objects: put
    def put_object(self, object_id: ObjectID, ser: serialization.SerializedValue) -> None:
        if ser.total_bytes <= GLOBAL_CONFIG.max_direct_call_object_size:
            data = ser.to_bytes()
            self.memory.put(object_id, data)
            self.refcounter.create_inline(
                object_id, data, contained=ser.contained_refs, hold=True
            )
        else:
            size = self.shm.create_and_write(object_id, ser)
            self.io.run(self.daemon.call("adopt_object", {"object_id": object_id.binary(), "size": size}))
            self.refcounter.create_at_location(
                object_id, self._self_location(), contained=ser.contained_refs, hold=True
            )

    def _self_location(self) -> tuple:
        return (self.node_id, self.daemon_addr[0], self.daemon_addr[1])

    # ------------------------------------------------------------------
    # objects: get
    def get_objects(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        # Tracing wrapper: a get() on a traced result (or inside a traced
        # task) records a "get" span closing the submit → execute →
        # result-push → get chain. The unsampled hot path pays one float
        # compare + one contextvar read and goes straight to the inner
        # body — no lineage lookup, no timestamping.
        if GLOBAL_CONFIG.trace_sample_rate <= 0.0 and _tracing.current() is None:
            return self._get_objects_inner(refs, timeout)
        wire = _tracing.current_wire()
        if wire is None and refs:
            obj = self.refcounter.get(refs[0].id())
            lineage = getattr(obj, "lineage", None)
            wire = getattr(lineage, "trace_ctx", None)
        if wire is None:
            return self._get_objects_inner(refs, timeout)
        t0_us = _timeline._now_us()
        try:
            return self._get_objects_inner(refs, timeout)
        finally:
            _tracing.record_span(
                wire, f"get::{len(refs)}", t0_us, _timeline._now_us(),
                category="task",
            )

    def _worker_blocked_scope(self):
        """Context manager bracketing a blocking wait inside a WORKER
        process: on entry (outermost only) the daemon releases the CPU
        share of this worker's lease so other tasks — e.g. the producer
        this get waits on — can run; on exit it re-acquires. No-op for
        drivers and when disabled. Notification loss is safe: the daemon
        self-heals accounting at lease release."""
        import contextlib

        if not self._spawn_token or not GLOBAL_CONFIG.blocked_worker_resource_release:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def scope():
            with self._blocked_lock:
                self._blocked_depth += 1
                notify = self._blocked_depth == 1
            if notify:
                self._notify_daemon_blocked("worker_blocked")
            try:
                yield
            finally:
                with self._blocked_lock:
                    self._blocked_depth -= 1
                    notify = self._blocked_depth == 0
                if notify:
                    self._notify_daemon_blocked("worker_unblocked")

        return scope()

    def _notify_daemon_blocked(self, method: str) -> None:
        try:
            self.io.run(
                self.daemon.call(method, {"token": self._spawn_token}, timeout=5),
                timeout=10,
            )
        except Exception:
            logger.debug("%s notification failed", method, exc_info=True)

    def _get_objects_inner(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        # Sync fast path for owned refs: resolve on the CALLING thread —
        # in-process cache hits return immediately, pending results park
        # on the ownership table's threading waiters. The io loop stays
        # free to process completions (it paid ~70µs of task/event/timer
        # machinery per ref in the async path, plus two cross-thread
        # wakeups per get() call). Borrowed refs and shm-resident values
        # drop to the async path (owner RPCs / store fetches live there).
        out: List[Any] = []
        for i, r in enumerate(refs):
            oid = r.id()
            data = self.memory.get(oid)
            if data is not None:
                out.append(serialization.deserialize_bytes(data))
                continue
            if not self.refcounter.owns(oid):
                break  # borrowed: async path handles the owner protocol
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            obj = self.refcounter.get(oid)
            if obj is not None and obj.ready():
                pass  # no park coming: skip the blocked notification
            else:
                # about to PARK this worker thread: lend the held CPUs
                # out for the duration (deadlock defense — the producer
                # we wait on may need them)
                with self._worker_blocked_scope():
                    obj = self.refcounter.wait_ready(oid, remaining)
            if obj is None or not obj.ready():
                raise GetTimeoutError(f"get() timed out waiting for {oid.hex()[:12]}")
            if obj.state == ObjState.FAILED:
                out.append(obj.error)
            elif obj.inline is not None:
                out.append(serialization.deserialize_bytes(obj.inline))
            else:
                # shm-resident result: hand this ref AND the rest to the
                # async path so node-to-node fetches (and any lineage
                # recovery) overlap instead of running serially here
                break
        else:
            return out
        rest = list(refs[i:])

        async def _get_all():
            return await asyncio.gather(*[self._get_one(r, deadline) for r in rest])

        # the async path may fetch across nodes / wait on borrowed
        # owners: treat it as a potential park (the lend/re-acquire pair
        # costs two sub-ms daemon RPCs, noise next to any real fetch)
        with self._worker_blocked_scope():
            return out + self.io.run(_get_all())

    async def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id()
        data = self.memory.get(oid)
        if data is not None:
            return serialization.deserialize_bytes(data)
        if self.refcounter.owns(oid):
            return await self._get_owned(ref, deadline)
        return await self._get_borrowed(ref, deadline)

    async def _await_owned_ready(self, oid: ObjectID, deadline: Optional[float]):
        """Event-driven completion wait on the io loop — no executor-thread
        dispatch per ref (a 200-ref get would otherwise pay 200 thread
        round-trips)."""
        obj = self.refcounter.get(oid)
        if obj is not None and obj.ready():
            return obj
        loop = asyncio.get_event_loop()
        ev = asyncio.Event()
        cb = _loop_event_setter(loop, ev)
        if not self.refcounter.on_ready(oid, cb):
            try:
                timeout = (
                    None if deadline is None else max(0.0, deadline - time.monotonic())
                )
                await asyncio.wait_for(ev.wait(), timeout)
            except (asyncio.TimeoutError, TimeoutError):
                pass
            finally:
                self.refcounter.remove_ready_callback(oid, cb)
        return self.refcounter.get(oid)

    async def _get_owned(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id()
        while True:
            obj = await self._await_owned_ready(oid, deadline)
            if obj is None or not obj.ready():
                raise GetTimeoutError(f"get() timed out waiting for {oid.hex()[:12]}")
            if obj.state == ObjState.FAILED:
                return obj.error
            if obj.inline is not None:
                return serialization.deserialize_bytes(obj.inline)
            locations = list(obj.locations)
            try:
                return await self._fetch_from_locations(oid, locations, deadline)
            except ObjectLostError:
                # Every copy is gone (node death): reconstruct from lineage
                # by resubmitting the producing task, then wait again. The
                # observed set guards against destroying a copy created by
                # a recovery that completed while we were fetching.
                if not self._try_recover(oid, observed_locations=locations):
                    raise

    async def _get_borrowed(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id()
        owner = self._owner_client(ref)
        while True:
            step = 30.0
            if deadline is not None:
                step = min(step, max(0.0, deadline - time.monotonic()))
            try:
                status = await owner.call(
                    "get_object_status",
                    {"object_id": oid.binary(), "timeout": step},
                    timeout=step + 10,
                )
            except ConnectionLost:
                raise OwnerDiedError(oid, "owner process is gone")
            kind = status["status"]
            if kind == "inline":
                data = status["data"]
                self.memory.put(oid, data)  # borrower-side cache
                return serialization.deserialize_bytes(data)
            if kind == "locations":
                try:
                    return await self._fetch_from_locations(oid, status["locations"], deadline)
                except ObjectLostError:
                    # Ask the owner to reconstruct, then re-poll status.
                    try:
                        recovered = await owner.call(
                            "recover_object",
                            {"object_id": oid.binary(), "observed": status["locations"]},
                            timeout=30,
                        )
                    except ConnectionLost:
                        raise OwnerDiedError(oid, "owner died during recovery")
                    if not recovered:
                        raise
                    continue
            if kind == "error":
                return pickle.loads(status["error"])
            if kind == "unknown":
                raise ObjectLostError(oid, "owner does not know this object (freed?)")
            # pending → loop unless out of time
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(f"get() timed out waiting for {oid.hex()[:12]}")

    @staticmethod
    def _parse_pull_reply(reply):
        """Split a ``pull_object`` reply into (meta, failure): success is
        the ``{"segment", "size"}`` meta; a structured failure carries
        ``no_source`` + per-source ``causes`` (see core/pull_manager.py).
        A bare None (legacy daemon) maps to an empty failure."""
        if reply is None:
            return None, {"failed": True, "no_source": True, "causes": {}}
        if isinstance(reply, dict) and reply.get("failed"):
            return None, reply
        return reply, None

    async def _fetch_from_locations(self, oid: ObjectID, locations, deadline) -> Any:
        """Materialize a shm object locally, then zero-copy deserialize."""
        from ray_tpu_torch.core.deadline import effective_timeout

        if not locations:
            raise ObjectLostError(oid, "no locations")
        local = next((l for l in locations if l[0] == self.node_id), None)
        if local is not None:
            meta = await self.daemon.call("get_object_meta", {"object_id": oid.binary()})
        else:
            meta = None
        failure = None
        skipped_dead_sources = False
        if meta is None:
            sources = [(h, p) for (_nid, h, p) in locations if _nid != self.node_id]
            live = [
                (h, p)
                for (_nid, h, p) in locations
                if _nid != self.node_id and _nid not in self._dead_nodes
            ]
            skipped_dead_sources = len(live) < len(sources)
            if sources and not live:
                # every remote holder is controller-confirmed DEAD: a pull
                # would only burn its chunk-retry ladder against corpses.
                # Skip straight to the relocation consult (drained nodes
                # replicate primaries away before exiting); if the
                # directory has nothing we still try the stale sources
                # below, so a spurious dead-marking can't lose an object.
                failure = {"failed": True, "no_source": True, "causes": {}}
            else:
                # the pull inherits this get()'s remaining budget (nested
                # gets propagate deadlines through the whole fetch path —
                # a hard-coded 300 here used to quietly extend the caller's)
                budget = effective_timeout(300.0)
                reply = await self.daemon.call(
                    "pull_object",
                    {"object_id": oid.binary(), "sources": live, "deadline_s": budget},
                    timeout=budget,
                )
                meta, failure = self._parse_pull_reply(reply)
                if meta is None and failure.get("deadline"):
                    # the transfer ran out of THIS caller's budget, with
                    # live sources: that is a timeout, not object loss —
                    # lineage reconstruction / relocation fallback would
                    # be wrong
                    raise GetTimeoutError(
                        f"fetch of {oid.hex()[:12]} ran out of budget "
                        f"mid-transfer ({failure.get('causes')})"
                    )
        if meta is None:
            # Stale locations can mean the holding node DRAINED and
            # replicated its copies away — consult the controller's
            # relocation directory before declaring the object lost
            # (lineage reconstruction re-runs the producing task; a
            # relocated copy costs one more pull).
            moved = await self._fetch_relocated(oid)
            if moved is not None:
                meta = moved
        if meta is None and skipped_dead_sources:
            # relocation directory had nothing and we never actually tried
            # the (dead-marked) sources: try them now rather than declare
            # loss on the strength of a push alone
            budget = effective_timeout(300.0)
            reply = await self.daemon.call(
                "pull_object",
                {
                    "object_id": oid.binary(),
                    "sources": [
                        (h, p) for (_nid, h, p) in locations if _nid != self.node_id
                    ],
                    "deadline_s": budget,
                },
                timeout=budget,
            )
            meta, failure = self._parse_pull_reply(reply)
            if meta is None and failure.get("deadline"):
                raise GetTimeoutError(
                    f"fetch of {oid.hex()[:12]} ran out of budget mid-transfer "
                    f"({failure.get('causes')})"
                )
        if meta is None:
            # ONE owner-side line for the whole fetch attempt: the
            # structured causes say which sources were missing the object
            # vs which transfers failed (the pull manager already logged
            # its own single summary daemon-side)
            causes = (failure or {}).get("causes", {})
            detail = (
                "no source holds the object"
                if (failure or {}).get("no_source")
                else "every transfer failed"
            )
            logger.warning(
                "fetch of %s from %d location(s) failed (%s): %s",
                oid.hex()[:12], len(locations), detail, causes,
            )
            raise ObjectLostError(
                oid, f"could not fetch from {locations} ({detail}: {causes})"
            )
        buf = self.shm.read(oid, meta["size"])
        value = serialization.deserialize_bytes(buf)
        if self.refcounter.owns(oid):
            self.refcounter.add_location(oid, self._self_location())
        return value

    async def _fetch_relocated(self, oid: ObjectID):
        """Drain-relocation fallback: ask the controller where a drained
        node replicated this object, pull from there. Returns local shm
        meta or None. Updates the owner's location set so later readers
        skip the detour."""
        from ray_tpu_torch.core.deadline import effective_timeout

        try:
            loc = await self.controller.call(
                "get_relocated", {"object_id": oid.binary()}, timeout=10
            )
        except Exception:
            return None
        if loc is None:
            return None
        budget = effective_timeout(300.0)
        reply = await self.daemon.call(
            "pull_object",
            {
                "object_id": oid.binary(),
                "sources": [(loc["host"], loc["port"])],
                "deadline_s": budget,
            },
            timeout=budget,
        )
        meta, _failure = self._parse_pull_reply(reply)
        if meta is not None and self.refcounter.owns(oid):
            self.refcounter.add_location(
                oid, (loc["node_id"], loc["host"], loc["port"])
            )
        return meta

    # ------------------------------------------------------------------
    # wait — event-driven (reference ``raylet/wait_manager.h:25``): owned
    # refs complete via ownership-table callbacks (no RPC, no polling);
    # borrowed refs long-poll their owner's blocking get_object_status
    # once instead of one RPC per 5ms tick per ref.
    def wait(self, refs, num_returns, timeout, fetch_local):
        deadline = None if timeout is None else time.monotonic() + timeout

        async def _wait_all():
            done = [False] * len(refs)

            async def one(i: int, r: ObjectRef) -> None:
                await self._wait_ready(r, deadline)
                done[i] = True

            tasks = [asyncio.ensure_future(one(i, r)) for i, r in enumerate(refs)]
            try:
                # One immediate pass first: timeout=0 must still observe
                # refs that are already ready. Owned refs resolve without
                # suspending; borrowed refs need one status round-trip to
                # the owner, so grant them a short window — otherwise a
                # timeout=0 poll loop would NEVER see a ready borrowed ref.
                borrowed = any(
                    not self.refcounter.owns(r.id())
                    and not self.memory.contains(r.id())
                    and r.id().binary() not in self._borrowed_ready
                    for r in refs
                )
                expired = deadline is not None and time.monotonic() >= deadline
                if borrowed and expired:
                    # grant borrowed refs one status round-trip, but stop
                    # the moment num_returns is satisfied (an ALL_COMPLETED
                    # wait would burn the whole window even when an owned
                    # ref is already ready)
                    end = time.monotonic() + 0.2
                    while sum(done) < num_returns:
                        pend = [t for t in tasks if not t.done()]
                        left = end - time.monotonic()
                        if not pend or left <= 0:
                            break
                        await asyncio.wait(
                            pend,
                            timeout=left,
                            return_when=asyncio.FIRST_COMPLETED,
                        )
                else:
                    await asyncio.wait(tasks, timeout=0)
                while True:
                    if sum(done) >= num_returns:
                        break
                    pending = [t for t in tasks if not t.done()]
                    if not pending:
                        break
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        break
                    await asyncio.wait(
                        pending,
                        return_when=asyncio.FIRST_COMPLETED,
                        timeout=remaining,
                    )
            finally:
                for t in tasks:
                    if not t.done():
                        t.cancel()
            ready = [r for i, r in enumerate(refs) if done[i]]
            not_ready = [r for i, r in enumerate(refs) if not done[i]]
            return ready, not_ready

        ready, not_ready = self.io.run(_wait_all())
        if len(ready) > num_returns:
            not_ready = ready[num_returns:] + not_ready
            ready = ready[:num_returns]
        return ready, not_ready

    async def _wait_ready(self, ref: ObjectRef, deadline: Optional[float]) -> None:
        """Resolve when the ref is ready (or its owner is gone — get()
        surfaces that error)."""
        oid = ref.id()
        if self.memory.contains(oid):
            return
        if oid.binary() in self._borrowed_ready:
            return  # previously observed ready: readiness is monotone
        if self.refcounter.owns(oid):
            loop = asyncio.get_event_loop()
            ev = asyncio.Event()
            cb = _loop_event_setter(loop, ev)
            if self.refcounter.on_ready(oid, cb):
                return
            try:
                await ev.wait()
            finally:
                # timed-out/abandoned waiters must not leave closures
                # accumulating on the object
                self.refcounter.remove_ready_callback(oid, cb)
            return
        # borrowed: one blocking long-poll per step against the owner
        owner = self._owner_client(ref)
        while True:
            step = 30.0
            if deadline is not None:
                step = max(0.0, min(step, deadline - time.monotonic()))
            try:
                status = await owner.call(
                    "get_object_status",
                    {"object_id": oid.binary(), "timeout": step},
                    timeout=step + 10,
                )
            except Exception:
                return  # owner gone → get() will raise; count as "ready"
            if status["status"] in ("inline", "locations", "error", "unknown"):
                # unknown == freed at the owner: get() raises, count ready
                self._borrowed_ready[oid.binary()] = None
                while len(self._borrowed_ready) > 8192:
                    self._borrowed_ready.popitem(last=False)
                return
            if deadline is not None and time.monotonic() >= deadline:
                # caller's deadline: report not-ready by never resolving
                # (the outer asyncio.wait timeout cuts us off)
                await asyncio.sleep(3600)

    # ------------------------------------------------------------------
    # free / refcounting
    def _on_free(self, oid: ObjectID, obj) -> None:
        self.memory.delete(oid)
        created_here = self.shm.has_created(oid)
        recycle_pending = False
        for loc in obj.locations:
            _nid, host, port = loc
            if created_here and _nid == self.node_id:
                # our own segment: ask the daemon whether any reader ever
                # resolved it — if not, the inode goes to the reuse pool
                # (warm pages for the next put) instead of being unlinked
                recycle_pending = True
                self.io.post(self._delete_local_for_recycle(oid))
            else:
                self.io.post(self._delete_remote(host, port, oid))
        if not recycle_pending:
            # covers borrowed refs AND creator-side objects with no local
            # location (e.g. adoption failed): the mapping must not leak
            self.shm.release(oid)

    async def _delete_local_for_recycle(self, oid: ObjectID) -> None:
        try:
            recyclable = await self.daemon.call(
                "delete_object",
                {"object_id": oid.binary(), "allow_recycle": True},
                timeout=10,
            )
        except Exception:
            # Reply lost: the daemon may have granted recycling (entry
            # dropped, file NOT unlinked) — unlink defensively or the
            # segment leaks outside all accounting. The object is freed
            # either way, and a daemon-side _drop of a missing file is a
            # handled no-op.
            self.shm.release(oid)
            try:
                os.unlink("/dev/shm/" + _segment_name(oid))
            except OSError:
                pass
            return
        if recyclable is True:
            self.shm.recycle(oid)
        else:
            self.shm.release(oid)

    async def _delete_remote(self, host, port, oid, timeout: float = 10.0):
        # Bounded: the target node may be dead or partitioned (that's often
        # exactly why a delete is being sent) — never leave the coroutine
        # awaiting a reply forever.
        try:
            await self._client(host, port).call(
                "delete_object", {"object_id": oid.binary()}, timeout=timeout
            )
        except Exception:
            pass

    def free(self, object_ids: Sequence[ObjectID]) -> None:
        for oid in object_ids:
            if self.refcounter.owns(oid):
                self.refcounter.force_free(oid)
            else:
                self.memory.delete(oid)

    def release_hold(self, object_ids) -> None:
        for oid in object_ids:
            self.refcounter.remove_local(oid)

    def add_local_ref(self, ref: ObjectRef) -> None:
        if self.refcounter.owns(ref.id()):
            self.refcounter.add_local(ref.id())

    def remove_local_ref(self, ref: ObjectRef) -> None:
        if self._stopping:
            return
        if self.refcounter.owns(ref.id()):
            self.refcounter.remove_local(ref.id())
        elif ref.owner_address is not None:
            self.io.post(self._send_borrow(ref, "remove_borrower"))

    def register_borrow(self, ref: ObjectRef) -> None:
        if self.refcounter.owns(ref.id()):
            self.refcounter.add_local(ref.id())
        elif ref.owner_address is not None:
            self.io.post(self._send_borrow(ref, "add_borrower"))

    async def _send_borrow(self, ref: ObjectRef, method: str) -> None:
        try:
            await self._owner_client(ref).call(method, {"object_id": ref.binary()})
        except Exception:
            pass

    # ------------------------------------------------------------------
    # normal task submission (lease → push → results)
    def submit_task(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids:
            self.refcounter.create_pending(oid, lineage=spec, hold=True)
        self._pin_deps(spec)
        # tracing: inherit the ambient context or sample a fresh root
        # (no-op + no allocation when unsampled); the stamp rides the
        # per-call wire fields so the executor re-enters it
        _tracing.stamp_spec(spec)
        spec._submit_ts = time.monotonic()  # stage-histogram anchor
        self.emit_task_event(spec, "SUBMITTED")
        self._buffer_submit(False, spec)

    def _buffer_submit(self, is_actor: bool, spec: TaskSpec) -> None:
        with self._submit_lock:
            self._submit_buf.append((is_actor, spec))
            schedule = not self._submit_scheduled
            if schedule:
                self._submit_scheduled = True
        if schedule:
            self.io.loop.call_soon_threadsafe(self._drain_submits)

    def _drain_submits(self) -> None:
        """Runs on the io loop: dispatch every buffered spec. While a
        producer thread is mid-burst, the drain RE-ARMS itself with a
        plain call_soon and keeps ``_submit_scheduled`` set — submits
        landing during the burst skip the cross-thread self-pipe wakeup
        (a ~1ms syscall under load on virtualized kernels), paying it
        once per burst instead of once per task."""
        with self._submit_lock:
            batch, self._submit_buf = self._submit_buf, []
        for is_actor, spec in batch:
            try:
                if is_actor:
                    self._enqueue_actor_task(spec)
                else:
                    self._enqueue_normal(spec)
            except Exception as e:  # noqa: BLE001 — never strand returns
                logger.exception("enqueue failed for %s", spec.name)
                self._fail_returns(
                    spec, e if isinstance(e, RayTpuError) else RayTpuError(repr(e))
                )
        with self._submit_lock:
            if self._submit_buf:
                self.io.loop.call_soon(self._drain_submits)
            else:
                self._submit_scheduled = False

    def _try_recover(self, oid: ObjectID, observed_locations=None) -> bool:
        """Lineage reconstruction (``object_recovery_manager.h:90``): if
        every copy of an owned object is lost, resubmit the producing
        TaskSpec. Recursive losses recover naturally — the re-executed
        task's workers fetch its args through the same get paths, which
        recover *their* losses via this owner. Returns True if a
        reconstruction is running (or already was); the caller re-waits."""
        if not GLOBAL_CONFIG.lineage_pinning_enabled:
            return False
        state, spec, stale = self.refcounter.begin_reconstruction(
            oid,
            GLOBAL_CONFIG.max_lineage_reconstructions,
            observed_locations=observed_locations,
        )
        if state == "pending":
            return True
        if state != "started":
            return False
        logger.info(
            "reconstructing lost object %s by resubmitting task %s",
            oid.hex()[:12],
            spec.name,
        )
        # Best-effort delete of previously-tracked copies: a transiently
        # unreachable node may still hold one, which would otherwise leak
        # (and, for a nondeterministic task, diverge from the new value).
        for ret_id, locations in stale.items():
            for loc in locations:
                _nid, host, port = loc
                self.io.post(self._delete_remote(host, port, ret_id))
        self._pin_deps(spec)
        self.io.loop.call_soon_threadsafe(self._enqueue_normal, spec)
        return True

    def _pin_deps(self, spec: TaskSpec) -> None:
        for ref in spec.dependencies():
            if self.refcounter.owns(ref.id()):
                self.refcounter.add_submitted(ref.id())

    def _unpin_deps(self, spec: TaskSpec) -> None:
        for ref in spec.dependencies():
            if self.refcounter.owns(ref.id()):
                self.refcounter.remove_submitted(ref.id())

    # Lease reuse (reference lease pipelining,
    # ``transport/normal_task_submitter.cc:351``): tasks queue per
    # *scheduling class* (resources + strategy); each class runs up to
    # max_lease_pumps pump coroutines, and a pump holds ONE worker lease,
    # pushing queued task after queued task onto it — the request/return
    # lease round-trips amortize across the whole queue instead of being
    # paid per task.
    def _sched_class_key(self, spec: TaskSpec):
        return (
            tuple(sorted(spec.resources.items())),
            repr(spec.scheduling_strategy),
        )

    def _enqueue_normal(self, spec: TaskSpec) -> None:
        """Queue a normal task for lease-reuse submission. Must run on the
        io loop (touches the class-queue/pump state)."""
        key = self._sched_class_key(spec)
        q = self._class_queues.get(key)
        if q is None:
            q = self._class_queues[key] = _ClassQueue()
        q.specs.append(spec)
        q.work.set()
        self._retries_left[spec.task_id.binary()] = spec.max_retries
        # One pump to start; growth is demand-driven (see _drain_on_lease):
        # eager fan-out costs more than it buys for micro-tasks (lease
        # churn + worker wakeups), while slow tasks trigger sibling pumps
        # within lease_pump_growth_s anyway.
        if q.pumps == 0:
            q.pumps = 1
            if len(self._pump_tasks) > 64:
                self._pump_tasks = [t for t in self._pump_tasks if not t.done()]
            self._pump_tasks.append(
                asyncio.ensure_future(self._pump_class(key, q, spec))
            )

    async def _pump_class(self, key, q: "_ClassQueue", template: TaskSpec) -> None:
        try:
            while q.specs:
                # the lease is acquired on behalf of the request at the
                # queue HEAD — attribute its span there, not to the spec
                # that happened to start this pump (which may be long
                # finished, or unsampled while the head is sampled)
                head_trace = q.specs[0].trace_ctx if q.specs else None
                lease_t0 = time.monotonic()
                lease_t0_us = _timeline._now_us() if head_trace else 0.0
                try:
                    grant = await self._acquire_lease(template)
                    self._observe_stage("lease", time.monotonic() - lease_t0)
                    if head_trace is not None:
                        _tracing.record_span(
                            head_trace, "lease", lease_t0_us,
                            _timeline._now_us(), category="task",
                        )
                except RayTpuError as e:
                    # class-wide failure (infeasible / lease timeout):
                    # fail everything currently queued for this class
                    while q.specs:
                        s = q.specs.popleft()
                        self._finalize_spec(s, error=e)
                    return
                try:
                    await self._drain_on_lease(key, q, grant)
                finally:
                    try:
                        await self._client(
                            grant["daemon_host"], grant["daemon_port"], role="noded"
                        ).call("return_lease", {"lease_id": grant["lease_id"]})
                    except Exception:
                        pass
        except Exception:  # noqa: BLE001 — never leave returns pending
            logger.exception("class pump failed")
            while q.specs:
                s = q.specs.popleft()
                self._finalize_spec(s, error=RayTpuError("submission pump failed"))
        finally:
            q.pumps -= 1
            if q.pumps == 0 and not q.specs:
                self._class_queues.pop(key, None)

    def _maybe_grow_pumps(self, key, q: "_ClassQueue") -> None:
        """A push has been in flight past the growth threshold with work
        still queued: the tasks are long (or blocked) enough that another
        lease is worth its churn — spawn a sibling pump."""
        if q.specs and 0 < q.pumps < GLOBAL_CONFIG.max_lease_pumps:
            q.pumps += 1
            self._pump_tasks.append(
                asyncio.ensure_future(self._pump_class(key, q, q.specs[0]))
            )

    async def _drain_on_lease(self, key, q: "_ClassQueue", grant: Dict[str, Any]) -> None:
        """Push queued specs onto one held lease until the queue runs dry
        (with a short linger for stragglers) or the worker dies."""
        worker_client = self._client(grant["host"], grant["port"], role="worker")
        loop = asyncio.get_event_loop()
        while True:
            if not q.specs:
                # Linger: hold the lease briefly for follow-on work, but
                # wake IMMEDIATELY when something is enqueued (a plain
                # sleep would add up to linger_s of latency per task on
                # serial submit-get-submit callers).
                q.work.clear()
                try:
                    await asyncio.wait_for(
                        q.work.wait(), GLOBAL_CONFIG.lease_linger_s
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                if not q.specs:
                    return
            # Pop a small batch: one RPC carries several specs (executed
            # serially worker-side), amortizing framing + syscalls.
            # ADAPTIVE size: batch only when the queue floods faster than
            # the pumps drain — with few tasks per pump the batch is 1,
            # preserving cross-worker parallelism for long tasks (and
            # keeping force-cancel's worker kill from taking batchmates
            # down with it).
            limit = max(
                1,
                min(
                    GLOBAL_CONFIG.lease_push_batch,
                    (len(q.specs) + 1) // max(1, q.pumps),
                ),
            )
            batch: List[TaskSpec] = []
            while q.specs and len(batch) < limit:
                spec = q.specs[0]
                # Batch-dependency guard: a spec whose owned dep is still
                # PENDING must not ride behind its producer in ONE batch —
                # the worker executes the batch serially and the producer's
                # result only reaches this owner in the batched reply, so
                # the dependent would deadlock waiting for it. Close the
                # batch instead; the next push happens after this reply is
                # processed. (Taken alone it may still block the lane on a
                # dep produced elsewhere — that's latency, not deadlock.)
                if batch and self._has_pending_owned_dep(spec):
                    break
                q.specs.popleft()
                tid = spec.task_id.binary()
                if tid in self._cancelled_tasks:
                    self._finalize_spec(
                        spec, error=TaskCancelledError(spec.task_id.hex()[:16])
                    )
                    continue
                submit_ts = getattr(spec, "_submit_ts", None)
                if submit_ts is not None:
                    # queue stage: submit → popped by a lease pump
                    queued_s = time.monotonic() - submit_ts
                    self._observe_stage("queue", queued_s)
                    if spec.trace_ctx is not None:
                        now_us = _timeline._now_us()
                        _tracing.record_span(
                            spec.trace_ctx, f"queue::{spec.name}",
                            now_us - queued_s * 1e6, now_us, category="task",
                        )
                batch.append(spec)
            if not batch:
                continue
            for spec in batch:
                self._inflight_workers[spec.task_id.binary()] = (
                    grant["host"],
                    grant["port"],
                )
            grow_handle = loop.call_later(
                GLOBAL_CONFIG.lease_pump_growth_s, self._maybe_grow_pumps, key, q
            )
            push_t0 = time.monotonic()
            traced = next((s for s in batch if s.trace_ctx is not None), None)
            push_t0_us = _timeline._now_us() if traced is not None else 0.0
            try:
                reply = await worker_client.call(
                    "push_batch",
                    {"specs": [encode_spec(s) for s in batch]},
                    timeout=None,
                    connect_timeout=3.0,
                )
            except ChaosInjectedError:
                # injected BEFORE the handler ran: re-push on the same
                # (healthy) lease without consuming task retries
                for spec in reversed(batch):
                    q.specs.appendleft(spec)
                await asyncio.sleep(0.02)
                continue
            except ConnectionLost:
                for spec in batch:
                    tid = spec.task_id.binary()
                    if tid in self._cancelled_tasks:
                        # force-cancel kills the worker: that drop IS the
                        # cancellation, not a crash to retry
                        self._finalize_spec(
                            spec, error=TaskCancelledError(spec.task_id.hex()[:16])
                        )
                    elif self._retries_left.get(tid, 0) > 0:
                        self._retries_left[tid] -= 1
                        logger.info("task %s worker died; retrying", spec.name)
                        q.specs.appendleft(spec)
                    else:
                        self._finalize_spec(
                            spec,
                            error=WorkerCrashedError(
                                f"worker died executing {spec.name}"
                            ),
                        )
                return  # lease is dead
            except Exception as e:  # noqa: BLE001
                # Non-transport failure (e.g. worker-side packaging error
                # surfaced as RemoteError): the batch's returns must never
                # be left PENDING forever.
                logger.exception("push_batch failed")
                for spec in batch:
                    self._finalize_spec(
                        spec,
                        error=e if isinstance(e, RayTpuError) else RayTpuError(repr(e)),
                    )
                return
            finally:
                grow_handle.cancel()
                for spec in batch:
                    self._inflight_workers.pop(spec.task_id.binary(), None)
            # push stage: the whole batch's RPC round trip (execution
            # included); one span per batch — per-spec copies of the
            # same interval would only add noise to the trace
            self._observe_stage("push", time.monotonic() - push_t0)
            if traced is not None:
                _tracing.record_span(
                    traced.trace_ctx, f"push_batch::{len(batch)}",
                    push_t0_us, _timeline._now_us(), category="task",
                )
            replies = reply["replies"]
            for i, spec in enumerate(batch):
                if i >= len(replies):
                    # defensive: a short reply list must not strand the
                    # tail's returns in PENDING forever
                    self._finalize_spec(
                        spec, error=RayTpuError("push_batch reply truncated")
                    )
                    continue
                tid = spec.task_id.binary()
                try:
                    retry = self._process_reply(
                        spec, replies[i], self._retries_left.get(tid, 0)
                    )
                except Exception as e:  # noqa: BLE001
                    logger.exception("reply processing failed for %s", spec.name)
                    self._finalize_spec(spec, error=RayTpuError(repr(e)))
                    continue
                if retry:
                    self._retries_left[tid] -= 1
                    q.specs.appendleft(spec)
                else:
                    self._finalize_spec(spec)

    def _has_pending_owned_dep(self, spec: TaskSpec) -> bool:
        for ref in spec.dependencies():
            obj = self.refcounter.get(ref.id())
            if obj is not None and not obj.ready():
                return True
        return False

    @staticmethod
    def _observe_stage(stage: str, seconds: float) -> None:
        from ray_tpu_torch.observability.rpc_metrics import TASK_STAGE_SECONDS

        TASK_STAGE_SECONDS.observe(seconds, labels={"stage": stage})

    def _finalize_spec(self, spec: TaskSpec, error: Optional[Exception] = None) -> None:
        """A spec leaves the submission system: record failure (if any),
        release dep pins and cancellation/retry bookkeeping."""
        if error is not None:
            self._fail_returns(spec, error)
        tid = spec.task_id.binary()
        self._cancelled_tasks.pop(tid, None)
        self._retries_left.pop(tid, None)
        self._unpin_deps(spec)
        submit_ts = getattr(spec, "_submit_ts", None)
        if submit_ts is not None:
            self._observe_stage("total", time.monotonic() - submit_ts)
        if spec.trace_ctx is not None and error is None:
            # result-push landed at the owner: instant completion marker
            now_us = _timeline._now_us()
            _tracing.record_span(
                spec.trace_ctx, f"complete::{spec.name}", now_us, now_us,
                category="task",
            )
        self.emit_task_event(spec, "FAILED" if error is not None else "FINISHED")

    # ------------------------------------------------------------------
    # streaming generators (owner side)
    def create_stream(self, spec: TaskSpec):
        from ray_tpu_torch.core.streaming import ObjectRefStream

        stream = ObjectRefStream(spec.task_id.binary())
        with self._streams_lock:
            self._streams[spec.task_id.binary()] = stream
        return stream

    def stream_next(self, task_id: bytes, index: int, timeout: Optional[float]):
        from ray_tpu_torch.core.streaming import _END

        with self._streams_lock:
            stream = self._streams.get(task_id)
        if stream is None:
            raise RayTpuError("unknown stream (task already cleaned up?)")
        out = stream.next_blocking(index, timeout)
        if out is _END:
            # last consumer position reached: drop the stream record
            with self._streams_lock:
                self._streams.pop(task_id, None)
        else:
            self._report_stream_consumed(task_id, stream, index)
        return out

    def _report_stream_consumed(self, task_id: bytes, stream, index: int) -> None:
        """Throttled consumer-position report to the producing worker —
        what resumes a generator paused on backpressure."""
        threshold = GLOBAL_CONFIG.streaming_generator_backpressure_items
        if threshold <= 0:
            return
        step = max(1, threshold // 2)
        last = getattr(stream, "_last_reported", 0)
        if index - last < step:
            return
        stream._last_reported = index
        target = self._inflight_workers.get(task_id)
        if target is None:
            return
        host, port = target

        async def _send():
            try:
                await self._client(host, port, role="worker").call(
                    "stream_consumed",
                    {"task_id": task_id, "consumed": index},
                    timeout=10,
                )
            except Exception:
                pass  # producer done/dead: nothing to unblock

        self.io.post(_send())

    def abandon_stream(self, task_id: bytes, consumed_pos: int) -> None:
        """Generator dropped before exhaustion: release holds on items the
        consumer never took and cancel the producer (no point computing a
        stream nobody reads). Holds the streams lock so an item push
        racing the abandonment can't create a hold nobody releases."""
        with self._streams_lock:
            stream = self._streams.pop(task_id, None)
            if stream is None:
                return
            with stream._cond:
                undelivered = list(stream._items.values())
                # gate the cancel on PRODUCER COMPLETION, not item-1
                # readiness: a finished stream (total set / errored) has
                # nothing running to cancel, while an unfinished one must
                # be cancelled even if its first item was consumed long ago
                finished = stream._total is not None or stream._error is not None
        self.release_hold(undelivered)
        if not finished:
            self._cancel_task_by_id(task_id, force=False)

    def _on_stream_item(self, msg: Dict[str, Any]) -> None:
        """Worker-pushed stream item: record the value + ref."""
        task_id = msg["task_id"]
        oid = ObjectID(msg["object_id"])
        with self._streams_lock:
            stream = self._streams.get(task_id)
            if stream is None:
                # stream abandoned: a late shm item would otherwise sit in
                # the producing node's store forever — best-effort delete
                if msg["kind"] == "shm":
                    _nid, host, port = msg["location"]
                    self.io.post(self._delete_remote(host, port, oid))
                return
            # entry holds until the generator hands out the real
            # ObjectRef; created under the lock so abandon_stream either
            # sees this item (and releases it) or this push sees the
            # stream already gone
            self.refcounter.create_pending(oid, hold=True)
            stream.append(msg["index"], oid)
        if msg["kind"] == "inline":
            self.memory.put(oid, msg["data"])
            self.refcounter.mark_available_inline(oid, msg["data"])
        else:
            self.refcounter.mark_available_at(oid, tuple(msg["location"]))

    def _finalize_stream(self, spec: TaskSpec, error: Optional[Exception]) -> None:
        stream = self._streams.get(spec.task_id.binary())
        if stream is None:
            return
        if error is not None:
            stream.fail(error)

    # ------------------------------------------------------------------
    # task events (batched → controller; reference task_event_buffer)
    def emit_task_event(self, spec: TaskSpec, state: str) -> None:
        if not GLOBAL_CONFIG.task_events_enabled:
            return
        ev = {
            "task_id": spec.task_id.binary(),
            "name": spec.name,
            "state": state,
            "ts": time.time(),
        }
        with self._task_events_lock:
            self._task_events.append(ev)
            schedule = not self._task_events_flushing
            if schedule:
                self._task_events_flushing = True
        if schedule:
            self.io.post(self._flush_task_events())

    async def _flush_task_events(self) -> None:
        try:
            await asyncio.sleep(0.2)  # batch window
            with self._task_events_lock:
                events, self._task_events = self._task_events, []
            if events:
                await self.controller.call(
                    "task_events", {"events": events}, timeout=10
                )
        except Exception:
            pass  # observability is best-effort
        finally:
            # events that arrived while the RPC was in flight must not
            # strand in the buffer until the next emit — reschedule
            with self._task_events_lock:
                again = bool(self._task_events) and not self._stopping
                if not again:
                    self._task_events_flushing = False
            if again:
                self.io.post(self._flush_task_events())

    async def _acquire_lease(self, spec: TaskSpec) -> Dict[str, Any]:
        """Lease with spillback-following (reference lease protocol).

        Placement-group leases go straight to a daemon holding one of the
        PG's bundles (only those daemons have the bundle pools)."""
        from ray_tpu_torch.core.task_spec import PlacementGroupScheduling

        daemon = self.daemon
        daemon_addr = self.daemon_addr
        if isinstance(spec.scheduling_strategy, PlacementGroupScheduling):
            target = await self._pg_lease_target(spec.scheduling_strategy)
            if target is not None:
                daemon_addr = target
                daemon = self._client(*target, role="noded")
        deadline = time.monotonic() + GLOBAL_CONFIG.worker_lease_timeout_s * 10
        infeasible_since: Optional[float] = None
        while True:
            try:
                reply = await daemon.call(
                    "request_lease",
                    {"resources": spec.resources, "strategy": spec.scheduling_strategy},
                    timeout=60,
                    connect_timeout=3.0,
                )
            except (ConnectionLost, asyncio.TimeoutError):
                if daemon is self.daemon:
                    raise RayTpuError("local node daemon unreachable")
                # spillback target died — fall back to the local daemon
                daemon, daemon_addr = self.daemon, self.daemon_addr
                await asyncio.sleep(0.1)
                continue
            if "grant" in reply:
                g = reply["grant"]
                g["daemon_host"], g["daemon_port"] = daemon_addr
                return g
            if "spillback" in reply:
                host, port = reply["spillback"]
                daemon = self._client(host, port, role="noded")
                daemon_addr = (host, port)
                continue
            if reply.get("infeasible"):
                # infeasible is terminal only after the patience window:
                # on an autoscaled cluster the demand this request parks
                # is what LAUNCHES the node that makes it feasible
                now = time.monotonic()
                if infeasible_since is None:
                    infeasible_since = now
                if now - infeasible_since >= GLOBAL_CONFIG.infeasible_fail_after_s:
                    raise RayTpuError(
                        f"task {spec.name} requires {spec.resources} which no node can satisfy"
                    )
                await asyncio.sleep(0.5)
                continue
            infeasible_since = None
            await asyncio.sleep(reply.get("retry_after", 0.05))
            if isinstance(spec.scheduling_strategy, PlacementGroupScheduling):
                target = await self._pg_lease_target(spec.scheduling_strategy)
                if target is not None:
                    daemon_addr = target
                    daemon = self._client(*target, role="noded")
            else:
                # fall back to local daemon (cluster may have changed)
                daemon = self.daemon
                daemon_addr = self.daemon_addr
            if time.monotonic() > deadline:
                raise RayTpuError(f"lease for {spec.name} timed out")

    async def _pg_lease_target(self, strategy) -> Optional[Tuple[str, int]]:
        """Daemon address of a node holding one of the PG's bundles."""
        info = await self.controller.call("get_pg", {"pg_id": strategy.pg_id})
        if not info or not info.get("nodes"):
            return None
        node_ids = info["nodes"]
        indices = info.get("bundle_indices", list(range(len(node_ids))))
        wanted = None
        if strategy.bundle_index >= 0:
            for nid, idx in zip(node_ids, indices):
                if idx == strategy.bundle_index:
                    wanted = nid
                    break
        else:
            wanted = node_ids[0]
        if wanted is None:
            return None
        for n in await self.controller.call("nodes"):
            if n["node_id"] == wanted and n["Alive"]:
                return (n["host"], n["port"])
        return None

    def _process_reply(self, spec: TaskSpec, reply: Dict[str, Any], retries_left: int) -> bool:
        """Record results with the ownership table. Returns True if the
        task should be retried (app-level error + retry_exceptions)."""
        results: List[Tuple[bytes, str, Any]] = reply["results"]
        # Check for retryable application errors first.
        for _oid, kind, payload in results:
            if kind == "error":
                err = pickle.loads(payload)
                if isinstance(err, TaskError) and self._should_retry_app_error(spec, err, retries_left):
                    return True
        for oid_bytes, kind, payload in results:
            if kind == "stream_end":
                stream = self._streams.get(spec.task_id.binary())
                if stream is not None:
                    stream.complete(payload)  # payload = total item count
                continue
            if kind == "error" and spec.num_returns == "streaming":
                # streams have no fixed return ids — fail the stream itself
                self._finalize_stream(spec, pickle.loads(payload))
                continue
            oid = ObjectID(oid_bytes)
            if kind == "inline":
                self.memory.put(oid, payload)
                self.refcounter.mark_available_inline(oid, payload)
            elif kind == "shm":
                self.refcounter.mark_available_at(oid, tuple(payload))
            elif kind == "error":
                self.refcounter.mark_failed(oid, pickle.loads(payload))
        return False

    def _should_retry_app_error(self, spec: TaskSpec, err: TaskError, retries_left: int) -> bool:
        if retries_left <= 0 or not spec.retry_exceptions:
            return False
        if spec.retry_exceptions is True:
            return True
        try:
            return isinstance(err.cause, tuple(spec.retry_exceptions))
        except TypeError:
            return False

    def _fail_returns(self, spec: TaskSpec, error: Exception) -> None:
        for oid in spec.return_ids:
            self.refcounter.mark_failed(oid, error)
        if spec.num_returns == "streaming":
            self._finalize_stream(spec, error)

    # ------------------------------------------------------------------
    # actors
    def create_actor(self, spec: TaskSpec) -> None:
        _tracing.stamp_spec(spec)
        with self._actors_lock:
            st = self._actors.setdefault(spec.actor_id, _ActorState())
            st.max_task_retries = spec.max_task_retries
            st.max_concurrency = max(1, spec.max_concurrency)
            # Pin the creation spec for the actor's (restartable)
            # lifetime: its args may be implicit-put objects (e.g. a list
            # containing ObjectRefs) whose ONLY owner-side reference is
            # the ObjectRef held by this spec — dropping it before the
            # (possibly restarted) creation task fetches args would free
            # them under the actor.
            st.creation_spec = spec
        self.io.run(self.controller.call("register_actor", {"spec": spec}))

    def _stale_controller_push(self, msg: Dict[str, Any]) -> bool:
        """Worker half of controller epoch fencing: state pushes carry
        the sender's incarnation epoch (controller._publish). Track the
        highest seen; drop anything lower — it was emitted by a deposed
        controller racing its own takeover, and applying it would roll
        actor/node/PG state back behind the new incumbent's."""
        epoch = msg.get("controller_epoch", 0)
        if not epoch:
            return False  # ephemeral (no-persistence) controller
        if epoch < self._controller_epoch_seen:
            logger.warning(
                "dropping stale controller push (epoch %d < %d)",
                epoch, self._controller_epoch_seen,
            )
            return True
        self._controller_epoch_seen = epoch
        return False

    def _on_actor_push(self, msg: Dict[str, Any]) -> None:
        if self._stale_controller_push(msg):
            return
        actor_id = msg["actor_id"]
        with self._actors_lock:
            st = self._actors.setdefault(actor_id, _ActorState())
            st.state = msg["state"]
            if msg.get("address") is not None:
                st.address = msg["address"]
            if msg.get("reason"):
                st.reason = msg["reason"]
            if msg["state"] == "DEAD":
                st.creation_spec = None  # release pinned creation args
            st.event.set()

    def _on_node_push(self, msg: Dict[str, Any]) -> None:
        """Controller-pushed node membership/state changes. Libraries
        (Train's drain watch, Serve) register listeners to react to
        DRAINING the moment the warning lands, not on a poll interval."""
        if self._stale_controller_push(msg):
            return
        nid = msg.get("node_id")
        if nid is not None:
            if msg.get("alive"):
                self._dead_nodes.discard(nid)
            elif msg.get("state") == "DEAD" or msg.get("alive") is False:
                self._dead_nodes.add(nid)
        for cb in list(self._node_event_listeners):
            try:
                cb(msg)
            except Exception:
                logger.debug("node event listener failed", exc_info=True)

    def add_node_event_listener(self, cb) -> None:
        """``cb(msg)`` with msg = {node_id, alive, state?, reason?}; runs
        on the io loop thread — keep it non-blocking."""
        self._node_event_listeners.append(cb)

    def remove_node_event_listener(self, cb) -> None:
        try:
            self._node_event_listeners.remove(cb)
        except ValueError:
            pass

    def _on_log_push(self, msg: Dict[str, Any]) -> None:
        import sys

        node = msg["node_id"].hex()[:8]
        for entry in msg.get("batch", []):
            worker = entry["worker"].replace("worker-", "").replace(".log", "")
            for line in entry["lines"]:
                print(f"({worker}, node={node}) {line}", file=sys.stderr)

    def _on_pg_push(self, msg: Dict[str, Any]) -> None:
        # Only track PGs this process has expressed interest in (created or
        # waited on): pushes are cluster-wide, so caching every one would
        # grow without bound in long-lived workers under PG churn. Waiters
        # that miss a push recover via the poll fallback in wait_pg_ready.
        if self._stale_controller_push(msg):
            return
        ev = self._pg_events.get(msg["pg_id"])
        if ev is None:
            return
        self._pg_states[msg["pg_id"]] = msg["state"]
        ev.set()

    async def _resolve_actor(self, actor_id: ActorID) -> _ActorState:
        with self._actors_lock:
            st = self._actors.setdefault(actor_id, _ActorState())
        deadline = time.monotonic() + 120
        loop = asyncio.get_event_loop()
        while time.monotonic() < deadline:
            if st.state == "ALIVE" and st.address is not None:
                return st
            if st.state == "DEAD":
                return st
            info = await self.controller.call("get_actor_info", {"actor_id": actor_id})
            if info is not None:
                with self._actors_lock:
                    st.state = info["state"]
                    st.address = info["address"]
                    st.reason = info.get("reason", "")
                    st.max_concurrency = info.get("max_concurrency", st.max_concurrency)
                    st.max_task_retries = info.get("max_task_retries", st.max_task_retries)
                if st.state in ("ALIVE", "DEAD") and (st.state == "DEAD" or st.address):
                    return st
            await asyncio.sleep(0.05)
        raise RayTpuError(f"actor {actor_id.hex()[:8]} did not become ready")

    def submit_actor_task(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids:
            self.refcounter.create_pending(oid, hold=True)
        self._pin_deps(spec)
        _tracing.stamp_spec(spec)
        spec._submit_ts = time.monotonic()
        self._buffer_submit(True, spec)

    def _enqueue_actor_task(self, spec: TaskSpec) -> None:
        """Per-actor ordered dispatch (``SequentialActorSubmitQueue``):
        calls to a max_concurrency==1 actor are pushed strictly in
        submission order; concurrent/async actors dispatch directly.
        Must run on the io loop."""
        with self._actors_lock:
            st = self._actors.setdefault(spec.actor_id, _ActorState())
            # handle-carried hint: a borrower's first dispatch must not
            # serialize a concurrent actor through the ordered pump
            if spec.max_concurrency > st.max_concurrency:
                st.max_concurrency = spec.max_concurrency
        if st.max_concurrency > 1:
            asyncio.ensure_future(self._submit_actor(spec))
            return
        q = self._actor_queues.get(spec.actor_id)
        if q is None:
            q = self._actor_queues[spec.actor_id] = asyncio.Queue()
            self._pump_tasks.append(asyncio.ensure_future(self._actor_pump(spec.actor_id, q)))
        q.put_nowait(spec)

    async def _actor_pump(self, actor_id: ActorID, q: "asyncio.Queue") -> None:
        # Batched ordered pushes: pop everything queued and send ONE
        # framed RPC (the worker executes the batch serially, seq-ordered)
        # — the round-trip amortizes across the burst exactly like the
        # normal-task lease pipelining, while strict submission order is
        # preserved even across worker restarts (the whole batch retries
        # in order).
        carry: Optional[TaskSpec] = None
        while not self._stopping:
            spec = carry if carry is not None else await q.get()
            carry = None
            batch = [spec]
            limit = GLOBAL_CONFIG.lease_push_batch
            while len(batch) < limit and not q.empty():
                nxt = q.get_nowait()
                # same batch-dependency guard as the normal-task path: a
                # call whose owned dep is pending (possibly produced by a
                # batchmate) must start the NEXT batch
                if self._has_pending_owned_dep(nxt):
                    carry = nxt
                    break
                batch.append(nxt)
            try:
                await self._submit_actor_batch(batch)
            except Exception as e:  # noqa: BLE001 — the pump must survive
                logger.exception("actor batch submission failed")
                for s in batch:
                    self._fail_returns(
                        s, e if isinstance(e, RayTpuError) else RayTpuError(repr(e))
                    )

    async def _submit_actor(self, spec: TaskSpec) -> None:
        try:
            await self._submit_actor_inner(spec)
        except Exception as e:  # noqa: BLE001 — never leave returns pending
            logger.exception("actor task %s submission failed", spec.name)
            self._fail_returns(spec, e if isinstance(e, RayTpuError) else RayTpuError(repr(e)))

    async def _recover_push_target(self, actor_id, st, binding) -> bool:
        """Shared ConnectionLost recovery for actor pushes (ordered-batch
        AND direct submit paths): consult the controller, refresh the
        cached actor state, and decide whether the SAME live incarnation
        can be re-pushed under the bound request id (True — the re-push
        is dedup-protected, consumes no task-retry budget, and is safe
        even for streaming calls) or the binding must be invalidated so
        the caller applies its per-spec retry/fail semantics (False).

        The controller consult is deliberately NOT guarded: if the
        control plane is also gone there is nothing to wait for — the
        exception propagates to the caller's catch, which fails the
        pending returns (a guarded retry here would loop forever on the
        cached ALIVE state)."""
        info = await self.controller.call("get_actor_info", {"actor_id": actor_id})
        with self._actors_lock:
            if info is not None:
                st.state = info["state"]
                st.address = info["address"]
                st.reason = info.get("reason", "")
            else:
                st.state = "DEAD"
        if (
            st.state == "ALIVE"
            and st.address is not None
            and (st.address.host, st.address.port)
            == (binding.client.host, binding.client.port)
            and binding.can_retry_same_target()
        ):
            # same live incarnation, connection blip only: this is what
            # makes non-idempotent serve calls safely auto-retryable
            # while the replica is reachable (serve/router.py contract)
            binding.note_retry()
            await asyncio.sleep(0.1)
            return True
        # actor moved/died (or retries exhausted): the next push is a
        # DIFFERENT logical request — fresh id
        binding.invalidate()
        return False

    async def _submit_actor_batch(self, batch: List[TaskSpec]) -> None:
        """Push an ordered batch of calls to one actor; retries keep order
        (the whole remaining batch is re-pushed after a restart)."""
        from ray_tpu_torch.core.transport_retry import PushBinding

        actor_id = batch[0].actor_id
        all_specs = list(batch)
        with self._actors_lock:
            st = self._actors.setdefault(actor_id, _ActorState())
        retries_left = {s.task_id.binary(): st.max_task_retries for s in batch}
        # Request-id reuse (exactly-once): every re-push of THIS batch to
        # the SAME replica/client shares one dedup slot, so a push whose
        # reply was lost after execution is answered from the server's
        # reply cache instead of running twice. A new client (actor moved)
        # or a trimmed batch gets a fresh id — different logical request.
        binding = PushBinding()
        try:
            while batch:
                try:
                    st = await self._resolve_actor(actor_id)
                except Exception as e:  # noqa: BLE001
                    for s in batch:
                        self._fail_returns(s, RayTpuError(repr(e)))
                    return
                if st.state == "DEAD":
                    for s in batch:
                        self._fail_returns(
                            s, ActorDiedError(actor_id, st.reason or "actor is dead")
                        )
                    return
                client = self._client(st.address.host, st.address.port, role="worker")
                push_rid = binding.bind(client)
                for s in batch:
                    # streaming methods need the producer's address for
                    # consumer-position (backpressure) reports
                    if s.num_returns == "streaming":
                        self._inflight_workers[s.task_id.binary()] = (
                            st.address.host,
                            st.address.port,
                        )
                try:
                    reply = await client.call(
                        "push_batch",
                        {"specs": [encode_spec(s) for s in batch]},
                        timeout=None,
                        connect_timeout=3.0,
                        request_id=push_rid,
                    )
                except ChaosInjectedError:
                    # injected fault: retry the batch under the SAME
                    # request id — if the handler already ran (reply
                    # dropped), the dedup cache answers; no task retry
                    # budget is consumed either way
                    await asyncio.sleep(0.02)
                    continue
                except ConnectionLost:
                    if await self._recover_push_target(actor_id, st, binding):
                        continue
                    survivors: List[TaskSpec] = []
                    for s in batch:
                        tid = s.task_id.binary()
                        # a partially-consumed stream must not replay
                        if (
                            st.state == "DEAD"
                            or retries_left[tid] <= 0
                            or s.num_returns == "streaming"
                        ):
                            self._fail_returns(
                                s,
                                ActorDiedError(
                                    actor_id, st.reason or "actor worker died mid-call"
                                ),
                            )
                        else:
                            retries_left[tid] -= 1
                            survivors.append(s)
                    batch = survivors
                    if batch:
                        await asyncio.sleep(0.1)
                    continue
                except Exception as e:  # noqa: BLE001
                    for s in batch:
                        self._fail_returns(
                            s, e if isinstance(e, RayTpuError) else RayTpuError(repr(e))
                        )
                    return
                replies = reply["replies"]
                for i, s in enumerate(batch):
                    if i >= len(replies):
                        self._fail_returns(s, RayTpuError("push_batch reply truncated"))
                        continue
                    try:
                        self._process_reply(s, replies[i], 0)
                    except Exception as e:  # noqa: BLE001
                        logger.exception("reply processing failed for %s", s.name)
                        self._fail_returns(s, RayTpuError(repr(e)))
                return
        finally:
            for s in all_specs:
                self._unpin_deps(s)
                self._inflight_workers.pop(s.task_id.binary(), None)

    async def _submit_actor_inner(self, spec: TaskSpec) -> None:
        from ray_tpu_torch.core.transport_retry import PushBinding

        try:
            with self._actors_lock:
                st = self._actors.setdefault(spec.actor_id, _ActorState())
            retries_left = st.max_task_retries
            # request-id reuse across re-pushes to the same incarnation
            # (see _submit_actor_batch for the exactly-once rationale)
            binding = PushBinding()
            while True:
                st = await self._resolve_actor(spec.actor_id)
                if st.state == "DEAD":
                    self._fail_returns(
                        spec, ActorDiedError(spec.actor_id, st.reason or "actor is dead")
                    )
                    return
                client = self._client(st.address.host, st.address.port, role="worker")
                push_rid = binding.bind(client)
                if spec.num_returns == "streaming":
                    self._inflight_workers[spec.task_id.binary()] = (
                        st.address.host,
                        st.address.port,
                    )
                try:
                    reply = await client.call(
                        "push_task",
                        {"spec": encode_spec(spec)},
                        timeout=None,
                        connect_timeout=3.0,
                        request_id=push_rid,
                    )
                except ChaosInjectedError:
                    await asyncio.sleep(0.02)
                    continue
                except ConnectionLost:
                    if await self._recover_push_target(spec.actor_id, st, binding):
                        continue
                    if (
                        st.state == "DEAD"
                        or retries_left <= 0
                        or spec.num_returns == "streaming"
                    ):
                        self._fail_returns(
                            spec,
                            ActorDiedError(
                                spec.actor_id,
                                st.reason or "actor worker died mid-call",
                            ),
                        )
                        return
                    retries_left -= 1
                    await asyncio.sleep(0.1)
                    continue
                self._process_reply(spec, reply, 0)
                return
        finally:
            self._unpin_deps(spec)
            self._inflight_workers.pop(spec.task_id.binary(), None)

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        self.io.run(
            self.controller.call("kill_actor", {"actor_id": actor_id, "no_restart": no_restart})
        )

    def kill_actor_nowait(self, actor_id: ActorID) -> None:
        async def _kill():
            try:
                await self.controller.call(
                    "kill_actor", {"actor_id": actor_id, "no_restart": True}
                )
            except Exception:
                pass

        if not self._stopping:
            self.io.post(_kill())

    def mark_actor_no_restart(self, actor_id: ActorID) -> None:
        async def _mark():
            try:
                await self.controller.call(
                    "kill_actor",
                    {"actor_id": actor_id, "no_restart": True, "drain": True},
                )
            except Exception:
                pass

        if not self._stopping:
            self.io.post(_mark())

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        """Cancel the task producing ``ref`` (``CoreWorker::CancelTask``).

        Queued tasks are failed with TaskCancelledError at the next
        submission checkpoint; a running task gets the error raised in
        its execution thread (cooperative — blocking C calls won't see
        it); ``force=True`` kills the executing worker process. Actor
        tasks are not cancellable (reference parity for sync actors)."""
        oid = ref.id()
        task_id = oid.task_id()
        if oid.is_put():
            raise ValueError("cannot cancel(): ref came from put(), not a task")
        if not self.refcounter.owns(oid):
            # Borrowed ref: submission state lives at the owner — forward
            # (reference CancelTask routes through the owner).
            owner = self._owner_client(ref)

            async def _forward():
                try:
                    await owner.call(
                        "cancel_owned_task",
                        {"object_id": oid.binary(), "force": force},
                        timeout=10,
                    )
                except Exception:
                    pass  # owner gone → task is moot anyway

            self.io.post(_forward())
            return
        self._cancel_owned(oid, force)

    def _cancel_owned(self, oid: ObjectID, force: bool) -> None:
        obj = self.refcounter.get(oid)
        if obj is not None and obj.ready():
            return  # already finished — nothing to cancel (reference no-op)
        self._cancel_task_by_id(oid.task_id().binary(), force)

    def _cancel_task_by_id(self, tid: bytes, force: bool) -> None:
        """Mark a task cancelled and notify its executing worker (shared
        by ref-cancel and stream-abandon paths)."""
        self._cancelled_tasks[tid] = None
        while len(self._cancelled_tasks) > 8192:
            self._cancelled_tasks.popitem(last=False)
        target = self._inflight_workers.get(tid)
        if target is not None:
            host, port = target

            async def _send():
                try:
                    await self._client(host, port, role="worker").call(
                        "cancel_task", {"task_id": tid, "force": force}, timeout=10
                    )
                except Exception:
                    pass  # worker already gone

            self.io.post(_send())

    def get_named_actor(self, name: str, namespace: str):
        info = self.io.run(
            self.controller.call("get_named_actor", {"name": name, "namespace": namespace})
        )
        if info is None:
            return None
        return (
            info["actor_id"],
            info["method_opts"],
            info["owner"],
            info.get("max_concurrency", 1),
        )

    def list_named_actors(self, all_namespaces: bool):
        return self.io.run(
            self.controller.call("list_named_actors", {"all_namespaces": all_namespaces})
        )

    # ------------------------------------------------------------------
    # placement groups (client side)
    def create_pg(self, pg_id: bytes, bundles, strategy: str, name: str = "") -> None:
        self._pg_events.setdefault(pg_id, threading.Event())
        self.io.run(
            self.controller.call(
                "create_pg",
                {"pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name},
            )
        )

    _PG_TERMINAL = ("CREATED", "INFEASIBLE", "REMOVED")

    _PG_POLL_INTERVAL_S = 2.0

    def wait_pg_ready(self, pg_id: bytes, timeout: Optional[float]) -> str:
        """Block until the PG reaches a terminal state.

        Push-driven with a polling fallback: interest (the event) is
        registered before the first poll, so any transition after that poll
        is pushed; slow re-polls only cover dropped pushes. The polled value
        is never written to the push cache — a stale in-flight PENDING reply
        must not clobber a concurrently-pushed terminal state.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        ev = self._pg_events.setdefault(pg_id, threading.Event())
        next_poll = 0.0
        state: Optional[str] = None
        while True:
            pushed = self._pg_states.get(pg_id)
            if pushed in self._PG_TERMINAL:
                state = pushed
            elif time.monotonic() >= next_poll:
                info = self.io.run(self.controller.call("get_pg", {"pg_id": pg_id}))
                # create_pg registers synchronously, so an id the controller
                # doesn't know was removed (the table drops entries on
                # removal to bound memory).
                state = info["state"] if info else "REMOVED"
                next_poll = time.monotonic() + self._PG_POLL_INTERVAL_S
            if state in self._PG_TERMINAL:
                # Reclaim wait state here too: only a *local* remove_pg
                # cleans up otherwise, and this process may not be the
                # remover.
                self._pg_states.pop(pg_id, None)
                self._pg_events.pop(pg_id, None)
                return state
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return state or "PENDING"
            # Clear → recheck → wait: clearing first avoids hot-spinning on
            # an event set by an earlier push, and the recheck catches a
            # push that landed before the clear (e.g. while the poll RPC
            # above was in flight) so its wakeup is never lost.
            ev.clear()
            pushed = self._pg_states.get(pg_id)
            if pushed in self._PG_TERMINAL:
                self._pg_states.pop(pg_id, None)
                self._pg_events.pop(pg_id, None)
                return pushed
            ev.wait(min(0.2, remaining) if remaining is not None else 0.2)

    def remove_pg(self, pg_id: bytes) -> None:
        self.io.run(self.controller.call("remove_pg", {"pg_id": pg_id}))
        # Drop per-pg wait state so long-lived drivers cycling many PGs
        # (e.g. the microbenchmark) don't grow these maps without bound.
        self._pg_states.pop(pg_id, None)
        self._pg_events.pop(pg_id, None)

    def get_pg(self, pg_id: bytes):
        return self.io.run(self.controller.call("get_pg", {"pg_id": pg_id}))

    def get_named_pg(self, name: str):
        return self.io.run(self.controller.call("get_named_pg", {"name": name}))

    def pg_table(self):
        return self.io.run(self.controller.call("pg_table"))

    # ------------------------------------------------------------------
    # kv / cluster info
    def kv_put(self, key: bytes, value: bytes) -> None:
        self.io.run(self.controller.call("kv_put", {"key": key, "value": value}))

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self.io.run(self.controller.call("kv_get", {"key": key}))

    def kv_keys(self, prefix: bytes = b"") -> List[bytes]:
        return self.io.run(self.controller.call("kv_keys", {"prefix": prefix}))

    def kv_del(self, key: bytes) -> None:
        self.io.run(self.controller.call("kv_del", {"key": key}))

    # ------------------------------------------------------------------
    # timeline export: worker-side chunks land in the controller's
    # BOUNDED export table (byte budget + node-death reap) instead of
    # growing the generic KV forever (observability/timeline.py)
    def export_timeline_chunk(self, key: str, blob: bytes) -> None:
        try:
            self.io.run(
                self.controller.call(
                    "export_events",
                    {"key": key, "blob": blob, "node_id": self.node_id},
                    timeout=10,
                )
            )
        except Exception:
            pass  # observability export is best-effort

    def collect_timeline_chunks(self) -> List[bytes]:
        try:
            return self.io.run(
                self.controller.call("collect_events", {}, timeout=30)
            )
        except Exception:
            return []

    def cluster_status(self) -> Dict[str, Any]:
        """Live cluster state in one call (the `ray list` equivalent):
        nodes / actors / task summary / per-node object stats / PGs /
        jobs, served from the controller's bounded tables."""
        return self.io.run(self.controller.call("cluster_status", {}, timeout=30))

    def cluster_resources(self) -> Dict[str, float]:
        return self.io.run(self.controller.call("cluster_resources"))

    def available_resources(self) -> Dict[str, float]:
        return self.io.run(self.controller.call("available_resources"))

    def nodes(self) -> List[Dict[str, Any]]:
        return self.io.run(self.controller.call("nodes"))

    def drain_node(self, node_id: bytes, reason: str = "drain requested") -> bool:
        """Operator-initiated graceful drain (reference ``DrainNode``)."""
        reply = self.io.run(
            self.controller.call(
                "drain_node", {"node_id": node_id, "reason": reason}, timeout=30
            )
        )
        return bool(reply and reply.get("ok"))

    # ------------------------------------------------------------------
    # owner services (every process with a CoreWorker serves these)
    async def w_get_object_status(self, payload, conn):
        oid = ObjectID(payload["object_id"])
        timeout = payload.get("timeout", 30.0)
        if not self.refcounter.owns(oid):
            data = self.memory.get(oid)
            if data is not None:
                return {"status": "inline", "data": data}
            return {"status": "unknown"}
        # Event-driven long-poll: park on the io loop, NOT an executor
        # thread — dozens of borrowers long-polling must not saturate the
        # owner's thread pool (reference pubsub serves these from buffers).
        obj = self.refcounter.get(oid)
        if timeout != 0 and (obj is None or not obj.ready()):
            loop = asyncio.get_event_loop()
            ev = asyncio.Event()
            cb = _loop_event_setter(loop, ev)
            if not self.refcounter.on_ready(oid, cb):
                try:
                    await asyncio.wait_for(ev.wait(), timeout)
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                finally:
                    self.refcounter.remove_ready_callback(oid, cb)
            obj = self.refcounter.get(oid)
        if obj is None:
            return {"status": "unknown"}
        if obj.state == ObjState.FAILED:
            return {"status": "error", "error": pickle.dumps(obj.error)}
        if obj.state != ObjState.AVAILABLE:
            return {"status": "pending"}
        if obj.inline is not None:
            return {"status": "inline", "data": obj.inline}
        return {"status": "locations", "locations": list(obj.locations)}

    async def w_stream_consumed(self, payload, conn):
        """Owner's consumer-position report for a streaming generator
        running on this worker (backpressure resume signal)."""
        if self.executor is not None:
            self.executor.update_stream_consumed(
                payload["task_id"], payload["consumed"]
            )
        return True

    async def w_cancel_task(self, payload, conn):
        """Cancel an executing/queued task on this worker."""
        if self.executor is None:
            return False
        return self.executor.cancel_task(payload["task_id"], payload.get("force", False))

    async def w_cancel_owned_task(self, payload, conn):
        """Borrower-forwarded cancel: this process owns the target ref."""
        self._cancel_owned(ObjectID(payload["object_id"]), payload.get("force", False))
        return True

    async def w_recover_object(self, payload, conn):
        """Borrower-initiated lineage reconstruction: a borrower failed to
        fetch any copy; the owner resubmits the producing task."""
        return self._try_recover(
            ObjectID(payload["object_id"]),
            observed_locations=payload.get("observed"),
        )

    async def w_add_borrower(self, payload, conn):
        self.refcounter.add_borrower(ObjectID(payload["object_id"]))
        return True

    async def w_remove_borrower(self, payload, conn):
        self.refcounter.remove_borrower(ObjectID(payload["object_id"]))
        return True

    async def w_delete_object(self, payload, conn):
        self.memory.delete(ObjectID(payload["object_id"]))
        return True

    async def w_ping(self, payload, conn):
        return "pong"

    async def w_set_accelerator_env(self, payload, conn):
        """Daemon-assigned device isolation for pooled workers (dedicated
        actor workers get it via spawn env). Effective only while torch has
        not read the devices in this process: after that it keeps the ones
        it saw then (none, under the daemon's pin), so once the env names
        the lease's GPUs the count is checked, a promotion torch would not
        see is refused (``False``), and the daemon retires this worker
        instead of granting the lease."""
        from ray_tpu_torch.accelerators import get_accelerator_manager
        from ray_tpu_torch.accelerators.gpu import torch_sees

        mgr = get_accelerator_manager(payload["resource"])
        if mgr is not None:
            ids = payload.get("ids")
            if ids:
                # undo ONLY the daemon's GPU-less pin from spawn time
                # (the daemon grants the lease only after this reply):
                # restore the pre-pin value rather than clobbering an
                # operator-set CUDA_VISIBLE_DEVICES
                prepin = os.environ.pop("RAY_TPU_PREPIN_CUDA_VISIBLE_DEVICES", None)
                if prepin is not None:
                    if prepin:
                        os.environ["CUDA_VISIBLE_DEVICES"] = prepin
                    else:
                        os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                mgr.set_current_process_visible_accelerator_ids([str(i) for i in ids])
                if not torch_sees(len(ids)):
                    return False
        return True

    # execution services are registered when an executor is attached
    async def _decode_spec(self, entry) -> TaskSpec:
        """Rebuild a full TaskSpec from its wire form: template-spliced
        entries are ``("t", template_id, per-call)``; the invariant
        prefix is fetched from the control-plane KV once per template."""
        if isinstance(entry, TaskSpec):
            return entry
        _tag, tid, pc = entry
        tmpl = self._tmpl_cache.get(tid)
        if tmpl is None:
            from ray_tpu_torch.core.function_manager import (
                TEMPLATE_KV_PREFIX,
                template_from_payload,
            )

            payload = await self.controller.call(
                "kv_get",
                {"key": TEMPLATE_KV_PREFIX + tid},
                timeout=30,
                retries=GLOBAL_CONFIG.rpc_max_retries,
            )
            if payload is None:
                raise RayTpuError(f"unknown task template {tid.hex()}")
            tmpl = template_from_payload(tid, payload)
            self._tmpl_cache[tid] = tmpl
        return tmpl.from_percall(pc)

    async def w_push_batch(self, payload, conn):
        """Batched task push on a held lease: specs execute serially,
        one framed reply (lease-pipelining companion). Per-spec isolation:
        one task's packaging failure becomes ITS error reply — it must
        not discard batchmates' already-computed results by failing the
        whole RPC."""
        if self.executor is None:
            raise RuntimeError("this process does not execute tasks")
        # Per-spec decode isolation: an undecodable entry (template
        # missing from the KV) becomes ITS error reply — return ids are
        # recoverable from the per-call tuple without the template.
        specs: List[Any] = []
        decode_errors: Dict[int, Dict[str, Any]] = {}
        for idx, entry in enumerate(payload["specs"]):
            try:
                specs.append(await self._decode_spec(entry))
            except Exception as e:  # noqa: BLE001 — isolate batchmates
                logger.exception("spec decode failed in batch")
                err = TaskError("decode", e)
                ret_ids = entry[2][3] if not isinstance(entry, TaskSpec) else [
                    oid.binary() for oid in entry.return_ids
                ]
                decode_errors[idx] = {
                    "results": [(rid, "error", pickle.dumps(err)) for rid in ret_ids]
                }
                specs.append(None)
        live = [s for s in specs if s is not None]
        if decode_errors and (
            not live or any(s.kind == TaskKind.ACTOR_TASK for s in live)
        ):
            # Per-spec isolation is only safe for all-NORMAL batches: an
            # ordered actor's failed spec would leave a sequence-number
            # hole (its seq never advances) and wedge every batchmate in
            # _wait_turn. Fail the whole RPC instead — the owner's batch
            # error path fails all returns, no hang. (An all-failed
            # batch can't prove it wasn't an actor batch: same verdict.)
            raise RayTpuError("task template decode failed in actor batch")
        if not decode_errors:
            fast = self.executor.handle_push_batch_fast(live, conn=conn)
            if fast is not None:
                return {"replies": await fast}
        replies = []
        for idx, spec in enumerate(specs):
            if spec is None:
                replies.append(decode_errors[idx])
                continue
            try:
                replies.append(await self.executor.handle_push_task(spec, conn=conn))
            except Exception as e:  # noqa: BLE001
                logger.exception("task %s failed in batch", spec.name)
                err = TaskError(spec.name, e)
                if spec.num_returns == "streaming":
                    results = [(b"", "error", pickle.dumps(err))]
                else:
                    results = [
                        (oid.binary(), "error", pickle.dumps(err))
                        for oid in spec.return_ids
                    ]
                replies.append({"results": results})
        return {"replies": replies}

    async def w_push_task(self, payload, conn):
        if self.executor is None:
            raise RuntimeError("this process does not execute tasks")
        spec = await self._decode_spec(payload["spec"])
        return await self.executor.handle_push_task(spec, conn=conn)

    async def w_run_actor_creation(self, payload, conn):
        if self.executor is None:
            raise RuntimeError("this process does not execute tasks")
        return await self.executor.handle_actor_creation(payload["spec"])

    async def w_exit(self, payload, conn):
        import os

        self.io.loop.call_later(0.05, os._exit, 0)
        return True

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._stopping = True

        async def _teardown():
            # A class pump returns its lease as it exits. Wake the lingering
            # ones (their queues are empty) and let those returns land before
            # the clients close: a lease left behind keeps its CPU and GPU on
            # the node after this driver has gone.
            for q in self._class_queues.values():
                q.work.set()
            deadline = time.monotonic() + 2.0
            while (any(q.pumps for q in self._class_queues.values())
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.005)
            for t in self._pump_tasks:
                t.cancel()
            for c in self._clients.values():
                await c.close()
            await self.controller.close()
            await self.daemon.close()
            await self.server.stop()

        try:
            self.io.run(_teardown(), timeout=5)
        except Exception:
            pass
        self.shm.close_all()
        self.io.stop()
