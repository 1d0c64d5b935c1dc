"""Worker-side task execution engine.

Reference: ``core_worker/transport/task_receiver.h:91`` + the scheduling
queues — normal tasks FIFO on a single lane; actor tasks ordered per
caller by sequence number (``SequentialActorSubmitQueue``), thread-pool
lanes for ``max_concurrency`` / concurrency groups
(``ConcurrencyGroupManager``), an asyncio lane for async (coroutine)
actor methods (fibers, ``fiber.h``), and result packaging: small returns
inline in the reply, large returns into the node shm store
(reference: task output plasma promotion).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import execution, serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.exceptions import TaskCancelledError, TaskError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.task_spec import TaskKind, TaskSpec

logger = logging.getLogger(__name__)


class TaskExecutor:
    def __init__(self):
        self.core = None  # CoreWorker
        self.api_worker = None  # api.Worker
        self._lanes: Dict[str, ThreadPoolExecutor] = {}
        self._default_lane = ThreadPoolExecutor(max_workers=1, thread_name_prefix="exec")
        self._actor_instance: Any = None
        self._actor_spec: Optional[TaskSpec] = None
        self._max_concurrency = 1
        # per-caller ordering state: caller worker_id -> {next, cond}
        self._seq: Dict[bytes, Dict[str, Any]] = {}
        self._async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._async_sem: Optional[asyncio.Semaphore] = None
        # cancellation (``CoreWorker::CancelTask``): ids cancelled before
        # execution start + thread idents of tasks currently executing
        self._cancelled: set = set()
        self._running_threads: Dict[bytes, int] = {}
        # threads currently running a BATCH (handle_push_batch_fast):
        # async-exc delivery is unsafe there — a late exception would
        # land in a batchmate, not an idle retired thread
        self._batch_idents: set = set()
        self._cancel_lock = threading.Lock()
        self._env_gen = 0  # runtime-env application generation
        # streaming backpressure: owner-reported consumer positions
        self._stream_consumed: Dict[bytes, int] = {}
        self._stream_events: Dict[bytes, threading.Event] = {}
        self._stream_lock = threading.Lock()

    def bind(self, core, api_worker) -> None:
        self.core = core
        self.api_worker = api_worker

    # ------------------------------------------------------------------
    def _lane_for(self, spec: TaskSpec) -> ThreadPoolExecutor:
        if spec.concurrency_group and spec.concurrency_group in self._lanes:
            return self._lanes[spec.concurrency_group]
        return self._default_lane

    def _get_dep(self, ref) -> Any:
        values = self.core.get_objects([ref], timeout=None)
        value = values[0]
        if isinstance(value, Exception):
            raise value if isinstance(value, TaskError) else TaskError("dependency", value)
        return value

    # ------------------------------------------------------------------
    async def handle_actor_creation(self, spec: TaskSpec) -> Dict[str, Any]:
        # The daemon can dispatch creation while our registration reply is
        # still in flight; wait for the handshake to finish.
        for _ in range(500):
            if self.core is not None and self.core.address is not None:
                break
            await asyncio.sleep(0.01)
        self._actor_spec = spec
        self._max_concurrency = max(1, spec.max_concurrency)
        if self._max_concurrency > 1:
            self._default_lane = ThreadPoolExecutor(
                max_workers=self._max_concurrency, thread_name_prefix="actor"
            )
        for group, limit in (spec.concurrency_groups or {}).items():
            self._lanes[group] = ThreadPoolExecutor(max_workers=max(1, limit), thread_name_prefix=group)
        loop = asyncio.get_event_loop()

        def _create():
            self.api_worker.job_id = spec.job_id
            self.api_worker.current_actor_id = spec.actor_id
            self.api_worker.assigned_resources = dict(spec.resources or {})
            self.api_worker.set_task_context(spec.task_id, spec.job_id)
            # dedicated worker: runtime-env vars apply for its lifetime
            self._apply_runtime_env(spec)
            cls = self.api_worker.fn_table.load(spec.function_id)
            args, kwargs = execution.resolve_args(spec, self._get_dep)
            self._actor_instance = cls(*args, **kwargs)

        try:
            await loop.run_in_executor(self._default_lane, _create)
        except Exception as e:  # noqa: BLE001
            err = TaskError(spec.name, e)
            await self.core.controller.call(
                "actor_creation_failed",
                {
                    "actor_id": spec.actor_id,
                    "reason": f"creation failed: {e!r}",
                    "error": pickle.dumps(err),
                },
            )
            # exit so the daemon reaps this dedicated worker
            self.core.io.loop.call_later(0.1, _exit_now)
            return {"ok": False}
        await self.core.controller.call(
            "actor_ready",
            {"actor_id": spec.actor_id, "address": self.core.address},
        )
        return {"ok": True}

    # ------------------------------------------------------------------
    def _make_emit(self, spec: TaskSpec, conn):
        """Stream items push back over the submission connection, ordered
        by TCP (reference: generator returns stream through the reply
        channel, _raylet.pyx:1345). Shared by the normal-task and
        actor-task paths."""
        if spec.num_returns != "streaming" or conn is None:
            return None
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        from ray_tpu_torch.core.streaming import STREAM_PUSH_CHANNEL

        loop_ = asyncio.get_event_loop()

        def emit(payload):  # runs on the lane thread
            # inline items past the threshold ride a RAW push: the item
            # bytes travel out-of-band (zero pickle/msgpack of the bulk
            # on either end); the receiver reassembles envelope["data"]
            # and the owner-side handler is shape-identical
            raw_min = GLOBAL_CONFIG.rpc_raw_stream_min_bytes
            data = payload.get("data")
            if (
                raw_min >= 0
                and data is not None
                and len(data) >= raw_min
            ):
                envelope = {k: v for k, v in payload.items() if k != "data"}
                coro = conn.push_raw(STREAM_PUSH_CHANNEL, envelope, data)
            else:
                coro = conn.push(STREAM_PUSH_CHANNEL, payload)
            asyncio.run_coroutine_threadsafe(coro, loop_).result(timeout=60)

        return emit

    def handle_push_batch_fast(self, specs: List[TaskSpec], conn=None):
        """Single-dispatch batch execution, or None when the batch's
        shape needs the general per-spec path. A lane handoff costs two
        condvar hops (slow syscalls under load) — for a micro-task batch
        those dominate, so the whole batch rides ONE run_in_executor.

        Covered shapes: all plain non-streaming normal tasks, or all
        non-streaming sync methods of THIS ordered (max_concurrency==1,
        no concurrency groups) actor from one caller — the batch is
        executed serially in order, exactly like the per-spec path."""
        if len(specs) < 2:
            return None
        loop = asyncio.get_event_loop()
        if all(
            s.kind == TaskKind.NORMAL and s.num_returns != "streaming"
            for s in specs
        ):
            return loop.run_in_executor(
                self._default_lane, self._execute_batch, specs
            )
        if (
            self._max_concurrency == 1
            and not self._lanes
            and all(
                s.kind == TaskKind.ACTOR_TASK
                and s.num_returns != "streaming"
                and not s.concurrency_group
                and s.method_name
                and not s.method_name.startswith("__ray_")
                and not inspect.iscoroutinefunction(
                    getattr(self._actor_instance, s.method_name, None)
                )
                and s.owner is not None
                and s.owner.worker_id == specs[0].owner.worker_id
                for s in specs
            )
        ):
            return self._ordered_actor_batch(specs)
        return None

    async def _ordered_actor_batch(self, specs: List[TaskSpec]) -> List[Dict[str, Any]]:
        caller = specs[0].owner.worker_id
        await self._wait_turn(caller, specs[0].seq_no)
        loop = asyncio.get_event_loop()
        fut = loop.run_in_executor(self._default_lane, self._execute_batch, specs)
        # the whole batch occupies the single-thread lane serially, so
        # advancing all seqs now preserves the per-caller order contract
        # (exactly like per-spec dispatch into the same lane)
        for _ in specs:
            self._advance(caller)
        return await fut

    def _execute_batch(self, specs: List[TaskSpec]) -> List[Dict[str, Any]]:
        """Lane thread: run a batch serially with per-spec isolation.

        The thread registers itself as batch-running so cancel_task
        switches to cooperative-only delivery (the async-exc mechanism
        assumes a retired lane's thread goes idle after its one task —
        here it would poison a batchmate instead)."""
        ident = threading.get_ident()
        with self._cancel_lock:
            self._batch_idents.add(ident)
        try:
            replies = []
            for spec in specs:
                try:
                    replies.append({"results": self._execute(spec)})
                except Exception as e:  # noqa: BLE001 — isolate batchmates
                    logger.exception("task %s failed in batch", spec.name)
                    err = TaskError(spec.name, e)
                    replies.append(
                        {
                            "results": [
                                (oid.binary(), "error", pickle.dumps(err))
                                for oid in spec.return_ids
                            ]
                        }
                    )
            return replies
        finally:
            with self._cancel_lock:
                self._batch_idents.discard(ident)

    async def handle_push_task(self, spec: TaskSpec, conn=None) -> Dict[str, Any]:
        if spec.kind == TaskKind.ACTOR_TASK:
            return await self._handle_actor_task(spec, conn)
        logger.debug("executing %s %s", spec.name, spec.task_id.hex()[:8])
        emit = self._make_emit(spec, conn)

        # Normal tasks run on the pooled lane (thread spawn per task costs
        # real throughput). Cancellation safety: cancel_task delivers
        # TaskCancelledError via PyThreadState_SetAsyncExc and immediately
        # RETIRES the lane (fresh pool) — a stray exception firing after
        # the task finished lands in the abandoned pool's thread, never in
        # a later task. The lane holds at most the one running task (the
        # lease protocol serializes pushes), so nothing queued is lost.
        loop = asyncio.get_event_loop()
        results = await loop.run_in_executor(
            self._default_lane, self._execute, spec, emit
        )
        logger.debug("finished %s %s", spec.name, spec.task_id.hex()[:8])
        return {"results": results}

    async def _handle_actor_task(self, spec: TaskSpec, conn=None) -> Dict[str, Any]:
        # a built-in call or a compiled graph's loop carries a sequence
        # number of its caller's like any call: it takes and advances the
        # caller's turn, or every later call from that handle waits for it
        caller = spec.owner.worker_id if spec.owner else b""
        ordered = self._max_concurrency == 1 and not spec.concurrency_group
        # built-in methods
        if spec.method_name == "__ray_ready__":
            if ordered:
                await self._wait_turn(caller, spec.seq_no)
                self._advance(caller)
            return {"results": self._package(spec, [(spec.return_ids[0], True)])}
        if spec.method_name == "__ray_terminate__":
            reply = {"results": self._package(spec, [(spec.return_ids[0], None)])}
            self.core.io.loop.call_later(0.05, _exit_now)
            return reply
        if spec.method_name == "__ray_dag_loop__":
            # compiled-graph loop (``dag/compiled.py``): occupies the
            # default lane until the driver tears the DAG down — the
            # reply to this call IS the loop's exit signal
            from ray_tpu_torch.dag.compiled import run_dag_loop

            loop = asyncio.get_event_loop()

            def _run_loop():
                args, _kwargs = execution.resolve_args(spec, self._get_dep)
                run_dag_loop(self._actor_instance, args[0])

            if ordered:
                await self._wait_turn(caller, spec.seq_no)
            fut = loop.run_in_executor(self._default_lane, _run_loop)
            if ordered:
                self._advance(caller)
            try:
                await fut
                pairs = [(spec.return_ids[0], None)]
            except Exception as e:  # noqa: BLE001
                pairs = [(spec.return_ids[0], TaskError(spec.name, e))]
            return {"results": await loop.run_in_executor(None, self._package, spec, pairs)}
        method = getattr(self._actor_instance, spec.method_name, None)
        if method is None:
            err = TaskError(spec.name, AttributeError(f"no method {spec.method_name!r}"))
            return {"results": [(oid.binary(), "error", pickle.dumps(err)) for oid in spec.return_ids]}
        if spec.num_returns == "streaming" and inspect.iscoroutinefunction(method):
            err = TaskError(
                spec.name,
                TypeError(
                    "streaming actor method must be a (sync or async) "
                    "generator, not a coroutine returning a value"
                ),
            )
            from ray_tpu_torch.core.streaming import streaming_error_result

            return {"results": [streaming_error_result(err)]}
        if inspect.iscoroutinefunction(method):
            try:
                self._apply_runtime_env(spec)  # dedicated worker: permanent
            except Exception as e:  # noqa: BLE001 — malformed runtime_env
                err = TaskError(spec.name, ValueError(f"bad runtime_env: {e!r}"))
                return {
                    "results": [
                        (oid.binary(), "error", pickle.dumps(err))
                        for oid in spec.return_ids
                    ]
                }
            return await self._run_async_method(spec, method)
        emit = self._make_emit(spec, conn)
        if ordered:
            await self._wait_turn(caller, spec.seq_no)
            # submission order into the single-thread lane = execution order
            loop = asyncio.get_event_loop()
            fut = loop.run_in_executor(self._lane_for(spec), self._execute, spec, emit)
            self._advance(caller)
            results = await fut
        else:
            loop = asyncio.get_event_loop()
            results = await loop.run_in_executor(self._lane_for(spec), self._execute, spec, emit)
        return {"results": results}

    async def _wait_turn(self, caller: bytes, seq: int) -> None:
        state = self._seq.get(caller)
        if state is None:
            # Baseline at the first sequence number seen from this caller:
            # after an actor restart the caller's counter keeps counting,
            # so starting from 1 would deadlock (reference handles this via
            # caller_starts_at in the actor submit queue).
            state = self._seq[caller] = {"next": seq, "cond": asyncio.Condition()}
        async with state["cond"]:
            await state["cond"].wait_for(lambda: state["next"] >= seq)

    def _advance(self, caller: bytes) -> None:
        state = self._seq.get(caller)
        if state is None:
            return

        async def _notify():
            async with state["cond"]:
                state["next"] += 1
                state["cond"].notify_all()

        asyncio.ensure_future(_notify())

    async def _run_async_method(self, spec: TaskSpec, method) -> Dict[str, Any]:
        """Async actor methods run on a dedicated loop with a
        max_concurrency semaphore (reference: fibers for async actors)."""
        if self._async_loop is None:
            self._async_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._async_loop.run_forever, daemon=True, name="actor-async")
            t.start()
            # user coroutines run here: a method that blocks this loop
            # stalls every other async call on the actor — watchdog it
            from ray_tpu_torch.observability.event_stats import install_loop_monitor

            install_loop_monitor(self._async_loop, "actor-async")

        loop0 = asyncio.get_event_loop()
        # Arg resolution can block on remote objects — keep it off the io
        # loop. Pure-inline args (the common small-call shape) can't
        # block: resolve them right here and skip the thread hop.
        if any(t == "ref" for t, _ in spec.args) or any(
            t == "ref" for t, _k, _v in spec.kwargs
        ):
            args, kwargs = await loop0.run_in_executor(
                None, execution.resolve_args, spec, self._get_dep
            )
        else:
            args, kwargs = execution.resolve_args(spec, self._get_dep)

        async def _run():
            # Per-coroutine task context (ContextVar) so puts made inside the
            # async method derive ObjectIDs from THIS task's id, not the
            # deterministic driver id — two async actors in one job would
            # otherwise mint colliding ObjectIDs (shm segments are named by
            # ObjectID, so a collision silently overwrites data).
            from ray_tpu_torch.core.deadline import deadline_scope
            from ray_tpu_torch.observability import tracing as _tracing

            self.api_worker.job_id = spec.job_id
            self.api_worker.set_task_context(spec.task_id, spec.job_id)
            if self._async_sem is None:
                self._async_sem = asyncio.Semaphore(max(1, self._max_concurrency))
            async with self._async_sem:
                with deadline_scope(spec.deadline_remaining_s):
                    if spec.trace_ctx is not None:
                        # async actor methods (e.g. serve replicas) get
                        # the same causal re-entry as lane-thread tasks
                        with _tracing.scope(spec.trace_ctx), _tracing.span(
                            f"task::{spec.name}", "task",
                            task_id=spec.task_id.hex()[:16],
                        ):
                            return await method(*args, **kwargs)
                    return await method(*args, **kwargs)

        cfut = asyncio.run_coroutine_threadsafe(_run(), self._async_loop)
        loop = asyncio.get_event_loop()
        try:
            # await the cross-loop future directly — the old
            # run_in_executor(None, cfut.result) parked an executor
            # thread per in-flight call (two futex hops each)
            result = await asyncio.wrap_future(cfut)
            pairs = execution.unpack_returns(spec, result)
        except Exception as e:  # noqa: BLE001
            err = TaskError(spec.name, e)
            pairs = [(oid, err) for oid in spec.return_ids]
        # _package can RPC the daemon (large results) — keep it off the io loop
        return {"results": await loop.run_in_executor(None, self._package, spec, pairs)}

    # ------------------------------------------------------------------
    def _execute(self, spec: TaskSpec, emit=None) -> List[Tuple[bytes, str, Any]]:
        """Runs on a lane thread. Returns packaged results."""
        from ray_tpu_torch.core.deadline import deadline_scope
        from ray_tpu_torch.observability import timeline as _timeline
        from ray_tpu_torch.observability import tracing as _tracing
        from ray_tpu_torch.observability.rpc_metrics import TASK_STAGE_SECONDS

        _start_us = _timeline._now_us()
        try:
            # re-enter the submitter's remaining budget: nested get()/wait()
            # inside this task inherit the caller's deadline (deadline
            # propagation, hang defense). Traced specs additionally
            # re-enter the submitter's TRACE: this task's span parents to
            # the caller's, and everything nested under it (submits of
            # child tasks, actor calls, RPCs) parents to this task's span
            # — the cross-process causal chain.
            if spec.trace_ctx is not None:
                with _tracing.scope(spec.trace_ctx), _tracing.span(
                    f"task::{spec.name}", "task",
                    task_id=spec.task_id.hex()[:16],
                ), deadline_scope(spec.deadline_remaining_s):
                    return self._execute_inner(spec, emit)
            with deadline_scope(spec.deadline_remaining_s):
                return self._execute_inner(spec, emit)
        finally:
            end_us = _timeline._now_us()
            TASK_STAGE_SECONDS.observe(
                (end_us - _start_us) / 1e6, labels={"stage": "execute"}
            )
            if spec.trace_ctx is None:
                # traced specs already recorded their span above — one
                # event per execution either way
                _timeline.record_event(
                    f"task::{spec.name}",
                    "task",
                    _start_us,
                    end_us,
                    args={"task_id": spec.task_id.hex()[:16]},
                )

    def _apply_runtime_env(self, spec: TaskSpec):
        """Minimal runtime-env support (reference
        ``_private/runtime_env/``): ``env_vars`` apply for the task's
        duration on pooled workers (restored afterwards — the pool is
        shared) and permanently on dedicated actor workers. Returns a
        restore callable or None.

        The restore is generation-guarded: a cancelled task's thread can
        overlap the next task briefly (retired-lane window), and a stale
        restore must not clobber the newer task's environment. Nested
        overlap can still leave the older values applied — the reference
        avoids this class of problem entirely by dedicating workers per
        runtime env, which is the upgrade path here too."""
        env = spec.runtime_env or {}
        if not env:
            return None
        from ray_tpu_torch.runtime_env import apply_runtime_env

        permanent = spec.kind != TaskKind.NORMAL or spec.actor_id is not None
        restores = apply_runtime_env(
            env, self.api_worker.backend.kv_get, permanent=permanent
        )
        if not restores:
            return None
        self._env_gen += 1
        my_gen = self._env_gen

        def restore():
            if self._env_gen != my_gen:
                return  # a newer task re-applied an env: don't clobber
            for r in restores:
                r()

        return restore

    def update_stream_consumed(self, task_id: bytes, consumed: int) -> None:
        """Owner's consumer-position report: wakes a producer paused on
        backpressure (reference stream consumer-position protocol)."""
        with self._stream_lock:
            ev = self._stream_events.get(task_id)
            if ev is None:
                return  # stream finished: a late report must not re-insert
            if consumed > self._stream_consumed.get(task_id, 0):
                self._stream_consumed[task_id] = consumed
        ev.set()

    def cancel_task(self, task_id: bytes, force: bool) -> bool:
        """Cooperative (or forced) cancellation (``CoreWorker::CancelTask``).

        Queued tasks are marked and rejected at the dep-resolution /
        execution boundary; a RUNNING task gets TaskCancelledError raised
        asynchronously in its lane thread; ``force`` exits the worker
        process (the daemon reaps it, the submitter sees the connection
        drop)."""
        if force:
            self.core.io.loop.call_later(0.05, _exit_now)
            return True
        with self._cancel_lock:
            self._cancelled.add(task_id)
            ident = self._running_threads.get(task_id)
            if ident is not None and ident in self._batch_idents:
                # Batch-running thread: async-exc could land in a
                # batchmate (the thread is NOT idle after the target
                # finishes). Cooperative-only — queued batchmates see
                # the cancel mark at their execution boundary; the
                # running task completes (force=True still kills the
                # process).
                ident = None
        if ident is not None:
            import ctypes

            # Retire the lane BEFORE delivering: if the exception fires
            # after the task completes, it lands in the abandoned pool's
            # (now-idle) thread instead of poisoning the next task.
            # shutdown(wait=False) wakes an idle old thread so it exits
            # rather than parking forever with the exc pending.
            old = self._default_lane
            self._default_lane = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="exec"
            )
            old.shutdown(wait=False)
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError)
            )
        return True

    def _execute_inner(self, spec: TaskSpec, emit=None) -> List[Tuple[bytes, str, Any]]:
        self.api_worker.job_id = spec.job_id
        self.api_worker.set_task_context(spec.task_id, spec.job_id)
        if spec.kind != TaskKind.ACTOR_TASK:  # actors keep creation-time resources
            self.api_worker.assigned_resources = dict(spec.resources or {})
        tid = spec.task_id.binary()

        def error_results(err) -> List[Tuple[bytes, str, Any]]:
            # streaming specs have no fixed return ids: the error must
            # still reach the owner (as a stream failure) or the consumer
            # blocks forever on a stream that never finalizes
            if spec.num_returns == "streaming":
                from ray_tpu_torch.core.streaming import streaming_error_result

                return [streaming_error_result(err)]
            return [
                (oid.binary(), "error", pickle.dumps(err))
                for oid in spec.return_ids
            ]

        with self._cancel_lock:
            if tid in self._cancelled:
                self._cancelled.discard(tid)  # consumed — don't grow forever
                return error_results(TaskCancelledError(spec.task_id.hex()[:16]))
            if len(self._cancelled) > 4096:
                self._cancelled.clear()  # stale marks on a long-lived worker
            if spec.kind != TaskKind.ACTOR_TASK:
                # only normal tasks are async-exc cancellable (actor tasks
                # share pooled lane threads where a stray exception would
                # poison peers)
                self._running_threads[tid] = threading.get_ident()
        if spec.kind != TaskKind.ACTOR_TASK:
            self.core.emit_task_event(spec, "RUNNING")
        env_restore = None
        try:
            try:
                env_restore = self._apply_runtime_env(spec)
            except Exception as e:  # noqa: BLE001 — malformed runtime_env
                return error_results(
                    TaskError(spec.name, ValueError(f"bad runtime_env: {e!r}"))
                )
            try:
                if spec.kind == TaskKind.ACTOR_TASK:
                    fn = getattr(self._actor_instance, spec.method_name)
                else:
                    fn = self.api_worker.fn_table.load(spec.function_id)
                args, kwargs = execution.resolve_args(spec, self._get_dep)
            except TaskCancelledError:
                return error_results(TaskCancelledError(spec.task_id.hex()[:16]))
            except Exception as e:  # noqa: BLE001
                err = e if isinstance(e, TaskError) else TaskError(spec.name, e)
                return error_results(err)
            if spec.num_returns == "streaming":
                return self._execute_streaming(spec, fn, args, kwargs, emit)
            pairs = execution.run_function(spec, fn, args, kwargs)
        finally:
            with self._cancel_lock:
                self._running_threads.pop(tid, None)
            if env_restore is not None:
                env_restore()
        # (env restore is generation-guarded: see _apply_runtime_env)
        # An async-raised TaskCancelledError lands as the TaskError cause:
        # surface it as the cancellation itself, not an app failure.
        out: List[Tuple[ObjectID, Any]] = []
        for oid, value in pairs:
            if isinstance(value, TaskError) and isinstance(
                getattr(value, "cause", None), TaskCancelledError
            ):
                value = TaskCancelledError(spec.task_id.hex()[:16])
            out.append((oid, value))
        return self._package(spec, out)

    def _execute_streaming(
        self, spec: TaskSpec, fn, args, kwargs, emit
    ) -> List[Tuple[bytes, str, Any]]:
        """Generator task: each yielded value becomes an ObjectRef pushed
        to the owner IMMEDIATELY (consumable before the task finishes);
        the reply carries only the end-of-stream marker."""
        from ray_tpu_torch.core.streaming import streaming_error_result

        if emit is None:
            err = TaskError(
                spec.name,
                RuntimeError("streaming task executed without a stream channel"),
            )
            return [streaming_error_result(err)]
        tid = spec.task_id.binary()
        threshold = GLOBAL_CONFIG.streaming_generator_backpressure_items
        if threshold > 0:
            with self._stream_lock:
                self._stream_events[tid] = threading.Event()
        count = 0
        result = None
        try:
            result = fn(*args, **kwargs)
            if inspect.isasyncgen(result):
                # async generator driven from this lane thread on a
                # private loop (reference: async streaming replicas)
                result = _drain_async_gen(result)
            elif not inspect.isgenerator(result) and not hasattr(result, "__iter__"):
                raise TypeError(
                    f"num_returns='streaming' task {spec.name} must return "
                    f"a generator/iterable, got {type(result).__name__}"
                )
            for value in result:
                count += 1
                # cooperative cancel consulted on EVERY item, not only in
                # the backpressure wait below: an abandoned stream (the
                # consumer's ObjectRefGenerator was dropped/closed — e.g.
                # an HTTP client disconnected mid-SSE) must stop the
                # producer within one item, not after it outruns the
                # consumer by a full backpressure window. The finally
                # close()s the generator, so a producer built on
                # engine.generate() runs its cancel() cleanup and frees
                # its KV blocks promptly.
                with self._cancel_lock:
                    if tid in self._cancelled:
                        self._cancelled.discard(tid)
                        raise TaskCancelledError(spec.task_id.hex()[:16])
                # producer-side backpressure: pause while the consumer
                # lags by more than the threshold; the owner's consumed
                # reports (w_stream_consumed) resume us. Cancellation is
                # still honored while paused.
                if threshold > 0:
                    while (
                        count - self._stream_consumed.get(tid, 0) > threshold
                    ):
                        with self._cancel_lock:
                            if tid in self._cancelled:
                                self._cancelled.discard(tid)
                                raise TaskCancelledError(spec.task_id.hex()[:16])
                        ev = self._stream_events.get(tid)
                        if ev is None:
                            break
                        ev.clear()
                        if count - self._stream_consumed.get(tid, 0) <= threshold:
                            break
                        ev.wait(0.5)
                oid = ObjectID.from_index(spec.task_id, count)
                kind, payload = self._store_value(oid, value, spec.name)
                if kind == "error":
                    return [streaming_error_result(pickle.loads(payload))]
                emit(
                    {
                        "task_id": spec.task_id.binary(),
                        "index": count,
                        "object_id": oid.binary(),
                        "kind": kind,
                        "data" if kind == "inline" else "location": payload,
                    }
                )
        except TaskCancelledError as e:
            # surfaced as the cancellation itself (the owner usually
            # abandoned the stream and isn't reading), not an app failure
            return [streaming_error_result(e)]
        except Exception as e:  # noqa: BLE001
            err = e if isinstance(e, TaskError) else TaskError(spec.name, e)
            return [streaming_error_result(err)]
        finally:
            # Close the producer DETERMINISTICALLY (not on GC): a cancel/
            # error exit leaves the generator suspended at its last yield,
            # and its finally blocks (engine.generate -> engine.cancel,
            # replica ongoing-count decrement) must run before this task
            # slot is reported free.
            close = getattr(result, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — cleanup must not mask
                    pass
            with self._stream_lock:
                self._stream_consumed.pop(tid, None)
                self._stream_events.pop(tid, None)
        return [(b"", "stream_end", count)]

    def _store_value(self, oid: ObjectID, value: Any, name: str = "") -> Tuple[str, Any]:
        """Promote one result value: inline bytes under the threshold,
        else a sealed shm object adopted by the daemon. Shared by the
        reply packager and the streaming item path so the promotion
        protocol can never diverge between them."""
        try:
            ser = serialization.serialize(value)
        except Exception as e:  # noqa: BLE001
            return ("error", pickle.dumps(TaskError(name or "serialize", e)))
        # results use their own inline ceiling (inline returns ride the
        # task-done reply to the owner's in-process cache; puts/args keep
        # max_direct_call_object_size)
        if ser.total_bytes <= GLOBAL_CONFIG.inline_result_threshold_bytes:
            return ("inline", ser.to_bytes())
        size = self.core.shm.create_and_write(oid, ser)
        self.core.io.run(
            self.core.daemon.call(
                "adopt_object", {"object_id": oid.binary(), "size": size}
            )
        )
        self.core.shm.release(oid)
        return ("shm", self.core._self_location())

    def _package(self, spec: TaskSpec, pairs: List[Tuple[ObjectID, Any]]) -> List[Tuple[bytes, str, Any]]:
        out: List[Tuple[bytes, str, Any]] = []
        for oid, value in pairs:
            if isinstance(value, (TaskError, TaskCancelledError)):
                out.append((oid.binary(), "error", pickle.dumps(value)))
                continue
            kind, payload = self._store_value(oid, value, spec.name)
            out.append((oid.binary(), kind, payload))
        return out


def _drain_async_gen(agen):
    """Sync iterator over an async generator, driven on a private event
    loop owned by the calling (lane) thread."""
    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                yield loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                return
    finally:
        loop.run_until_complete(agen.aclose())
        loop.close()


def _exit_now():
    import os

    os._exit(0)
