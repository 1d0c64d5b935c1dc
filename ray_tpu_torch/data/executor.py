"""Streaming execution over the task pool and actor pools.

Reference: ``data/_internal/execution/streaming_executor.py:48,89`` +
``operators/task_pool_map_operator.py`` + ``actor_pool_map_operator.py``
+ ``backpressure_policy/`` — blocks stream through remote tasks with
bounded in-flight work, consecutive map stages FUSE into one task per
block (MapFusion), stateful stages run on an autoscaling actor pool, and
admission control is keyed to OBJECT STORE USAGE (not a constant): the
driver polls the node daemon's store stats and pauses submission while
the store sits above the spill threshold, so a 10x-oversized dataset
streams through a capacity-limited store instead of flooding it.

A *source* is either a no-arg read callable (fresh execution) or an
ObjectRef to an existing block (re-transforming materialized data): ref
sources are passed as task *arguments* so the dependency protocol
fetches them on the executing worker.

The executor yields block ObjectRefs as they become ready — consumption
(iter_batches / streaming_split) overlaps with production."""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, normalize_block

#: a transform maps one block to one block (fused chains compose)
Transform = Callable[[Block], Block]
#: read callable or a block ref
Source = Union[Callable[[], Any], "ray_tpu_torch.ObjectRef"]


# ---------------------------------------------------------------------------
# stages


class FusedStage:
    """A chain of block→block transforms executed as ONE task per block."""

    def __init__(self, transforms: Optional[List[Transform]] = None):
        self.transforms: List[Transform] = list(transforms or [])

    def chained(self, t: Transform) -> "FusedStage":
        return FusedStage(self.transforms + [t])


class ActorStage:
    """A stateful map stage on an autoscaling actor pool (reference
    ``ActorPoolMapOperator``): ``cls`` is constructed once per pool actor
    and its ``__call__`` maps blocks."""

    def __init__(self, cls, cls_args, cls_kwargs, strategy, batch_size=None):
        self.cls = cls
        self.cls_args = cls_args or ()
        self.cls_kwargs = cls_kwargs or {}
        self.strategy = strategy
        self.batch_size = batch_size


class ActorPoolStrategy:
    """``compute=`` argument for stateful ``map_batches`` (reference
    ``ray.data.ActorPoolStrategy``)."""

    def __init__(self, size: Optional[int] = None, *, min_size: int = 1, max_size: Optional[int] = None):
        if size is not None:
            min_size = max_size = size
        self.min_size = max(1, min_size)
        self.max_size = max_size or max(self.min_size, 4)


# ---------------------------------------------------------------------------
# fused-task submission


def _fused_task(read_fn, block, transforms: Sequence[Transform]) -> Block:
    out = normalize_block(block if read_fn is None else read_fn())
    for t in transforms:
        out = normalize_block(t(out))
    return out


_fused_remote = None


def _get_remote():
    global _fused_remote
    if _fused_remote is None:
        _fused_remote = ray_tpu_torch.remote(num_cpus=1)(_fused_task)
    return _fused_remote


def _submit(source: Source, transforms: Sequence[Transform]):
    remote_fn = _get_remote()
    if isinstance(source, ray_tpu_torch.ObjectRef):
        # ref source: ship as an arg so the dep protocol fetches the block
        return remote_fn.remote(None, source, list(transforms))
    return remote_fn.remote(source, None, list(transforms))


# ---------------------------------------------------------------------------
# backpressure: admission keyed to store usage


class StoreBackpressure:
    """Pause submissions while the shared object store sits above its
    spill threshold (reference ``backpressure_policy/``): the store stats
    come from the node daemon and are cached briefly. Always admits at
    least one in-flight task so the pipeline cannot deadlock."""

    def __init__(self, poll_period_s: float = 0.25, fraction: float = None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        self._period = poll_period_s
        self._fraction = (
            fraction
            if fraction is not None
            else GLOBAL_CONFIG.object_spilling_threshold
        )
        self._last_poll = 0.0
        self._full = False

    def store_full(self) -> bool:
        now = time.monotonic()
        if now - self._last_poll >= self._period:
            self._last_poll = now
            self._full = self._query()
        return self._full

    def _query(self) -> bool:
        try:
            from ray_tpu_torch.core.api import get_global_worker_or_none

            w = get_global_worker_or_none()
            core = getattr(w, "backend", None) if w else None
            daemon = getattr(core, "daemon", None)
            io = getattr(core, "io", None)
            if daemon is None or io is None:
                return False
            stats = io.run(daemon.call("stats", timeout=5), timeout=6)["store"]
            cap = stats.get("capacity_bytes") or 1
            return (stats.get("used_bytes", 0) / cap) >= self._fraction
        except Exception:
            return False  # stats unavailable: fall back to inflight cap


# ---------------------------------------------------------------------------
# streaming drivers


def execute_streaming(
    sources: Sequence[Source],
    transforms: Sequence[Transform],
    *,
    max_inflight: int = 8,
) -> Iterator["ray_tpu_torch.ObjectRef"]:
    """Run ``transforms`` fused over every source; yield block refs in
    SOURCE order (reference ray.data preserves block order, so take()/
    limit() are deterministic) with at most ``max_inflight`` tasks
    outstanding AND submission paused while the store is over threshold.
    Later tasks keep running while the head block is awaited — order
    costs no pipeline parallelism, only yield order."""
    if not transforms and sources and all(
        isinstance(s, ray_tpu_torch.ObjectRef) for s in sources
    ):
        # materialized + no work: the blocks ARE the result
        yield from sources
        return
    bp = StoreBackpressure()
    pending: List[Any] = []
    idx = 0
    n = len(sources)
    while idx < n or pending:
        while idx < n and len(pending) < max_inflight:
            if pending and bp.store_full():
                break  # let the consumer drain before admitting more
            pending.append(_submit(sources[idx], transforms))
            idx += 1
        head = pending.pop(0)
        ray_tpu_torch.wait([head], num_returns=1, timeout=None, fetch_local=False)
        yield head


def execute_all(
    sources: Sequence[Source],
    transforms: Sequence[Transform],
    *,
    max_inflight: int = 8,
) -> List["ray_tpu_torch.ObjectRef"]:
    return list(execute_streaming(sources, transforms, max_inflight=max_inflight))


# ---------------------------------------------------------------------------
# actor-pool stage driver


class _PoolActorWrapper:
    """Worker-side wrapper: constructs the user's callable class once,
    then maps blocks (optionally re-chunked) through it."""

    def __init__(self, cls, args, kwargs, batch_size):
        self._fn = cls(*args, **kwargs)
        self._batch_size = batch_size

    def apply(self, block: Block) -> Block:
        from ray_tpu_torch.data.block import apply_batched

        if self._batch_size is None:
            return normalize_block(self._fn(block))
        return apply_batched(self._fn, block, self._batch_size)


def _ref_death_error(ref) -> Optional[Exception]:
    """Owner-side peek: the worker/actor-death error a ref resolved to,
    or None. No data fetch — the driver owns stage refs, so failure
    state is local (ownership table)."""
    try:
        from ray_tpu_torch.core.api import get_global_worker_or_none
        from ray_tpu_torch.core.exceptions import ActorDiedError, WorkerCrashedError
        from ray_tpu_torch.core.ownership import ObjState

        w = get_global_worker_or_none()
        rc = getattr(getattr(w, "backend", None), "refcounter", None)
        if rc is None or not rc.owns(ref.id()):
            return None
        obj = rc.get(ref.id())
        if obj is not None and obj.state == ObjState.FAILED and isinstance(
            obj.error, (ActorDiedError, WorkerCrashedError)
        ):
            return obj.error
    except Exception:
        return None
    return None


def execute_actor_stage(
    upstream: Iterator["ray_tpu_torch.ObjectRef"],
    stage: ActorStage,
    *,
    per_actor_inflight: int = 2,
    max_block_retries: int = 3,
) -> Iterator["ray_tpu_torch.ObjectRef"]:
    """Stream upstream blocks through an autoscaling pool of stateful
    actors. The pool starts at ``min_size`` and grows (up to
    ``max_size``) whenever every actor is saturated and more input is
    waiting; actors die with their handles when the stage completes.

    Fault tolerance: a pool actor dying mid-block (preempted node, OOM
    kill) fails every ref in flight on it — each such block is
    resubmitted to a surviving (or freshly spawned) pool actor, up to
    ``max_block_retries`` attempts per block, instead of failing the
    stage. The input block ref is retained until its result is emitted,
    so the retry re-reads the same upstream data."""
    strategy: ActorPoolStrategy = stage.strategy
    remote_cls = ray_tpu_torch.remote(num_cpus=1)(_PoolActorWrapper)

    def spawn():
        return remote_cls.remote(
            stage.cls, tuple(stage.cls_args), dict(stage.cls_kwargs), stage.batch_size
        )

    pool = [spawn() for _ in range(strategy.min_size)]
    inflight: List[List[Any]] = [[] for _ in pool]  # per-actor pending refs
    out_order: List[Any] = []  # result refs in submission order
    #: result ref -> (input block ref, pool index, attempts so far)
    ref_meta: dict = {}
    bp = StoreBackpressure()

    def least_loaded() -> int:
        return min(range(len(pool)), key=lambda i: len(inflight[i]))

    def reap_done() -> None:
        for lst in inflight:
            while lst and ray_tpu_torch.wait([lst[0]], num_returns=1, timeout=0)[0]:
                lst.pop(0)

    def submit(block_ref, attempts: int = 0):
        i = least_loaded()
        ref = pool[i].apply.remote(block_ref)
        inflight[i].append(ref)
        ref_meta[ref] = (block_ref, pool[i], attempts)
        return ref

    def recover(ref):
        """Resubmit a death-failed result elsewhere; replace the corpse
        in place (once — later failed refs from the same actor find it
        already gone from the pool and simply resubmit)."""
        block_ref, dead, attempts = ref_meta.pop(ref)
        if dead in pool:
            i = pool.index(dead)
            pool[i] = spawn()
            inflight[i] = []
        return submit(block_ref, attempts + 1)

    upstream_iter = iter(upstream)
    exhausted = False
    emitted = 0
    while True:
        # admit while there is capacity (and the store isn't full);
        # backpressure keys on UNCONSUMED work — with nothing in flight
        # and nothing to yield, admission must proceed or the loop would
        # busy-spin forever against a full store
        while not exhausted:
            reap_done()
            i = least_loaded()
            if len(inflight[i]) >= per_actor_inflight:
                if len(pool) < strategy.max_size:
                    pool.append(spawn())
                    inflight.append([])
                    continue
                break
            if len(out_order) > emitted and bp.store_full():
                break
            try:
                block_ref = next(upstream_iter)
            except StopIteration:
                exhausted = True
                break
            out_order.append(submit(block_ref))
        if emitted < len(out_order):
            head = out_order[emitted]
            while True:
                ray_tpu_torch.wait([head], num_returns=1, timeout=None, fetch_local=False)
                err = _ref_death_error(head)
                if err is None:
                    break
                _b, _a, attempts = ref_meta.get(head, (None, None, max_block_retries))
                if attempts >= max_block_retries:
                    break  # exhausted: the failure propagates to the consumer
                head = recover(head)
            ref_meta.pop(head, None)
            out_order[emitted] = None  # don't pin emitted blocks for the stage lifetime
            emitted += 1
            yield head
            continue
        if exhausted:
            break
    # pool handles drop here → actors terminate gracefully (handle GC)


def execute_pipeline(
    sources: Sequence[Source],
    stages: Sequence[Any],
    *,
    max_inflight: int = 8,
) -> Iterator["ray_tpu_torch.ObjectRef"]:
    """Compose the stage list into one streaming iterator: consecutive
    FusedStages were already merged by the Dataset; ActorStages stream
    between them."""
    stream: Optional[Iterator[Any]] = None
    first = True
    for stage in stages:
        if isinstance(stage, FusedStage):
            if first:
                stream = execute_streaming(
                    sources, stage.transforms, max_inflight=max_inflight
                )
            else:
                stream = _refs_through_tasks(stream, stage.transforms, max_inflight)
        elif isinstance(stage, ActorStage):
            if first:
                stream = execute_streaming(sources, [], max_inflight=max_inflight)
            stream = execute_actor_stage(stream, stage)
        else:
            raise TypeError(f"unknown stage {stage!r}")
        first = False
    if stream is None:
        stream = execute_streaming(sources, [], max_inflight=max_inflight)
    return stream


def _refs_through_tasks(
    upstream: Iterator["ray_tpu_torch.ObjectRef"],
    transforms: Sequence[Transform],
    max_inflight: int,
) -> Iterator["ray_tpu_torch.ObjectRef"]:
    """Fused transforms applied to an upstream ref stream."""
    if not transforms:
        yield from upstream
        return
    bp = StoreBackpressure()
    pending: List[Any] = []
    upstream_iter = iter(upstream)
    exhausted = False
    while not exhausted or pending:
        while not exhausted and len(pending) < max_inflight:
            if pending and bp.store_full():
                break
            try:
                src = next(upstream_iter)
            except StopIteration:
                exhausted = True
                break
            pending.append(_submit(src, transforms))
        if not pending:
            continue
        head = pending.pop(0)
        ray_tpu_torch.wait([head], num_returns=1, timeout=None, fetch_local=False)
        yield head
