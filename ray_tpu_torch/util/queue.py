"""Distributed FIFO queue backed by an actor.

Reference: ``python/ray/util/queue.py`` — ``Queue`` with
put/get/put_nowait/get_nowait/size/empty/full, usable from any worker
(the handle pickles; the state lives in one queue actor).
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio
        from collections import deque

        self._maxsize = maxsize
        self._q = deque()
        self._not_empty = asyncio.Condition()
        self._not_full = asyncio.Condition()

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        import asyncio

        async with self._not_full:
            if self._maxsize > 0:
                try:
                    await asyncio.wait_for(
                        self._not_full.wait_for(
                            lambda: len(self._q) < self._maxsize
                        ),
                        timeout,
                    )
                except asyncio.TimeoutError:
                    return False
            self._q.append(item)
        async with self._not_empty:
            self._not_empty.notify()
        return True

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        async with self._not_empty:
            try:
                await asyncio.wait_for(
                    self._not_empty.wait_for(lambda: len(self._q) > 0), timeout
                )
            except asyncio.TimeoutError:
                return (False, None)
            item = self._q.popleft()
        async with self._not_full:
            self._not_full.notify()
        return (True, item)

    async def qsize(self) -> int:
        return len(self._q)


QueueActor = ray_tpu_torch.remote(_QueueActor)


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        opts.setdefault("max_concurrency", 16)
        self._actor = QueueActor.options(**opts).remote(maxsize)

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        ok = ray_tpu_torch.get(self._actor.put.remote(item, timeout), timeout=None)
        if not ok:
            raise Full("queue full")

    def put_nowait(self, item: Any) -> None:
        self.put(item, timeout=0.001)

    def get(self, timeout: Optional[float] = None) -> Any:
        ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout), timeout=None)
        if not ok:
            raise Empty("queue empty")
        return item

    def get_nowait(self) -> Any:
        return self.get(timeout=0.001)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def get_batch(self, n: int, timeout: Optional[float] = None) -> List[Any]:
        return [self.get(timeout) for _ in range(n)]

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass

    def __reduce__(self):
        return (_rebuild_queue, (self.maxsize, self._actor))


def _rebuild_queue(maxsize, actor):
    q = object.__new__(Queue)
    q.maxsize = maxsize
    q._actor = actor
    return q
