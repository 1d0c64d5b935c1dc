"""Dynamic request batching — the highest-leverage TPU serving feature.

Reference: ``python/ray/serve/batching.py`` (``@serve.batch``) — N
concurrent single requests coalesce into ONE call of the wrapped method
with a list argument, so a replica's chip sees large batches (MXU
utilization) instead of singletons. The method must be async, take a
list, and return a list of equal length::

    @serve.deployment
    class Model:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)
        async def handle(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
            return list(model(np.stack(inputs)))

        async def __call__(self, x):
            return await self.handle(x)

Each caller awaits its own element; the flusher waits up to
``batch_wait_timeout_s`` for the batch to fill after the first arrival.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, List, Optional


class _BatchState:
    __slots__ = ("queue", "task")

    def __init__(self):
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.task: Optional[asyncio.Task] = None


class _BatchedMethod:
    """Descriptor: per-instance batching state, shared flusher task."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def method")
        self._fn = fn
        self._max = max(1, max_batch_size)
        self._wait = batch_wait_timeout_s
        self._attr = f"__serve_batch_{fn.__name__}"
        functools.update_wrapper(self, fn)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self

        async def call(item):
            state: _BatchState = obj.__dict__.get(self._attr)
            if state is None:
                state = _BatchState()
                obj.__dict__[self._attr] = state
            if state.task is None or state.task.done():
                state.task = asyncio.ensure_future(self._flush_loop(obj, state))
            fut = asyncio.get_event_loop().create_future()
            state.queue.put_nowait((item, fut))
            return await fut

        call.__name__ = self._fn.__name__
        return call

    async def _flush_loop(self, obj, state: _BatchState) -> None:
        loop = asyncio.get_event_loop()
        while True:
            item, fut = await state.queue.get()
            batch = [(item, fut)]
            deadline = loop.time() + self._wait
            while len(batch) < self._max:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(state.queue.get(), remaining)
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    break
            items = [b[0] for b in batch]
            try:
                results = await self._fn(obj, items)
                if results is None or len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch method {self._fn.__name__} returned "
                        f"{0 if results is None else len(results)} results "
                        f"for a batch of {len(items)}"
                    )
                for (_, f), r in zip(batch, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)


def batch(
    _fn=None, *, max_batch_size: int = 10, batch_wait_timeout_s: float = 0.01
):
    """``@serve.batch`` decorator (reference ``serve/batching.py``)."""

    def wrap(fn):
        return _BatchedMethod(fn, max_batch_size, batch_wait_timeout_s)

    if _fn is not None:
        return wrap(_fn)
    return wrap
