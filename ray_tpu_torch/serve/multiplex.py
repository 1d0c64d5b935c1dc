"""Model multiplexing: many models LRU-cached across a replica pool.

Reference: ``python/ray/serve/multiplex.py:22`` (``_ModelMultiplexWrapper``)
+ model-aware routing in ``replica_scheduler``: a replica holds up to
``max_num_models_per_replica`` models; requests carry a model id; the
router prefers replicas that already have the model loaded (avoiding a
cold load), falling back to pow-2 among all replicas (the chosen one
then loads + possibly evicts LRU).

TPU framing: one replica process pins the base weights on its chip and
hot-swaps LoRA/adapter deltas — the LRU wrapper is the adapter cache.

    @serve.deployment
    class LLM:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_adapter(model_id)

        async def __call__(self, prompt):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(prompt)
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)

_MODELS_ATTR = "__serve_multiplex_models__"


class _Loading:
    """In-flight-load placeholder in the model cache (dedups concurrent
    cold loads of one model)."""

    def __init__(self):
        self.done = threading.Event()


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (set by the replica
    from the handle/proxy-supplied id; reference
    ``serve.get_multiplexed_model_id``)."""
    return _model_id_ctx.get()


def loaded_model_ids(callable_obj: Any) -> List[str]:
    """Model ids currently cached on a replica's callable (the router's
    model-locality signal, newest last)."""
    models = getattr(callable_obj, _MODELS_ATTR, None)
    if not models:
        return []
    return [k for k, v in models.items() if not isinstance(v, _Loading)]


class multiplexed:
    """Decorator for the model-loader method (``@serve.multiplexed``).

    The wrapped loader becomes an async LRU cache keyed by model id:
    a hit refreshes recency; a miss calls the user loader and evicts the
    least-recently-used model beyond ``max_num_models_per_replica``
    (calling the evicted model's ``__del__`` implicitly by dropping the
    reference)."""

    def __init__(self, _fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3):
        self._fn = None
        self.max_models = max_num_models_per_replica
        if callable(_fn):
            self._fn = _fn

    def __call__(self, fn: Callable) -> "multiplexed":
        self._fn = fn
        return self

    def __set_name__(self, owner, name):
        self._name = name

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        return _BoundMultiplexLoader(self._fn, instance, self.max_models)


class _BoundMultiplexLoader:
    """Per-instance bound loader; model cache lives on the instance so
    the replica can report loaded ids."""

    def __init__(self, fn, instance, max_models: int):
        self._fn = fn
        self._instance = instance
        self._max = max(1, max_models)
        if not hasattr(instance, _MODELS_ATTR):
            setattr(instance, _MODELS_ATTR, OrderedDict())
            setattr(instance, _MODELS_ATTR + "_lock", threading.Lock())

    def _cache(self) -> OrderedDict:
        return getattr(self._instance, _MODELS_ATTR)

    def _lock(self):
        return getattr(self._instance, _MODELS_ATTR + "_lock")

    async def __call__(self, model_id: Optional[str] = None):
        if model_id is None:
            model_id = get_multiplexed_model_id()
        if not model_id:
            raise ValueError(
                "no model id: pass one explicitly or set "
                "multiplexed_model_id on the handle/request"
            )
        cache = self._cache()
        loop = asyncio.get_event_loop()
        while True:
            with self._lock():
                if model_id in cache:
                    entry = cache[model_id]
                    if not isinstance(entry, _Loading):
                        cache.move_to_end(model_id)
                        return entry
                    pending = entry
                else:
                    # claim the load: concurrent requests for the same
                    # cold model must NOT each run the (expensive,
                    # device-memory-hungry) loader
                    pending = None
                    cache[model_id] = _Loading()
            if pending is not None:
                # another request is loading it — wait off-loop
                await loop.run_in_executor(None, pending.done.wait)
                continue  # re-check (load may have failed/been evicted)
            break
        marker = cache[model_id]
        try:
            result = self._fn(self._instance, model_id)
            if inspect.iscoroutine(result):
                result = await result
        except BaseException:
            with self._lock():
                if cache.get(model_id) is marker:
                    del cache[model_id]
            marker.done.set()
            raise
        with self._lock():
            cache[model_id] = result
            cache.move_to_end(model_id)
            while len(cache) > self._max:
                evict_id = next(
                    (k for k, v in cache.items() if not isinstance(v, _Loading)),
                    None,
                )
                if evict_id is None:
                    break  # everything in flight — nothing evictable
                del cache[evict_id]  # evict LRU — ref drop unloads
        marker.done.set()
        return result

    def load_sync(self, model_id: Optional[str] = None):
        """Synchronous entry for sync callables."""
        coro = self(model_id)
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(coro)
        raise RuntimeError(
            "load_sync called from an async context — await the loader"
        )
