"""multiprocessing.Pool shim over the runtime.

Reference: ``python/ray/util/multiprocessing/pool.py`` — drop-in
``Pool`` with map/imap/imap_unordered/starmap/apply/apply_async so code
written for the stdlib scales across the cluster unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None) -> Any:
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait([self._ref], num_returns=1, timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return bool(done)


class Pool:
    def __init__(self, processes: Optional[int] = None, *, ray_remote_args: Optional[dict] = None):
        self._n = processes or 4
        args = dict(ray_remote_args or {})
        args.setdefault("num_cpus", 1)
        self._remote_cache: dict = {}
        self._remote_args = args
        self._closed = False

    def _remote(self, fn: Callable):
        r = self._remote_cache.get(fn)
        if r is None:
            r = self._remote_cache[fn] = ray_tpu_torch.remote(**self._remote_args)(fn)
        return r

    def apply(self, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None) -> Any:
        return ray_tpu_torch.get(
            self._remote(fn).remote(*args, **(kwargs or {})), timeout=None
        )

    def apply_async(self, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None) -> AsyncResult:
        return AsyncResult(self._remote(fn).remote(*args, **(kwargs or {})))

    def map(self, fn: Callable, iterable: Iterable[Any], chunksize: Optional[int] = None) -> List[Any]:
        r = self._remote(fn)
        # bounded in-flight window: a huge iterable must not flood the
        # scheduler (the reference chunks for the same reason)
        window = max(self._n * 4, 16)
        items = list(iterable)
        out: List[Any] = []
        refs = []
        for it in items:
            refs.append(r.remote(it))
            if len(refs) >= window:
                out.extend(ray_tpu_torch.get(refs, timeout=None))
                refs = []
        if refs:
            out.extend(ray_tpu_torch.get(refs, timeout=None))
        return out

    def starmap(self, fn: Callable, iterable: Iterable[tuple]) -> List[Any]:
        r = self._remote(fn)
        return ray_tpu_torch.get([r.remote(*args) for args in iterable], timeout=None)

    def imap(self, fn: Callable, iterable: Iterable[Any]):
        r = self._remote(fn)
        refs = [r.remote(it) for it in iterable]
        for ref in refs:
            yield ray_tpu_torch.get(ref, timeout=None)

    def imap_unordered(self, fn: Callable, iterable: Iterable[Any]):
        r = self._remote(fn)
        refs = [r.remote(it) for it in iterable]
        while refs:
            done, refs = ray_tpu_torch.wait(refs, num_returns=1, timeout=None)
            yield ray_tpu_torch.get(done[0], timeout=None)

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
