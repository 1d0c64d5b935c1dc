"""Batch iteration with prefetch + host→device double-buffering (port of
``ray_tpu.data.iterator``).

Reference: ``data/_internal/block_batching/`` (prefetching batchers) and
``data/iterator.py`` — the piece Train actually needs on the card: while
step N computes on device, batch N+1 is already being sliced on host and
transferred, so input never serializes behind compute.
``iter_batches_from_refs`` is the JAX package's; ``iter_device_batches``
copies through pinned memory where the JAX one calls ``jax.device_put``."""

from __future__ import annotations

import threading
from queue import Queue
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_concat, block_num_rows, block_slice

_SENTINEL = object()


def iter_batches_from_refs(
    ref_iter: Iterable,
    *,
    batch_size: Optional[int],
    drop_last: bool = False,
    prefetch_blocks: int = 2,
) -> Iterator[Block]:
    """Slice/merge a stream of block refs into batches of ``batch_size``
    rows, fetching up to ``prefetch_blocks`` blocks ahead in a background
    thread (pipeline fill while the consumer computes).

    Abandoning the generator early (take(), a training loop that breaks)
    stops the producer thread: it checks a stop flag around the bounded
    queue put, so it never blocks forever holding blocks alive."""
    q: Queue = Queue(maxsize=max(1, prefetch_blocks))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Exception:  # queue.Full
                continue
        return False

    def _producer():
        try:
            for ref in ref_iter:
                if not _put(ray_tpu_torch.get(ref, timeout=600)):
                    return
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            _put(e)
            return
        _put(_SENTINEL)

    t = threading.Thread(target=_producer, daemon=True, name="batch-prefetch")
    t.start()

    try:
        leftover: Optional[Block] = None
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is _SENTINEL:
                break
            block: Block = item
            if batch_size is None:
                yield block
                continue
            if leftover is not None:
                block = block_concat([leftover, block])
                leftover = None
            n = block_num_rows(block)
            start = 0
            while n - start >= batch_size:
                yield block_slice(block, start, start + batch_size)
                start += batch_size
            if start < n:
                leftover = block_slice(block, start, n)
        if leftover is not None and not drop_last:
            yield leftover
    finally:
        stop.set()
        # drain so a producer blocked mid-put can observe the flag
        try:
            while True:
                q.get_nowait()
        except Exception:
            pass


def _device_target(sharding):
    """``(device, mesh, placements)`` for an ``iter_device_batches`` target:
    None (``cuda``), a device, or ``(mesh, placements)``."""
    import torch

    if sharding is None or isinstance(sharding, (str, torch.device)):
        return torch.device("cuda" if sharding is None else sharding), None, None
    from ray_tpu_torch.parallel.mesh import placement_mesh

    mesh, placements = sharding
    return torch.device(mesh.device_type), placement_mesh(mesh), tuple(placements)


def iter_device_batches(
    batch_iter: Iterable[Block],
    *,
    sharding=None,
    transform: Optional[Callable[[Block], Dict[str, Any]]] = None,
) -> Iterator[Dict[str, Any]]:
    """Double-buffer host batches onto the device: batch N+1's copy is
    issued (from pinned host memory, ``non_blocking``) before batch N is
    yielded, so it overlaps the caller's compute on batch N.

    ``sharding``: None puts each column on ``cuda``; a device (``"cpu"``,
    ``"cuda:1"``) puts it there; ``(mesh, placements)`` puts this rank's
    rows on the mesh's device and makes each column a DTensor of them
    on ``placement_mesh(mesh)``, whose placements ``sharding.spec_placements``
    gives. The global batch is every rank's rows in rank order: each rank
    holds its own rows as a shard of it, and a mesh dim the placements do
    not shard the batch over (the ``tensor`` axis under ``tp``, the ``seq``
    axis, which shards the sequence) gathers its ranks' rows first, so the
    ranks of that dim hold the same rows, as a replicated placement says
    (one process reads one shard of the dataset, where the JAX package's
    one controller puts the whole batch)."""
    import numpy as np
    import torch

    device, mesh, placements = _device_target(sharding)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass sharding='cpu' to stay on the CPU")

    def put_one(a):
        # a copy: blocks may be read-only views of the object store
        t = torch.from_numpy(np.array(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if mesh is not None:
            from torch.distributed.tensor import DTensor, Shard

            rows = (Shard(0),) * mesh.ndim
            t = DTensor.from_local(t, mesh, rows, run_check=False)
            if placements != rows:
                t = t.redistribute(mesh, placements)
        return t

    def put(b: Block):
        if transform is not None:
            b = transform(b)
        return {k: put_one(v) for k, v in b.items()}

    it = iter(batch_iter)
    try:
        current = put(next(it))
    except StopIteration:
        return
    for nxt in it:
        staged = put(nxt)  # async copy: overlaps consumer compute
        yield current
        current = staged
    yield current
