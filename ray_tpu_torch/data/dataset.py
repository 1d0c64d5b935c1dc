"""Dataset: lazy, streaming, block-structured data over the object store.

Reference surface: ``python/ray/data/dataset.py`` (map_batches / filter /
flat_map / random_shuffle / limit / iter_batches / streaming_split /
count / take / materialize) + ``read_api.py`` (from_items / range /
read_parquet / read_csv / from_numpy / from_pandas).

Design (idiomatic, not a port): a Dataset is (sources, fused transform
chain), where a source is a read callable OR an ObjectRef to an already
materialized block. Transforms append to the chain; execution fuses the
whole chain into ONE remote task per block (reference MapFusion), blocks
stream with bounded in-flight tasks, and consumers pull block refs as
they complete.

``streaming_split(n)`` partitions the *sources* deterministically
(shard i takes sources i, i+n, ...): each shard is an independent
Dataset the consuming worker executes itself. That makes shards
re-iterable (epoch 2 re-executes the plan — reference semantics),
keeps memory bounded by each consumer's in-flight window, and needs no
coordinator. The trade-off vs the reference's splitter actor is static
assignment instead of dynamic balancing of slow consumers."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    VALUE_COL,
    block_concat,
    block_num_rows,
    block_slice,
    block_take,
    blocks_from_rows,
    normalize_block,
    rows_of,
)
from ray_tpu_torch.data.executor import (
    ActorPoolStrategy,
    ActorStage,
    FusedStage,
    Source,
    execute_pipeline,
)
from ray_tpu_torch.data.iterator import iter_batches_from_refs, iter_device_batches

DEFAULT_BLOCK_SIZE = 1024  # rows per block for in-memory sources


class Dataset:
    """Lazy dataset: construct via ``ray_tpu_torch.data.from_items/range/read_*``.

    The plan is (sources, stages): consecutive map-like transforms fuse
    into one task per block (FusedStage); stateful ``map_batches`` with
    ``compute=ActorPoolStrategy(...)`` breaks fusion into an ActorStage
    (reference: operator fusion rules + ActorPoolMapOperator)."""

    def __init__(self, sources: Sequence[Source], stages=None):
        self._sources: List[Source] = list(sources)
        self._stages: List[Any] = list(stages or [])
        self._materialized: Optional[List[Any]] = None  # block refs cache

    # -- transforms (lazy, fused) ---------------------------------------
    def _plan(self):
        """(sources, stages) this dataset would execute."""
        if self._materialized is not None:
            return list(self._materialized), []
        return self._sources, self._stages

    def _chain(self, t: Callable[[Block], Block]) -> "Dataset":
        sources, stages = self._plan()
        if stages and isinstance(stages[-1], FusedStage):
            stages = stages[:-1] + [stages[-1].chained(t)]
        else:
            stages = stages + [FusedStage([t])]
        return Dataset(sources, stages)

    def map_batches(
        self,
        fn: Any,
        *,
        batch_size: Optional[int] = None,
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
    ) -> "Dataset":
        """Apply ``fn`` to whole blocks (optionally re-chunked to
        ``batch_size`` rows inside the task). With
        ``compute=ActorPoolStrategy(...)``, ``fn`` must be a CLASS —
        constructed once per pool actor (expensive state like a loaded
        model amortizes across blocks; reference ActorPoolMapOperator)."""
        if compute is not None:
            if not isinstance(fn, type):
                raise ValueError(
                    "compute=ActorPoolStrategy requires a callable CLASS"
                )
            sources, stages = self._plan()
            return Dataset(
                sources,
                stages
                + [
                    ActorStage(
                        fn, fn_constructor_args, fn_constructor_kwargs or {},
                        compute, batch_size,
                    )
                ],
            )
        if batch_size is None:
            return self._chain(lambda b: normalize_block(fn(b)))
        from ray_tpu_torch.data.block import apply_batched

        return self._chain(lambda b: apply_batched(fn, b, batch_size))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def per_row(block: Block) -> Block:
            rows = [fn(r) for r in rows_of(block)]
            return blocks_from_rows(rows, len(rows) or 1)[0] if rows else block
        return self._chain(per_row)

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        def filt(block: Block) -> Block:
            mask = np.asarray([bool(fn(r)) for r in rows_of(block)], bool)
            return block_take(block, np.nonzero(mask)[0])
        return self._chain(filt)

    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        def fm(block: Block) -> Block:
            rows: List[Any] = []
            for r in rows_of(block):
                rows.extend(fn(r))
            blocks = blocks_from_rows(rows, max(1, len(rows)))
            return blocks[0] if blocks else {VALUE_COL: np.asarray([])}
        return self._chain(fm)

    # -- execution -------------------------------------------------------
    def _block_refs(self) -> List[Any]:
        if self._materialized is None:
            self._materialized = list(
                execute_pipeline(self._sources, self._stages)
            )
        return self._materialized

    def _stream_refs(self) -> Iterator[Any]:
        if self._materialized is not None:
            return iter(self._materialized)
        return execute_pipeline(self._sources, self._stages)

    def materialize(self) -> "Dataset":
        self._block_refs()
        return self

    # -- global ops (require materialization) ----------------------------
    def random_shuffle(
        self, *, seed: Optional[int] = None, num_blocks: Optional[int] = None
    ) -> "Dataset":
        """Global shuffle as a DISTRIBUTED map/reduce exchange
        (``data/shuffle.py``; reference push-based shuffle,
        ``push_based_shuffle_task_scheduler.py:590``): rows scatter to
        random output partitions in map tasks, reducers merge + permute.
        The driver touches refs only — the data plane stays in the
        object store (spilling under pressure), so a store-oversized
        dataset shuffles without driver materialization."""
        from ray_tpu_torch.data.shuffle import shuffle_exchange

        refs = self._block_refs()
        if not refs:
            return self
        out = shuffle_exchange(refs, num_output_blocks=num_blocks, seed=seed)
        ds = Dataset(out)
        ds._materialized = list(out)  # reducer outputs ARE the blocks
        return ds

    def repartition(self, num_blocks: int) -> "Dataset":
        refs = self._block_refs()
        blocks = [ray_tpu_torch.get(r, timeout=600) for r in refs]
        if not blocks:
            return self
        merged = block_concat(blocks)
        n = block_num_rows(merged)
        per = max(1, -(-n // num_blocks))
        return _from_blocks(
            [block_slice(merged, s, min(n, s + per)) for s in range(0, n, per)]
        )

    def groupby(self, key: str):
        """Group by a column (reference ``Dataset.groupby`` →
        ``GroupedData``): distributed partial-aggregate + hash shuffle."""
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Global sample-sort by a column (reference ``Dataset.sort``)."""
        from ray_tpu_torch.data.grouped import sort_dataset

        return sort_dataset(self, key, descending)

    def unique(self, column: str) -> List[Any]:
        vals = set()
        for ref in self._stream_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            vals.update(np.unique(b[column]).tolist())
        return sorted(vals)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two equal-length datasets (reference
        ``Dataset.zip``; right-side name collisions get a ``_1``
        suffix)."""
        left = [ray_tpu_torch.get(r, timeout=600) for r in self._block_refs()]
        right = [ray_tpu_torch.get(r, timeout=600) for r in other._block_refs()]
        lm = block_concat(left) if left else {}
        rm = block_concat(right) if right else {}
        ln, rn = block_num_rows(lm), block_num_rows(rm)
        if ln != rn:
            raise ValueError(f"zip() requires equal row counts ({ln} vs {rn})")
        out = dict(lm)
        for k, v in rm.items():
            out[k if k not in out else f"{k}_1"] = v
        per = max(1, ln // max(1, len(left) or 1))
        return _from_blocks(
            [block_slice(out, s, min(ln, s + per)) for s in range(0, ln, per)]
        )

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (reference ``Dataset.union``): each
        side's plan executes independently; blocks chain in order."""
        refs: List[Any] = list(self._block_refs())
        for o in others:
            refs.extend(o._block_refs())
        ds = Dataset(refs)
        ds._materialized = list(refs)
        return ds

    def limit(self, n: int) -> "Dataset":
        taken: List[Block] = []
        have = 0
        for ref in self._stream_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            rows = block_num_rows(b)
            if have + rows >= n:
                taken.append(block_slice(b, 0, n - have))
                have = n
                break
            taken.append(b)
            have += rows
        return _from_blocks(taken)

    # -- consumption -----------------------------------------------------
    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        drop_last: bool = False,
        prefetch_blocks: int = 2,
    ) -> Iterator[Block]:
        return iter_batches_from_refs(
            self._stream_refs(),
            batch_size=batch_size,
            drop_last=drop_last,
            prefetch_blocks=prefetch_blocks,
        )

    def iter_device_batches(self, *, batch_size=256, sharding=None, transform=None,
                            drop_last: bool = False):
        """Batches double-buffered onto the accelerator (host→device
        overlap) — the ingest path for TorchTrainer."""
        return iter_device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            sharding=sharding,
            transform=transform,
        )

    def iter_rows(self) -> Iterator[Any]:
        for batch in self.iter_batches(batch_size=None):
            yield from rows_of(batch)

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for r in self.iter_rows():
            out.append(r)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(
            block_num_rows(ray_tpu_torch.get(r, timeout=600)) for r in self._stream_refs()
        )

    def schema(self) -> Optional[Dict[str, str]]:
        for ref in self._stream_refs():
            b = ray_tpu_torch.get(ref, timeout=600)
            return {k: str(v.dtype) for k, v in b.items()}
        return None

    def num_blocks(self) -> int:
        if self._materialized is not None:
            return len(self._materialized)
        return len(self._sources)

    # -- splitting -------------------------------------------------------
    def split(self, n: int) -> List["Dataset"]:
        """Materializing equal (by rows) split (reference ``Dataset.split``)."""
        refs = self._block_refs()
        blocks = [ray_tpu_torch.get(r, timeout=600) for r in refs]
        merged = block_concat(blocks) if blocks else {VALUE_COL: np.asarray([])}
        total = block_num_rows(merged)
        per = total // n
        out = []
        for i in range(n):
            end = (i + 1) * per if i < n - 1 else total
            out.append(_from_blocks([block_slice(merged, i * per, end)]))
        return out

    def streaming_split(self, n: int, *, equal: bool = False) -> List["DataShard"]:
        """N disjoint, independently-executing, re-iterable shards — one
        per Train worker (reference ``Dataset.streaming_split``).

        ``equal=True`` materializes and splits by rows exactly;
        ``equal=False`` (default) partitions sources round-robin with no
        materialization (block-granular, so row counts may differ by up
        to one block)."""
        if equal:
            parts = self.split(n)
            return [
                DataShard(p._materialized or p._sources, [], i, n)
                for i, p in enumerate(parts)
            ]
        sources, stages = self._plan()
        return [DataShard(sources[i::n], stages, i, n) for i in range(n)]

    # -- write path ------------------------------------------------------
    def write_datasink(self, sink) -> List[Any]:
        """Write via a ``Datasink`` (reference ``datasink.py:51``): one
        remote task per block; driver handles lifecycle hooks only."""
        from ray_tpu_torch.data.datasink import write_datasink

        return write_datasink(self, sink)

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasink import ParquetSink

        return self.write_datasink(ParquetSink(path))

    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasink import CSVSink

        return self.write_datasink(CSVSink(path))

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasink import JSONSink

        return self.write_datasink(JSONSink(path))

    def write_numpy(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasink import NumpySink

        return self.write_datasink(NumpySink(path))

    def __repr__(self) -> str:
        return (
            f"Dataset(blocks={self.num_blocks()}, "
            f"stages={len(self._stages)})"
        )


def _from_blocks(blocks: List[Block]) -> Dataset:
    refs = [ray_tpu_torch.put(b) for b in blocks]
    ds = Dataset(refs)
    ds._materialized = list(refs)
    return ds


class DataShard(Dataset):
    """One consumer's shard of a streaming_split — picklable (sources are
    read callables or ObjectRefs), re-iterable every epoch, executed by
    whichever worker consumes it."""

    def __init__(self, sources, stages, split_idx: int, num_splits: int):
        super().__init__(sources, stages)
        self._idx = split_idx
        self._n = num_splits

    def __reduce__(self):
        return (
            DataShard,
            (self._sources, self._stages, self._idx, self._n),
        )

    def __repr__(self) -> str:
        return f"DataShard({self._idx}/{self._n}, blocks={self.num_blocks()})"
