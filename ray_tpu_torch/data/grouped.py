"""Grouped aggregation and sorting.

Reference: ``python/ray/data/grouped_data.py`` (GroupedData.count/sum/
min/max/mean/aggregate/map_groups), ``data/aggregate.py`` (AggregateFn),
and the sort exchange (``_internal/planner/exchange/sort_task_spec.py``).

Execution is a two-stage task shuffle, not a driver-side pandas pass:
map tasks partial-aggregate each block and hash-partition the partial
states by key; reduce tasks merge their partition across all map outputs
and finalize. Sort samples key boundaries, range-partitions blocks in map
tasks, and sorts each range in reduce tasks — output blocks are globally
ordered. (The reference's push-based shuffle pipelines the exchange; this
build ships whole map outputs, the honest small-scale equivalent.)
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def _sorted_group_segments(block: Block, key: str):
    """Stable-sort a block by ``key`` and return
    ``(sorted_block, sorted_keys, starts, ends)`` where each
    ``[starts[i], ends[i])`` is one group's contiguous segment — the one
    grouping idiom shared by map, partition, and reduce tasks."""
    order = np.argsort(block[key], kind="stable")
    sb = block_take(block, order)
    sk = sb[key]
    bounds = np.flatnonzero(sk[1:] != sk[:-1]) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(sk)]])
    return sb, sk, starts, ends


def _det_hash(value: Any) -> int:
    """Deterministic cross-process key hash: Python's ``hash()`` is
    salted per process (PYTHONHASHSEED), which would route the same key
    to DIFFERENT partitions in different map workers — silent groupby
    corruption."""
    return int.from_bytes(
        hashlib.blake2b(repr(value).encode(), digest_size=8).digest(), "little"
    )

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_num_rows,
    block_take,
    normalize_block,
)


class AggregateFn:
    """One aggregation (reference ``ray.data.aggregate.AggregateFn``):
    ``init(key)->state``, ``accumulate_block(state, block)->state``,
    ``merge(a, b)->state``, ``finalize(state)->value``."""

    def __init__(self, init, accumulate_block, merge, finalize=None, name="agg()"):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize or (lambda s: s)
        self.name = name


def Count() -> AggregateFn:
    return AggregateFn(
        init=lambda k: 0,
        accumulate_block=lambda s, b: s + block_num_rows(b),
        merge=lambda a, b: a + b,
        name="count()",
    )


def _col_agg(on: str, np_fn, np_merge, name: str) -> AggregateFn:
    return AggregateFn(
        init=lambda k: None,
        accumulate_block=lambda s, b: (
            np_fn(b[on]) if s is None else np_merge(s, np_fn(b[on]))
        ),
        merge=lambda a, b: b if a is None else (a if b is None else np_merge(a, b)),
        name=f"{name}({on})",
    )


def Sum(on: str) -> AggregateFn:
    return _col_agg(on, np.sum, lambda a, b: a + b, "sum")


def Min(on: str) -> AggregateFn:
    return _col_agg(on, np.min, min, "min")


def Max(on: str) -> AggregateFn:
    return _col_agg(on, np.max, max, "max")


def Mean(on: str) -> AggregateFn:
    return AggregateFn(
        init=lambda k: (0.0, 0),
        accumulate_block=lambda s, b: (s[0] + float(np.sum(b[on])), s[1] + len(b[on])),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda s: s[0] / s[1] if s[1] else float("nan"),
        name=f"mean({on})",
    )


def Std(on: str, ddof: int = 1) -> AggregateFn:
    # parallel variance via (n, sum, sumsq); ddof=1 (sample std) matches
    # the reference ray.data.aggregate.Std default
    def _finalize(s):
        n = s[0]
        if n <= ddof:
            return float("nan")
        var = (s[2] - s[1] * s[1] / n) / (n - ddof)
        return float(np.sqrt(max(0.0, var)))

    return AggregateFn(
        init=lambda k: (0, 0.0, 0.0),
        accumulate_block=lambda s, b: (
            s[0] + len(b[on]),
            s[1] + float(np.sum(b[on])),
            s[2] + float(np.sum(np.square(b[on].astype(np.float64)))),
        ),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
        finalize=_finalize,
        name=f"std({on})",
    )


# ---------------------------------------------------------------------------
# shuffle tasks (run remotely)


def _group_map_task(block: Block, key: str, aggs: List[AggregateFn], num_parts: int):
    """Partial-aggregate one block; hash-partition states by key.
    Returns [ {key_value: [state_per_agg]} ] * num_parts."""
    block = normalize_block(block)
    parts: List[Dict[Any, List[Any]]] = [{} for _ in range(num_parts)]
    keys = block[key]
    if len(keys) == 0:
        return parts
    sorted_block, skeys, starts, ends = _sorted_group_segments(block, key)
    for s, e in zip(starts, ends):
        kv = skeys[s]
        sub = {c: v[s:e] for c, v in sorted_block.items()}
        kv_py = kv.item() if hasattr(kv, "item") else kv
        part = parts[_det_hash(kv_py) % num_parts]
        states = part.get(kv_py)
        if states is None:
            states = part[kv_py] = [a.init(kv_py) for a in aggs]
        for i, a in enumerate(aggs):
            states[i] = a.accumulate_block(states[i], sub)
    return parts


def _group_reduce_task(part_idx: int, key: str, aggs: List[AggregateFn], *map_outputs):
    """Merge one hash partition across every map output; finalize."""
    merged: Dict[Any, List[Any]] = {}
    for mo in map_outputs:
        for kv, states in mo[part_idx].items():
            cur = merged.get(kv)
            if cur is None:
                merged[kv] = list(states)
            else:
                for i, a in enumerate(aggs):
                    cur[i] = a.merge(cur[i], states[i])
    if not merged:
        return {}
    kvs = sorted(merged.keys())
    out: Dict[str, Any] = {key: np.asarray(kvs)}
    for i, a in enumerate(aggs):
        out[a.name] = np.asarray([a.finalize(merged[kv][i]) for kv in kvs])
    return out


def _group_rows_partition_task(block: Block, key: str, num_parts: int):
    """Hash-partition one block's raw rows by key. num_parts RETURN
    VALUES (one ObjectRef per partition), so each reducer fetches only
    its own partition instead of every map output."""
    b = normalize_block(block)
    keys = b[key]
    if len(keys) == 0:
        empty = [{} for _ in range(num_parts)]
        return empty if num_parts > 1 else empty[0]
    # one hash per GROUP, not per row: sort once, find group boundaries,
    # assign each segment its partition (same technique as the reduce)
    sb, sk, starts, ends = _sorted_group_segments(b, key)
    part_of = np.empty(len(sk), dtype=np.int64)
    for s, e in zip(starts, ends):
        kv = sk[s]
        part_of[s:e] = _det_hash(kv.item() if hasattr(kv, "item") else kv) % num_parts
    parts = [block_take(sb, np.nonzero(part_of == p)[0]) for p in range(num_parts)]
    return parts if num_parts > 1 else parts[0]


def _map_groups_reduce_task(key: str, fn, *part_blocks):
    """Concat this partition's rows across blocks, group by key, apply
    ``fn`` per group."""
    merged = block_concat([normalize_block(p) for p in part_blocks if p])
    if not merged or len(merged.get(key, ())) == 0:
        return {}
    sb, _sk, starts, ends = _sorted_group_segments(merged, key)
    outs = []
    for s, e in zip(starts, ends):
        outs.append(normalize_block(fn({c: v[s:e] for c, v in sb.items()})))
    return block_concat(outs)


class GroupedData:
    """``ds.groupby(key)`` (reference ``GroupedData``)."""

    def __init__(self, dataset, key: str, num_partitions: Optional[int] = None):
        self._ds = dataset
        self._key = key
        self._parts = num_partitions

    def _num_parts(self, n_blocks: int) -> int:
        return self._parts or max(1, min(8, n_blocks))

    def aggregate(self, *aggs: AggregateFn):
        from ray_tpu_torch.data.dataset import Dataset

        refs = self._ds._block_refs()
        if not refs:
            return Dataset([])
        R = self._num_parts(len(refs))
        map_remote = ray_tpu_torch.remote(num_cpus=1)(_group_map_task)
        red_remote = ray_tpu_torch.remote(num_cpus=1)(_group_reduce_task)
        map_out = [map_remote.remote(r, self._key, list(aggs), R) for r in refs]
        red_out = [
            red_remote.remote(i, self._key, list(aggs), *map_out) for i in range(R)
        ]
        # empty ({}) partitions ride along — block_concat/rows_of skip
        # them, so no driver-side fetch is needed to filter
        ds = Dataset(red_out)
        ds._materialized = list(red_out)
        return ds

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str):
        return self.aggregate(Std(on))

    def map_groups(self, fn: Callable[[Block], Any]):
        """Apply ``fn`` to each group's full block (reference
        ``GroupedData.map_groups``)."""
        from ray_tpu_torch.data.dataset import Dataset

        refs = self._ds._block_refs()
        if not refs:
            return Dataset([])
        R = self._num_parts(len(refs))
        part_remote = ray_tpu_torch.remote(num_cpus=1)(_group_rows_partition_task).options(
            num_returns=R
        )
        mg_remote = ray_tpu_torch.remote(num_cpus=1)(_map_groups_reduce_task)
        cols = [part_remote.remote(r, self._key, R) for r in refs]
        outs = [
            mg_remote.remote(
                self._key, fn, *[(c[i] if R > 1 else c) for c in cols]
            )
            for i in range(R)
        ]
        ds = Dataset(outs)
        ds._materialized = list(outs)
        return ds


# ---------------------------------------------------------------------------
# sort


def _sample_keys_task(block: Block, key: str, k: int) -> List[Any]:
    keys = normalize_block(block)[key]
    if len(keys) == 0:
        return []
    step = max(1, len(keys) // k)
    return np.asarray(keys)[::step].tolist()


def _sort_partition_task(block: Block, key: str, bounds: List[Any], descending: bool):
    """Range-partition one block by the sampled boundaries. One RETURN
    VALUE per partition so each merge task fetches only its range."""
    block = normalize_block(block)
    keys = block[key]
    idx = np.searchsorted(np.asarray(bounds), keys, side="right")
    parts = []
    for p in range(len(bounds) + 1):
        parts.append(block_take(block, np.nonzero(idx == p)[0]))
    if descending:
        parts = parts[::-1]
    return parts if len(parts) > 1 else parts[0]


def _sort_merge_task(key: str, descending: bool, *parts):
    blocks = [b for b in parts if block_num_rows(b) > 0]
    if not blocks:
        return {}
    merged = block_concat(blocks)
    order = np.argsort(merged[key], kind="stable")
    if descending:
        order = order[::-1]
    return block_take(merged, order)


def sort_dataset(ds, key: str, descending: bool = False):
    """Sample-sort (reference sort exchange): sample boundaries → range
    partition (map tasks) → per-range merge-sort (reduce tasks)."""
    from ray_tpu_torch.data.dataset import Dataset

    refs = ds._block_refs()
    if not refs:
        return Dataset([])
    R = max(1, min(8, len(refs)))
    # boundary sampling via remote tasks — full blocks never funnel
    # through the driver (reference SortTaskSpec.sample_boundaries)
    sample_remote = ray_tpu_torch.remote(num_cpus=1)(_sample_keys_task)
    sample_refs = [sample_remote.remote(r, key, 32) for r in refs]
    samples: List[Any] = []
    for sr in sample_refs:
        samples.extend(ray_tpu_torch.get(sr, timeout=600))
    if not samples:
        return Dataset(list(refs))
    samples.sort()
    bounds = [
        samples[int(len(samples) * (i + 1) / R)]
        for i in range(R - 1)
        if int(len(samples) * (i + 1) / R) < len(samples)
    ]
    P = len(bounds) + 1
    part_remote = ray_tpu_torch.remote(num_cpus=1)(_sort_partition_task).options(
        num_returns=P
    )
    merge_remote = ray_tpu_torch.remote(num_cpus=1)(_sort_merge_task)
    cols = [part_remote.remote(r, key, bounds, descending) for r in refs]
    merged = [
        merge_remote.remote(
            key, descending, *[(c[i] if P > 1 else c) for c in cols]
        )
        for i in range(P)
    ]
    out = Dataset(merged)
    out._materialized = list(merged)
    return out
