"""Distributed shuffle: a two-phase map/reduce exchange over tasks.

Reference: ``data/_internal/planner/exchange/push_based_shuffle_task_scheduler.py:590``
and ``shuffle_task_scheduler``. The driver orchestrates REFS ONLY — no
block bytes ever pass through it (the round-4 implementation
concatenated the whole dataset on the driver; this replaces it):

  map phase    one task per input block: assign each row a random
               output partition (seeded per block) and return the
               ``num_output_blocks`` partitions as SEPARATE return
               values, so each reducer fetches exactly its slice
               (an all-to-all over the object store's chunked
               node-to-node transfer).
  reduce phase one task per output block: concat its partition from
               every map task, then permute rows locally (seeded).

Memory: each reducer materializes one output block (~dataset/N), the
store holds the partition working set and spills under pressure — the
driver's footprint stays O(refs). Determinism: fixing ``seed`` fixes
the permutation for a given block structure.

Wire: the all-to-all is refs-only at this layer; the partition BYTES
move when each reducer's arg-fetch pulls its slices through the
daemon↔daemon chunk transfer, which since the zero-copy data plane PR
rides RAW frames end to end — sender segments scatter-gather onto the
socket, receivers land chunks straight in the destination segment
(``core/rpc.py`` kind 5, ``core/pull_manager.py``). ``bench.py``'s
``shuffle_gbps`` phase measures this exchange across a 2-node cluster;
``raytpu_shuffle_*`` counters surface exchange activity on /metrics.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_concat, block_num_rows, block_take
from ray_tpu_torch.observability.metrics import Counter

#: exchanges orchestrated by this driver process
SHUFFLE_EXCHANGES = Counter(
    "raytpu_shuffle_exchanges_total",
    "shuffle exchanges orchestrated (driver-side)",
)
#: map-side partitions produced across all exchanges (n_in × n_out per
#: exchange) — each is one ref a reducer fetches over the RAW data plane
SHUFFLE_PARTITIONS = Counter(
    "raytpu_shuffle_partitions_total",
    "map partitions produced by shuffle exchanges (each fetched by a reducer)",
)


def _shuffle_map(block: Block, n_out: int, seed: int):
    """Split one block's rows into n_out random partitions."""
    n = block_num_rows(block)
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_out, size=n)
    parts = tuple(
        block_take(block, np.nonzero(assign == j)[0]) for j in range(n_out)
    )
    return parts if n_out > 1 else parts[0]


def _shuffle_reduce(seed: int, *parts: Block) -> Block:
    merged = block_concat(list(parts))
    n = block_num_rows(merged)
    if n == 0:
        return merged
    rng = np.random.default_rng(seed)
    return block_take(merged, rng.permutation(n))


_map_remote = None
_reduce_remote = None


def _remotes():
    global _map_remote, _reduce_remote
    if _map_remote is None:
        _map_remote = ray_tpu_torch.remote(num_cpus=1)(_shuffle_map)
        _reduce_remote = ray_tpu_torch.remote(num_cpus=1)(_shuffle_reduce)
    return _map_remote, _reduce_remote


def shuffle_exchange(
    block_refs: List[object],
    *,
    num_output_blocks: Optional[int] = None,
    seed: Optional[int] = None,
) -> List[object]:
    """Run the exchange; returns the shuffled output block REFS."""
    if not block_refs:
        return []
    n_out = num_output_blocks or len(block_refs)
    SHUFFLE_EXCHANGES.inc()
    SHUFFLE_PARTITIONS.inc(len(block_refs) * n_out)
    base = seed if seed is not None else np.random.SeedSequence().entropy % (2**31)
    mapper, reducer = _remotes()
    map_outs = [
        mapper.options(num_returns=n_out).remote(ref, n_out, int(base) + i)
        for i, ref in enumerate(block_refs)
    ]
    if n_out == 1:
        # options(num_returns=1) yields a single ref, not a list
        map_cols = [[r] for r in map_outs]
    else:
        map_cols = map_outs
    return [
        reducer.remote(int(base) + 100003 + j, *[m[j] for m in map_cols])
        for j in range(n_out)
    ]
