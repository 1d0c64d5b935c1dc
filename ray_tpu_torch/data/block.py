"""Blocks: the unit of data movement.

Reference: ``python/ray/data/block.py`` — a block is a batch of rows
stored column-major behind an ObjectRef; operators exchange block refs,
never materialized data, so all movement is zero-copy through the shm
store.

TPU-native delta: the canonical in-memory format is a dict of numpy
arrays (host staging for the copy to the device), not Arrow — Arrow appears
only at the datasource boundary (parquet/csv readers convert)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence

import numpy as np

#: A block is a dict of equal-length column arrays.
Block = Dict[str, np.ndarray]

VALUE_COL = "value"  # column name for schemaless datasets (from_items/range)


def normalize_block(data: Any) -> Block:
    """Coerce rows/arrays/dicts into the canonical column-dict block."""
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    arr = np.asarray(data)
    return {VALUE_COL: arr}


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if b]  # empty ({}) blocks contribute nothing
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def apply_batched(fn, block: Block, batch_size: int) -> Block:
    """Run ``fn`` over ``batch_size``-row slices of a block and concat
    the outputs (shared by Dataset.map_batches and the actor pool)."""
    outs = []
    n = block_num_rows(block)
    for s in range(0, n, batch_size):
        outs.append(normalize_block(fn(block_slice(block, s, min(n, s + batch_size)))))
    return block_concat(outs) if outs else block


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def rows_of(block: Block) -> Iterable[Dict[str, Any]]:
    n = block_num_rows(block)
    keys = list(block.keys())
    for i in range(n):
        row = {k: block[k][i] for k in keys}
        yield row[VALUE_COL] if keys == [VALUE_COL] else row


def blocks_from_rows(rows: List[Any], target_block_size: int) -> List[Block]:
    out = []
    for start in range(0, len(rows), target_block_size):
        chunk = rows[start : start + target_block_size]
        if chunk and isinstance(chunk[0], dict):
            keys = chunk[0].keys()
            out.append({k: np.asarray([r[k] for r in chunk]) for k in keys})
        else:
            out.append({VALUE_COL: np.asarray(chunk)})
    return out
