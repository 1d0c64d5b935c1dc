"""Write path: Datasink ABC + file-format sinks.

Reference: ``python/ray/data/datasource/datasink.py:51`` (``Datasink``
with ``on_write_start`` / ``write`` / ``on_write_complete`` /
``on_write_failed``) and the per-format sinks under
``_internal/datasource/``. Writes are one REMOTE TASK per block — the
driver moves refs only; each task writes its own ``part-{i:06d}.{ext}``
file (the reference's filename-provider convention), so a
store-oversized dataset streams to disk without driver materialization.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, VALUE_COL, block_num_rows


class Datasink:
    """Subclass and implement ``write`` (called once per block, inside a
    remote task). Driver-side lifecycle hooks run around the job."""

    def on_write_start(self) -> None:  # driver, before any task
        pass

    def write(self, block: Block, ctx: Dict[str, Any]) -> Any:
        """Write one block. ``ctx`` carries ``task_index``. The return
        value is collected into ``on_write_complete(results)``."""
        raise NotImplementedError

    def on_write_complete(self, results: List[Any]) -> None:  # driver
        pass

    def on_write_failed(self, error: Exception) -> None:  # driver
        pass


def _write_block_task(sink: Datasink, block: Block, task_index: int):
    return sink.write(block, {"task_index": task_index})


_write_remote = None


def write_datasink(dataset, sink: Datasink) -> List[Any]:
    """Drive a write job: one task per block, lifecycle hooks around it
    (reference ``Dataset.write_datasink``)."""
    global _write_remote
    if _write_remote is None:
        _write_remote = ray_tpu_torch.remote(num_cpus=1)(_write_block_task)
    sink.on_write_start()
    try:
        refs = [
            _write_remote.remote(sink, ref, i)
            for i, ref in enumerate(dataset._stream_refs())
        ]
        results = ray_tpu_torch.get(refs, timeout=600)
        sink.on_write_complete(results)
    except Exception as e:  # noqa: BLE001
        # completion failures route through on_write_failed too — the
        # sink must get a chance to clean staged output either way
        sink.on_write_failed(e)
        raise
    return results


# ---------------------------------------------------------------------------
# file-format sinks


class _FileSink(Datasink):
    ext = "bin"

    def __init__(self, path: str):
        self.path = path

    def on_write_start(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    def _filename(self, ctx) -> str:
        return os.path.join(self.path, f"part-{ctx['task_index']:06d}.{self.ext}")


class ParquetSink(_FileSink):
    ext = "parquet"

    def write(self, block: Block, ctx) -> str:
        import pyarrow as pa
        import pyarrow.parquet as pq

        table = pa.table({k: np.asarray(v) for k, v in block.items()})
        out = self._filename(ctx)
        pq.write_table(table, out)
        return out


class CSVSink(_FileSink):
    ext = "csv"

    def write(self, block: Block, ctx) -> str:
        import csv

        out = self._filename(ctx)
        keys = list(block.keys())
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            n = block_num_rows(block)
            for i in range(n):
                w.writerow([block[k][i] for k in keys])
        return out


class JSONSink(_FileSink):
    """JSON-lines (one object per row — the reference's default)."""

    ext = "json"

    def write(self, block: Block, ctx) -> str:
        import json

        out = self._filename(ctx)
        keys = list(block.keys())
        with open(out, "w") as f:
            n = block_num_rows(block)
            for i in range(n):
                row = {k: _jsonable(block[k][i]) for k in keys}
                if keys == [VALUE_COL]:
                    row = row[VALUE_COL]
                f.write(json.dumps(row) + "\n")
        return out


class NumpySink(_FileSink):
    ext = "npz"

    def write(self, block: Block, ctx) -> str:
        out = self._filename(ctx)
        np.savez(out.rsplit(".", 1)[0], **{k: np.asarray(v) for k, v in block.items()})
        return out


def _jsonable(v: Any):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
