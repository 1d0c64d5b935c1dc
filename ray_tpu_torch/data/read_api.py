"""Dataset creation (reference ``python/ray/data/read_api.py``).

Sources become *read tasks* — no-arg callables, one per block, executed
remotely with the transform chain fused in. File readers use pyarrow at
the boundary and convert to the canonical numpy column-dict block."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.data.block import VALUE_COL, blocks_from_rows, normalize_block
from ray_tpu_torch.data.dataset import DEFAULT_BLOCK_SIZE, Dataset


def from_items(items: Sequence[Any], *, block_size: int = DEFAULT_BLOCK_SIZE) -> Dataset:
    blocks = blocks_from_rows(list(items), block_size)
    return Dataset([(lambda b=b: b) for b in blocks])


def range_(n: int, *, block_size: int = DEFAULT_BLOCK_SIZE) -> Dataset:
    def make_read(start: int, end: int):
        return lambda: {VALUE_COL: np.arange(start, end, dtype=np.int64)}

    return Dataset(
        [make_read(s, min(n, s + block_size)) for s in range(0, n, block_size)]
    )


def from_numpy(arr: "np.ndarray", *, block_size: int = DEFAULT_BLOCK_SIZE) -> Dataset:
    # Bind each task's SLICE, not the whole array: a closure over ``arr``
    # would ship the full array with every per-block remote task.
    def make_read(chunk: "np.ndarray"):
        return lambda: {VALUE_COL: chunk}

    n = len(arr)
    return Dataset(
        [make_read(arr[s : min(n, s + block_size)]) for s in range(0, n, block_size)]
    )


def from_pandas(df) -> Dataset:
    cols = {c: np.asarray(df[c].values) for c in df.columns}
    return Dataset([lambda: cols])


def from_arrow(table) -> Dataset:
    cols = {name: table.column(name).to_numpy(zero_copy_only=False) for name in table.column_names}
    return Dataset([lambda: cols])


def _expand_paths(paths: Union[str, Sequence[str]], suffix: str) -> List[str]:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, f"*{suffix}"))))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no {suffix} files under {paths}")
    return out


def read_parquet(paths: Union[str, Sequence[str]], *, columns: Optional[List[str]] = None) -> Dataset:
    """One read task per file (reference parquet datasource)."""
    files = _expand_paths(paths, ".parquet")

    def make_read(path: str):
        def read() -> Dict[str, np.ndarray]:
            import pyarrow.parquet as pq

            table = pq.read_table(path, columns=columns)
            return {
                name: table.column(name).to_numpy(zero_copy_only=False)
                for name in table.column_names
            }

        return read

    return Dataset([make_read(f) for f in files])


def read_csv(paths: Union[str, Sequence[str]]) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make_read(path: str):
        def read() -> Dict[str, np.ndarray]:
            import pyarrow.csv as pcsv

            table = pcsv.read_csv(path)
            return {
                name: table.column(name).to_numpy(zero_copy_only=False)
                for name in table.column_names
            }

        return read

    return Dataset([make_read(f) for f in files])


def read_numpy(paths: Union[str, Sequence[str]]) -> Dataset:
    """Reads ``.npy`` (one array → the value column) and ``.npz``
    (NumpySink output: one entry per block column)."""
    try:
        files = _expand_paths(paths, ".npy")
    except FileNotFoundError:
        files = _expand_paths(paths, ".npz")

    def make_read(path: str):
        def read():
            loaded = np.load(path)
            if isinstance(loaded, np.lib.npyio.NpzFile):
                return {k: loaded[k] for k in loaded.files}
            return {VALUE_COL: loaded}

        return read

    return Dataset([make_read(f) for f in files])


def read_json(paths: Union[str, Sequence[str]]) -> Dataset:
    """JSON-lines files, one read task per file (reference json
    datasource). Rows may be objects (become columns) or scalars
    (become the value column)."""
    files = _expand_paths(paths, ".json")

    def make_read(path: str):
        def read():
            import json

            rows = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
            blocks = blocks_from_rows(rows, max(1, len(rows)))
            return blocks[0] if blocks else {VALUE_COL: np.asarray([])}

        return read

    return Dataset([make_read(f) for f in files])


class Datasource:
    """Custom-source ABC (reference
    ``data/datasource/datasource.py``): implement ``get_read_tasks(n)``
    returning no-arg callables, each producing one block."""

    def get_read_tasks(self, parallelism: int):
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


def read_datasource(source: Datasource, *, parallelism: int = 8) -> Dataset:
    tasks = list(source.get_read_tasks(parallelism))
    if not tasks:
        raise ValueError("datasource produced no read tasks")
    return Dataset(tasks)
