"""ray_tpu_torch.data — streaming, block-structured datasets over the runtime.

Reference: ``python/ray/data/`` (Dataset / read_api / streaming executor
/ block batching). See ``dataset.py`` for the TPU-first design notes."""

from ray_tpu_torch.data.block import Block, VALUE_COL
from ray_tpu_torch.data.dataset import Dataset, DataShard
from ray_tpu_torch.data.executor import ActorPoolStrategy
from ray_tpu_torch.data.grouped import (
    AggregateFn,
    Count,
    GroupedData,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.datasink import (
    CSVSink,
    Datasink,
    JSONSink,
    NumpySink,
    ParquetSink,
)
from ray_tpu_torch.data.read_api import (
    Datasource,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range_,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
)

#: reference-parity alias (``ray.data.range``)
range = range_  # noqa: A001

__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "Block",
    "Count",
    "GroupedData",
    "Max",
    "Mean",
    "Min",
    "Std",
    "Sum",
    "VALUE_COL",
    "CSVSink",
    "Datasink",
    "Datasource",
    "Dataset",
    "DataShard",
    "JSONSink",
    "NumpySink",
    "ParquetSink",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_",
    "read_csv",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_parquet",
]
