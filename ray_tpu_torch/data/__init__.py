"""ray_tpu_torch.data — distributed datasets on the object store.

Reference surface: python/ray/data/__init__.py (Dataset, read_* creation
APIs, GroupedDataset aggregates, DatasetPipeline).
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata  # noqa: F401
from ray_tpu_torch.data.compute import ActorPoolStrategy, TaskPoolStrategy  # noqa: F401
from ray_tpu_torch.data.dataset import Dataset  # noqa: F401
from ray_tpu_torch.data.grouped import (  # noqa: F401
    AggregateFn,
    Count,
    GroupedDataset,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.pipeline import DatasetPipeline  # noqa: F401
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_table,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "Dataset", "DatasetPipeline", "GroupedDataset", "AggregateFn",
    "BlockAccessor", "BlockMetadata", "Block",
    "ActorPoolStrategy", "TaskPoolStrategy",
    "Count", "Sum", "Min", "Max", "Mean", "Std",
    "from_items", "from_numpy", "from_pandas", "from_arrow",
    "range", "range_table",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files", "read_numpy",
]
