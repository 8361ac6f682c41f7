"""ray_tpu_torch.data: streaming datasets (port of ``ray_tpu.data``;
reference: Ray Data).

A ``Dataset`` is a lazy plan over blocks kept in the port's object store,
run by the streaming executor on the port's tasks and actors; its
``DataIterator`` re-batches the blocks and feeds the card
(``iter_torch_batches``), and ``streaming_split`` feeds a trainer's ranks.
Exports every name of ``ray_tpu.data``.
"""

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu

_rlu("data")

from ray_tpu_torch.data import aggregate, preprocessors  # noqa: E402
from ray_tpu_torch.data.block import BlockAccessor  # noqa: E402
from ray_tpu_torch.data.context import DataContext  # noqa: E402
from ray_tpu_torch.data.dataset import (  # noqa: E402
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004 - mirrors the reference's ray.data.range
    read_avro,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_parquet,
    read_text,
    read_tfrecords,
    read_webdataset,
    write_avro_file,
    write_tfrecords_file,
)
from ray_tpu_torch.data.execution import (  # noqa: E402
    ExecutionOptions,
    StreamingExecutor,
)
from ray_tpu_torch.data.grouped import GroupedData  # noqa: E402
from ray_tpu_torch.data.iterator import DataIterator  # noqa: E402
from ray_tpu_torch.data.mongo import read_mongo, write_mongo  # noqa: E402
from ray_tpu_torch.data.sql import read_sql, write_sql  # noqa: E402

__all__ = [
    "BlockAccessor",
    "DataContext",
    "Dataset",
    "DataIterator",
    "ExecutionOptions",
    "GroupedData",
    "StreamingExecutor",
    "aggregate",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "preprocessors",
    "range",
    "read_avro",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_json",
    "read_mongo",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
    "write_avro_file",
    "write_mongo",
    "write_sql",
    "write_tfrecords_file",
]
