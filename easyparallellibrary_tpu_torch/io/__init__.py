"""Input pipeline of the PyTorch port (port of
``easyparallellibrary_tpu/io``): record files, file sharding and the
host-to-device prefetcher."""

from easyparallellibrary_tpu_torch.io.dataloader import (
    RecordReader, native_io_available, write_records)
from easyparallellibrary_tpu_torch.io.device import (
    DevicePrefetcher, global_batch)
from easyparallellibrary_tpu_torch.io.sharding import (
    shard_batch_dim, shard_files)

__all__ = [
    "shard_files", "shard_batch_dim", "RecordReader", "write_records",
    "native_io_available", "DevicePrefetcher", "global_batch",
]
