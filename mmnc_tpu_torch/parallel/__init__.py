"""Data parallelism: one process per device over torch.distributed
(`launch`, `make_mesh`, `shard_batch`, `shard_train_state`), and the
compress of a batch split over the ranks
(`compress_device_fused_sharded`)."""

from .compress import compress_device_fused_sharded
from .mesh import Mesh, launch, make_mesh, shard_batch, shard_train_state

__all__ = ["Mesh", "compress_device_fused_sharded", "launch", "make_mesh",
           "shard_batch", "shard_train_state"]
