"""Data parallelism: one process per device over torch.distributed
(`launch`, `make_mesh`, `shard_batch`, `shard_train_state`)."""

from .mesh import Mesh, launch, make_mesh, shard_batch, shard_train_state

__all__ = ["Mesh", "launch", "make_mesh", "shard_batch", "shard_train_state"]
