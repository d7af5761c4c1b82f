"""Data-parallel compress (tests/test_multichip_compress.py holds the JAX
package's fused compress under a batch-sharded jit to one device's).

Every rank runs the v2 program (`_compress_device_fused`: int16 y and z
symbols, uint8 y indexes, max_abs) on its rows of the global batch
(`shard_batch`), and the ranks all-gather the results in rank order: the
symbols and indexes of the global batch, which the rANS coder turns into
the bytes of one process's `compress`.
"""

import torch

from .mesh import Mesh, shard_batch


@torch.no_grad()
def compress_device_fused_sharded(model, batch: dict, mesh: Mesh):
    """-> (y_sym i16, z_sym i16, indexes u8) NHWC of the global `batch`
    and max_abs (int32 scalar), on this rank's device: one process's
    `model._compress_device_fused(batch)`, computed a shard a rank."""
    y_sym, z_sym, indexes, max_abs = model._compress_device_fused(
        shard_batch(batch, mesh))
    return (mesh.all_gather(y_sym), mesh.all_gather(z_sym),
            mesh.all_gather(indexes),
            mesh.all_gather(max_abs.reshape(1)).max())
