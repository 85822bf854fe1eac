"""Mesh-sharded builds of the port: the mesh, the sharded covariance
blocks over the K1-K3 kernels, the sharded Cholesky and the dry run."""
from .mesh import Mesh, make_mesh, shard_train_data  # noqa: F401
from .sharded_kernels import (k_block_sharded, kef_sharded,  # noqa: F401
                              kff_sharded, partition_tri_tiles,
                              self_blocks_sharded)
from .cholesky import cholesky_sharded  # noqa: F401
