"""Multi-device parallelism: doc-sharded index + mesh search execution."""

from .sharded import ShardedDeviceIndex, make_mesh

__all__ = ["ShardedDeviceIndex", "make_mesh"]
