"""Scaling past one device: meshes, sharded respond and sharded setup.

Multi-process serving lives in `.multihost` (imported on its own: joining
a process group is an explicit act)."""

from .sharding import (
    Mesh,
    ShardedPlanes,
    build_sharded_pallas_db,
    make_mesh,
    sharded_hint_ctr_packed,
    sharded_hint_packed_fn,
    sharded_respond_packed_fn,
)

__all__ = [
    "Mesh",
    "ShardedPlanes",
    "make_mesh",
    "build_sharded_pallas_db",
    "sharded_respond_packed_fn",
    "sharded_hint_packed_fn",
    "sharded_hint_ctr_packed",
]
