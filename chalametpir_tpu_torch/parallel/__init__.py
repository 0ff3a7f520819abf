"""Scaling past one device: meshes, sharded respond and sharded setup.

Multi-process serving lives in `.multihost` (imported on its own: joining
a process group is an explicit act)."""

from .sharding import (
    Mesh,
    ShardedDigitPlane,
    ShardedPlanes,
    build_sharded_pallas_db,
    make_mesh,
    pad_db_planes,
    shard_db_planes,
    sharded_hint_accumulate_fn,
    sharded_hint_ctr_packed,
    sharded_hint_packed_fn,
    sharded_respond_fn,
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
    "ShardedDigitPlane",
    "pad_db_planes",
    "shard_db_planes",
    "sharded_respond_fn",
    "sharded_hint_accumulate_fn",
]
