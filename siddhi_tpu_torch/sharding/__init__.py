"""Sharding over the key axis (port of `siddhi_tpu/sharding/`).

A partitioned app deployed with `create_siddhi_app_runtime(app,
mesh=ShardMesh(devices))` splits its key-distributed state over the
mesh's shards: shard `s % n` owns allocator slot `s` at local row
`s // n` (`router.py`).  Each shard's state lives on its own device; the
steps run once per shard and their outputs combine on the first device
through kernel K32 (`kernels/shard_merge.py`), the port's form of the
JAX package's psum / pmin.  A device may repeat: `ShardMesh([cuda:0] *
4)` runs four logical shards on one card.

The JAX package's `snapshot.py` (a restore that resizes the mesh) waits
for persistence (ROADMAP A13), and its `metrics.py` for the host layers
(A15).
"""
from .router import (ShardMesh, ShardRouter, ShardedState,  # noqa: F401
                     group_router_for, keyed_mesh_of, mesh_of, on_device,
                     router_for, shard_count)
