"""Key-space router: how partition keys map onto a mesh of shards (port of
`siddhi_tpu/sharding/router.py`).

- **shard assignment** is round-robin on the allocator slot
  (`slot % n_shards`), so sequential slot allocation spreads early keys
  across shards instead of parking them all on shard 0;
- **state row** of slot `s` on an `n`-way mesh of capacity `C` is
  `(s % n) * (C // n) + s // n`: shard `s % n` owns the contiguous global
  block `[d*C/n, (d+1)*C/n)` and stores the key at local row `s // n`;
- **re-bucketing** between mesh sizes is a pure permutation of state rows
  (`rebucket_index`).

The allocator slot a key resolves to is mesh-independent (the allocator
hashes key bytes, not devices); only the slot -> state-row layout depends
on the mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class ShardMesh:
    """The port's counterpart of `jax.sharding.Mesh(devices, ('shard',))`:
    one `torch.device` per shard, in shard order.  A device may repeat, so
    N logical shards can share one card; nothing assumes they do."""

    def __init__(self, devices: Sequence):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device the shards' outputs combine on."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"


class ShardedState(tuple):
    """A sharded plan's state: one entry per shard, in shard order, each on
    its shard's device (a pattern's (packed, selector state), a
    single-stream query's (window state, selector state))."""


def on_device(x, dev):
    """A tensor, or a nested tuple of tensors, on `dev` (a copy only where
    it lies elsewhere)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return tuple(on_device(v, dev) for v in x)


class ShardRouter:
    """Layout arithmetic + staging-time grouping for one key space
    (`capacity` slots) over `n_shards` shards.  `capacity` must divide
    evenly: the runtime rounds key capacities up to a mesh multiple at
    wiring time."""

    __slots__ = ("n_shards", "capacity", "block")

    def __init__(self, n_shards: int, capacity: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if capacity % n_shards != 0:
            raise ValueError(
                f"key capacity {capacity} is not divisible by "
                f"{n_shards} shards")
        self.n_shards = int(n_shards)
        self.capacity = int(capacity)
        self.block = self.capacity // self.n_shards

    # -- layout ---------------------------------------------------------------
    def shard_of(self, slots: np.ndarray) -> np.ndarray:
        """Shard owning each allocator slot (round-robin)."""
        return np.asarray(slots) % self.n_shards

    def local_of(self, slots: np.ndarray) -> np.ndarray:
        """Local state row of each slot on its owning shard."""
        return np.asarray(slots) // self.n_shards

    def state_row(self, slots: np.ndarray) -> np.ndarray:
        """Global state row of each allocator slot under the sharded
        layout."""
        s = np.asarray(slots)
        return (s % self.n_shards) * self.block + s // self.n_shards

    def slot_of_row(self, rows: np.ndarray) -> np.ndarray:
        """Inverse of state_row: the allocator slot stored at each global
        state row."""
        r = np.asarray(rows)
        return (r % self.block) * self.n_shards + r // self.block

    def rebucket_index(self, old: "ShardRouter") -> np.ndarray:
        """Permutation `src` moving key state between mesh layouts:
        `new_state[..., j] = old_state[..., src[j]]` for every global
        state row j.  Both routers must cover the same slot capacity."""
        if old.capacity != self.capacity:
            raise ValueError(
                f"cannot re-bucket between capacities {old.capacity} "
                f"and {self.capacity}")
        rows = np.arange(self.capacity, dtype=np.int64)
        return old.state_row(self.slot_of_row(rows))

    # -- staging-time grouping ------------------------------------------------
    def group(self, slots: np.ndarray, valid: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Arrange a batch's resolved slots into the sharded layout:
        (key_idx [n, Kb] int32 local rows, sel [n, Kb, E] int32 batch
        indices (-1 = padding), counts [n] int64 events routed to each
        shard).  Pad rows carry the local sentinel `block`, which the
        steps' scatter-back drops."""
        from ..core.keyslots import group_events_by_key
        n = self.n_shards
        slots = np.asarray(slots)
        shard = self.shard_of(slots)
        local = self.local_of(slots)
        groups = []
        counts = np.zeros(n, np.int64)
        for d in range(n):
            mask = (shard == d) & valid & (slots >= 0)
            counts[d] = int(mask.sum())
            groups.append(group_events_by_key(
                np.where(mask, local, -1), mask, pad=self.block))
        Kb = max(g[0].shape[0] for g in groups)
        E = max(g[1].shape[1] for g in groups)
        key_idx = np.full((n, Kb), self.block, np.int32)
        sel = np.full((n, Kb, E), -1, np.int32)
        for d, (ki, s, _kv) in enumerate(groups):
            key_idx[d, :ki.shape[0]] = ki
            sel[d, :s.shape[0], :s.shape[1]] = s
        return key_idx, sel, counts


# ---------------------------------------------------------------------------
# resolved accessors: the one place that maps a query runtime onto its mesh
# and key layout
# ---------------------------------------------------------------------------

def mesh_of(qr):
    """The plain / pattern shard mesh a query runtime executes under, or
    None (reads the compiled plan)."""
    return getattr(getattr(qr, "planned", qr), "mesh", None)


def keyed_mesh_of(qr):
    """The keyed-window shard mesh, or None."""
    return getattr(getattr(qr, "planned", qr), "keyed_mesh", None)


def shard_count(obj) -> int:
    """Shards of an app runtime's / a plan's mesh, or of a mesh (1 =
    unsharded)."""
    mesh = obj if isinstance(obj, ShardMesh) else getattr(obj, "mesh", obj)
    if not isinstance(mesh, ShardMesh):
        return 1
    return mesh.n


def router_for(qr) -> Optional[ShardRouter]:
    """ShardRouter of a query runtime's key-distributed state, or None
    when the query's state carries no sharded key axis."""
    p = getattr(qr, "planned", None)
    if p is None:
        return None
    mesh = mesh_of(qr)
    if isinstance(getattr(p, "steps", None), dict):     # pattern plan
        if not getattr(p, "partition_positions", None) or mesh is None:
            return None
        return ShardRouter(shard_count(mesh), int(p.key_capacity))
    kmesh = keyed_mesh_of(qr)
    if kmesh is not None and getattr(p, "keyed_window", False):
        return ShardRouter(shard_count(kmesh), int(p.key_capacity))
    if mesh is not None and getattr(p, "slot_allocator", None) is not None:
        return ShardRouter(shard_count(mesh),
                           int(p.slot_allocator.capacity))
    return None


def group_router_for(qr) -> Optional[ShardRouter]:
    """Router of a plain query's group-slot space (the selector slabs a
    windowless sharded group-by splits), or None when those slabs are
    replicated: a keyed-window query has a sharded key slab and
    replicated selector state."""
    p = getattr(qr, "planned", None)
    mesh = mesh_of(qr)
    if p is None or mesh is None or \
            isinstance(getattr(p, "steps", None), dict) or \
            getattr(p, "slot_allocator", None) is None:
        return None
    return ShardRouter(shard_count(mesh), int(p.slot_allocator.capacity))
