"""Shard-aware observability (port of `siddhi_tpu/sharding/metrics.py`):
per-shard state bytes and routing balance.  Each shard's state lives on its
own device in a `ShardedState`, so a shard's residency is the bytes of its
entry; read from tensor metadata, never a device fetch.  `step_collectives`
(EXPLAIN's HLO scan) waits for EXPLAIN.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..observability.memory import tree_nbytes
from .router import ShardedState, shard_count


def _state_shard_bytes(state, n: int, out: Dict[int, int]) -> None:
    """Add one state's bytes to `out` by shard: a `ShardedState` holds
    shard d's state at entry d (found at any depth of the state's
    tuples); whatever else the state holds lives on the mesh's first
    device, shard 0."""
    if isinstance(state, ShardedState):
        for d, part in enumerate(state):
            if d < n:
                out[d] += tree_nbytes(part)
        return
    if isinstance(state, (tuple, list)) and not hasattr(state, "_fields"):
        for part in state:
            _state_shard_bytes(part, n, out)
        return
    out[0] += tree_nbytes(state)


def shard_state_bytes(rt) -> Dict[int, int]:
    """{shard index: resident state bytes} for one app runtime on a mesh:
    each shard's entries of the key-distributed states, plus, on shard 0,
    every state that runs unsharded on the mesh's first device (tables,
    named windows, aggregations, joins, the replicated selector states).
    Read from tensor metadata only."""
    n = shard_count(rt)
    if n < 2:
        return {}
    out = {d: 0 for d in range(n)}
    for qr in getattr(rt, "query_runtimes", {}).values():
        _state_shard_bytes(getattr(qr, "state", None), n, out)
    for nw in getattr(rt, "named_windows", {}).values():
        _state_shard_bytes(getattr(nw, "state", None), n, out)
    for agg in getattr(rt, "aggregations", {}).values():
        for store in getattr(agg, "_dstores", {}).values():
            _state_shard_bytes(getattr(store, "slab", None), n, out)
    return out


def shard_events(rt) -> Dict[int, int]:
    """{shard index: events routed} summed over the app's sharded
    queries, from the statistics registry (host counters)."""
    n = shard_count(rt)
    out = {d: 0 for d in range(n)} if n >= 2 else {}
    snap = rt.stats.exposition_snapshot() if rt.stats.enabled else {}
    for _q, per_shard in snap.get("shard_events", {}).items():
        for d, c in enumerate(per_shard):
            if d in out:
                out[d] += int(c)
    return out


def shard_report(rt) -> Optional[Dict[str, Any]]:
    """/healthz `shards` section for one app: per-shard residency +
    routed-event balance with a skew verdict (max/mean of routed events;
    a shard at 0 while others flow reads `idle` — the PART002 lint
    hazard observed live)."""
    n = shard_count(rt)
    if n < 2:
        return None
    ev = shard_events(rt)
    by = shard_state_bytes(rt)
    total = sum(ev.values())
    mean = total / n if n else 0.0
    shards = {}
    for d in range(n):
        e = ev.get(d, 0)
        if total and e == 0:
            status = "idle"
        elif mean and e > 2.0 * mean:
            status = "hot"
        else:
            status = "ok"
        shards[str(d)] = {"events_total": e,
                          "state_bytes": by.get(d, 0),
                          "status": status}
    skew = (max(ev.values()) / mean) if total and mean else None
    report: Dict[str, Any] = {
        "devices": n,
        "layout": "round_robin(slot % n_shards)",
        "balanced": all(s["status"] == "ok" for s in shards.values()),
        "event_skew_max_over_mean":
            round(skew, 3) if skew is not None else None,
        "per_shard": shards,
    }
    # serving emission rings (serving/ring.py): ring slots carry the
    # producing step's sharding with a replicated slot axis, so each
    # device hosts its own segment of every buffered output — report the
    # per-shard resident bytes next to occupancy so operators can see
    # drain lag per device
    rings = {}
    for q, ring in (rt.serve_rings().items()
                    if hasattr(rt, "serve_rings") else ()):
        try:
            rings[q] = {
                "occupancy": ring.occupancy(),
                "capacity": ring.capacity,
                "shard_bytes": sum(tree_nbytes(s)
                                   for s in ring.state_leaves()),
            }
        except Exception:  # noqa: BLE001 — metrics must not throw
            continue
    if rings:
        report["serve_rings"] = rings
    return report
