"""Device-resident serving loop (port of `siddhi_tpu/serving`).

Three pieces, one invariant — the SEND PATH NEVER FETCHES:

- ring.py      emission rings on the card: a step's output block appends
               into a persistent ring (one launch of kernel K30, no
               device-to-host transfer)
- drain.py     the per-app serving drainer: the only thread that waits on
               a device-to-host copy; it delivers through the unchanged
               delivery functions
- staging.py   double-buffered host-to-device staging: batch N+1 uploads
               on a side stream while batch N computes

Enablement: `@serve` on a query / input stream / `@app:serve`
(`core/plan_facts.serve_enabled`), or app-wide by the config property
`serving.enabled: 'true'`.  Ring sizing and drain cadence read
`serving.ring.capacity` (slots, default `plan_facts.SERVE_RING_SLOTS`)
and `serving.drain.interval.ms` (default 2 ms); `@serve(ring.capacity=)`
overrides the size per query.
"""
from __future__ import annotations

from ..core.plan_facts import SERVE_RING_SLOTS
from .drain import ServingDrainer
from .ring import EmissionRing
from .staging import DoubleBufferedStager

__all__ = ["EmissionRing", "ServingDrainer", "DoubleBufferedStager",
           "serving_config", "ensure_ring", "ring_append",
           "SERVE_RING_SLOTS"]

_TRUE = ("true", "1", "yes", "on")
DEFAULT_DRAIN_INTERVAL_MS = 2.0


def serving_config(rt) -> dict:
    """App-level serving settings from the manager config (memoized on the
    runtime: config cannot change under a live manager)."""
    cfg = rt.__dict__.get("_serving_config")
    if cfg is not None:
        return cfg
    enabled = False
    capacity = SERVE_RING_SLOTS
    interval_ms = DEFAULT_DRAIN_INTERVAL_MS
    try:
        cm = getattr(rt, "config_manager", None)
        if cm is not None:
            v = cm.extract_property("serving.enabled")
            if v is not None:
                enabled = str(v).lower() in _TRUE
            v = cm.extract_property("serving.ring.capacity")
            if v:
                capacity = max(1, int(v))
            v = cm.extract_property("serving.drain.interval.ms")
            if v:
                interval_ms = max(0.0, float(v))
    except Exception:  # noqa: BLE001 — malformed config reads as default
        pass
    cfg = {"enabled": enabled, "ring_capacity": capacity,
           "drain_interval_ms": interval_ms}
    rt.__dict__["_serving_config"] = cfg
    return cfg


def ensure_ring(qr) -> EmissionRing:
    """The query's emission ring, created on its first serving emission
    and registered with the app's serving drainer (which starts its
    thread then)."""
    ring = qr.__dict__.get("_serve_ring")
    if ring is None:
        app = qr.app
        cap = int(getattr(qr, "serve_ring_capacity", 0) or 0)
        drainer = app._serve_drainer
        ring = EmissionRing(qr, capacity=cap or serving_config(app)[
            "ring_capacity"], on_highwater=drainer.kick)
        qr.__dict__["_serve_ring"] = ring
        drainer.register(ring)
    return ring


def ring_append(qr, out, header, now: int, deliver) -> None:
    """Producer edge of the serving loop: the ring append is queued on the
    card and the call returns, with no device-to-host transfer
    (`core/runtime.py` `_emit` routes here for serving queries)."""
    ensure_ring(qr).append(out, header, now, deliver)
