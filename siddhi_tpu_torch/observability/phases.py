"""Phase-level hot-path profiler (port of `siddhi_tpu/observability/phases.py`).

An always-on accumulator of per-(query, phase) nanosecond counters fed from
HOST clocks at the pipeline's boundaries: no device fetch and no sync on
the steady path, so it stays on in production.

The phase names and the attribution rule are the JAX package's.  Where the
wait surfaces differs, and this module says so rather than pretend:

  stage_host       host staging: pack_np, slot binding, [Kb, E] grouping
  h2d              explicit device upload (serving/staging.py)
  dispatch_submit  the step call's wall: kernel launches return at submit
  device_compute   sampled only: a CUDA event recorded after the step on
                   the step's stream, then synchronized (the JAX package's
                   `block_until_ready` fence); never on unsampled dispatches
  ring_wait        emission-ring residency (append -> take)
  d2h_drain        the header fetch.  A torch rebind never blocks (the JAX
                   package's `_rebind_state` waits on XLA's buffer
                   retirement), so the port's unsampled step wall lands here
  demux            header decode / unpack / ts restore in delivery
  sink             callbacks + downstream routing

`profile.sample.every=N` fences every Nth dispatch per query; the
sampled-dispatch counter (`siddhi_phase_dispatches_sampled_total`) says how
much traffic paid for that visibility.  Counters are per-query LATENCY
attribution: a batched fetch serving three queries charges its wall to
each, as each query's `<q>:e2e` histogram sample does, so per query
sum(phases) tracks e2e and the remainder is `other` in `phase_report()`.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

# canonical order — every surface (report, /metrics, /timeseries, PERF
# tables) lists phases in pipeline order, not dict order
PHASES = ("stage_host", "h2d", "dispatch_submit", "device_compute",
          "ring_wait", "d2h_drain", "demux", "sink")


class PhaseProfiler:
    """Always-on per-(query, phase) ns accumulator.  One per
    StatisticsManager (i.e. per app runtime); `add` is the single
    hot-path entry — a dict upsert under a short lock, no allocation
    beyond the first sample of a (query, phase) pair."""

    __slots__ = ("_lock", "_ns", "_count", "_dispatches", "_sampled")

    def __init__(self):
        self._lock = threading.Lock()
        self._ns: Dict[tuple, int] = {}        # (query, phase) -> total ns
        self._count: Dict[tuple, int] = {}     # (query, phase) -> samples
        self._dispatches: Dict[str, int] = {}  # query -> dispatch counter
        self._sampled: Dict[str, int] = {}     # query -> fenced dispatches

    def add(self, query: str, phase: str, ns: int) -> None:
        if ns <= 0:
            return
        key = (query, phase)
        with self._lock:
            self._ns[key] = self._ns.get(key, 0) + int(ns)
            self._count[key] = self._count.get(key, 0) + 1

    def should_sample(self, query: str, every: int) -> bool:
        """Per-query dispatch modulus for the deep mode: True on every
        Nth dispatch (the caller then fences with a CUDA event and
        records `device_compute`).  Counts the sampled dispatch so the
        exposition can report what fraction of traffic paid the fence."""
        if every <= 0:
            return False
        with self._lock:
            n = self._dispatches.get(query, 0) + 1
            self._dispatches[query] = n
            if n % every:
                return False
            self._sampled[query] = self._sampled.get(query, 0) + 1
        return True

    def snapshot(self) -> Dict:
        """{"queries": {q: {phase: {"ns", "count"}}}, "sampled": {q: n}}
        — phases in canonical order; shallow int copies, scrape-safe."""
        with self._lock:
            ns = dict(self._ns)
            count = dict(self._count)
            sampled = dict(self._sampled)
        queries: Dict[str, Dict] = {}
        for (q, p), total in ns.items():
            queries.setdefault(q, {})[p] = {"ns": total,
                                            "count": count.get((q, p), 0)}
        for q in queries:
            queries[q] = {p: queries[q][p] for p in PHASES
                          if p in queries[q]}
        return {"queries": queries, "sampled": sampled}

    def reset(self) -> None:
        with self._lock:
            self._ns.clear()
            self._count.clear()
            self._dispatches.clear()
            self._sampled.clear()


def sample_every(rt) -> int:
    """`profile.sample.every=N` config (0 = deep mode off, the default),
    memoized on the runtime like serving_config — the hot path reads one
    dict slot, never the ConfigManager."""
    every = rt.__dict__.get("_profile_sample_every")
    if every is None:
        every = 0
        try:
            cm = getattr(rt, "config_manager", None)
            v = cm.extract_property("profile.sample.every") \
                if cm is not None else None
            if v is not None:
                every = max(0, int(v))
        except Exception:  # noqa: BLE001 — profiling must not throw
            every = 0
        rt.__dict__["_profile_sample_every"] = every
    return every


def phase_report(rt) -> Dict:
    """Per-query phase budget vs the `<q>:e2e` histogram: seconds + share
    per phase, with the unattributed remainder reported as `other` (the
    acceptance bar: phases account >=90% of measured e2e wall for a
    @serve flagship run).  Queries with phase samples but no e2e
    histogram (statistics OFF mid-flight) report shares of the phase sum
    instead."""
    st = rt.stats
    snap = st.phases.snapshot()
    queries = {}
    for q, phases in snap["queries"].items():
        total_ns = sum(v["ns"] for v in phases.values())
        e2e = st.e2e_sum_ns(q)
        base = e2e if e2e > 0 else total_ns
        entry = {
            p: {"seconds": round(v["ns"] / 1e9, 6),
                "count": v["count"],
                "share": round(v["ns"] / base, 4) if base else 0.0}
            for p, v in phases.items()}
        other_ns = max(0, e2e - total_ns) if e2e > 0 else 0
        queries[q] = {
            "phases": entry,
            "e2e_seconds": round(e2e / 1e9, 6),
            "other_seconds": round(other_ns / 1e9, 6),
            "accounted": round(min(total_ns / base, 1.0), 4)
            if base else 0.0,
            "sampled_dispatches": snap["sampled"].get(q, 0),
        }
    return {"app": rt.name, "sample_every": sample_every(rt),
            "queries": queries}
