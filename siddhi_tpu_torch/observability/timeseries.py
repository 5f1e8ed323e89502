"""In-process time series (port of `siddhi_tpu/observability/timeseries.py`):
a daemon sampler (`SiddhiManager.start_sampler`) snapshots every app's
host-side metrics into ring-buffer series each tick, keeps a per-tenant
account and evaluates the SLO rules.  Host reads only: no device fetch.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

DEFAULT_INTERVAL_S = 1.0
DEFAULT_WINDOW = 600          # ticks retained: 10 min at the 1s default


class Series:
    """Fixed-size ring buffer of (t, value) samples for ONE metric.
    Appends are O(1); the deque's maxlen bounds memory regardless of
    soak duration."""

    __slots__ = ("name", "_buf")

    def __init__(self, name: str, window: int = DEFAULT_WINDOW):
        self.name = name
        self._buf: deque = deque(maxlen=max(2, int(window)))

    def append(self, t: float, v: float) -> None:
        self._buf.append((float(t), float(v)))

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def last(self) -> Optional[float]:
        return self._buf[-1][1] if self._buf else None

    def delta(self) -> float:
        """Change over the most recent tick (0.0 with <2 samples)."""
        if len(self._buf) < 2:
            return 0.0
        return self._buf[-1][1] - self._buf[-2][1]

    def rate(self, window_s: Optional[float] = None) -> float:
        """Slope of a cumulative-counter series over the trailing
        `window_s` seconds (whole ring when None): the windowed per-second
        rate.  Clamped at 0 — counter resets read as quiet, not negative."""
        if len(self._buf) < 2:
            return 0.0
        t1, v1 = self._buf[-1]
        t0, v0 = self._buf[0]
        if window_s is not None:
            for t, v in self._buf:
                if t1 - t <= window_s:
                    t0, v0 = t, v
                    break
        span = t1 - t0
        if span <= 0:
            return 0.0
        return max(0.0, (v1 - v0) / span)

    def to_dict(self) -> Dict[str, List[float]]:
        ts = [t for t, _ in self._buf]
        vs = [v for _, v in self._buf]
        return {"t": ts, "v": vs}


class SeriesStore:
    """All of one app's series: name -> Series ring.  The store itself
    lives on the runtime (`rt._timeseries`) so REST/health read it after
    the sampler that filled it is gone."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = max(2, int(window))
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is not None:
            return s
        with self._lock:
            return self._series.setdefault(name, Series(name, self.window))

    def record(self, name: str, t: float, v) -> None:
        self.series(name).append(t, v)

    def get(self, name: str) -> Optional[Series]:
        return self._series.get(name)

    def names(self) -> List[str]:
        return sorted(self._series)

    def last(self, name: str) -> Optional[float]:
        s = self._series.get(name)
        return s.last if s is not None else None

    def to_dict(self) -> Dict[str, Dict[str, List[float]]]:
        with self._lock:
            items = list(self._series.items())
        return {name: s.to_dict() for name, s in sorted(items)}


def _sink_totals(rt) -> Dict[str, int]:
    """Aggregate sink-connection counters for one app: sinks are not
    ported (@sink raises), so every total is 0."""
    return {"retries": 0, "dropped": 0, "buffered": 0, "broken": 0}


def tenant_account(rt, snap: Optional[Dict] = None) -> Dict:
    """Per-tenant resource accounting for one app runtime, from host
    counters and metadata only: the numbers a future admission controller
    charges a tenant for.  `snap` is a stats exposition_snapshot (taken
    fresh when None)."""
    st = rt.stats
    if snap is None:
        snap = st.exposition_snapshot()
    counters = snap.get("counters", {})
    qhist = snap.get("query_hist", {})
    recompiles = {}
    try:
        recompiles = {owner: info["count"]
                      for owner, info in st.recompiles(rt).items()
                      if info.get("count")}
    except Exception:  # noqa: BLE001 — metrics must not throw
        pass
    from .memory import total_bytes
    sink = _sink_totals(rt)
    return {
        "events_in": sum(snap.get("stream_in", {}).values()),
        "events_out": sum(v for k, v in counters.items()
                          if k.endswith(".emitted_rows")),
        "emitted_bytes": sum(v for k, v in counters.items()
                             if k.endswith(".emitted_bytes")),
        # total wall time spent inside query dispatch (base per-query
        # histograms only: `:e2e` carries queue wait, not dispatch work,
        # and `:fused` dispatches are already inside the triggering
        # batch's base sample — both would double-bill the tenant)
        "dispatch_wall_ns": sum(h.sum_ns for k, h in qhist.items()
                                if ":" not in k),
        "dropped": sum(v for k, v in counters.items()
                       if k.endswith(".dropped")) + sink["dropped"],
        "cap_growths": sum(v for k, v in counters.items()
                           if k.endswith(".cap_growths")),
        "recompiles": sum(recompiles.values()),
        "recompile_blame": recompiles,
        "state_bytes": total_bytes(rt),
        "sink_retries": sink["retries"],
        "queue_depth": sum(rt.queue_depths().values())
        if hasattr(rt, "queue_depths") else 0,
        # admission charges: the controller is not ported
        "admission_shed": 0,           # no admission controller yet
        "admission_blocked_ms": 0,
        # state observatory (observability/stateobs.py): the worst
        # fixed-capacity utilization and the deepest high-water a
        # tenant's structures have reached — the sizing exposure an
        # admission controller would charge for
        "state_worst_utilization": _stateobs_worst(snap),
        "state_high_water_sum": sum(
            rec.get("high_water", 0)
            for structures in snap.get("stateobs", {})
            .get("structures", {}).values()
            for rec in structures.values()),
    }


def _stateobs_worst(snap: Dict) -> float:
    worst = 0.0
    for structures in snap.get("stateobs", {}).get("structures",
                                                   {}).values():
        for rec in structures.values():
            if not rec.get("growable", True):
                worst = max(worst, rec.get("utilization", 0.0))
    return round(worst, 4)


class TimeSeriesSampler:
    """Samples every deployed app on a fixed tick into per-app
    `SeriesStore` rings and evaluates the SLO engine over them.

    Tests drive `tick(now)` directly with a virtual clock — the thread
    is only the production scheduler around it."""

    def __init__(self, manager, interval_s: Optional[float] = None,
                 window: Optional[int] = None, rules=None,
                 clock: Optional[Callable[[], float]] = None):
        cm = getattr(manager, "config_manager", None)

        def prop(name):
            try:
                return cm.extract_property(name) if cm is not None else None
            except Exception:  # noqa: BLE001 — config must not break boot
                return None

        if interval_s is None:
            interval_s = float(prop("metrics.sampler.interval.seconds")
                               or DEFAULT_INTERVAL_S)
        if window is None:
            window = int(prop("metrics.sampler.window") or DEFAULT_WINDOW)
        self.manager = manager
        self.interval_s = max(0.01, float(interval_s))
        self.window = max(2, int(window))
        self._clock = clock if clock is not None else time.monotonic
        from .slo import SLOEngine
        self.slo = SLOEngine(rules=rules, config=cm)
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_tick_wall_ns = 0      # host cost of the last tick

    # -- sampling --------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One sampling pass over every app.  Host-side reads only."""
        now = self._clock() if now is None else float(now)
        t_wall = time.perf_counter_ns()
        for name, rt in list(getattr(self.manager, "runtimes", {}).items()):
            try:
                self._sample_app(name, rt, now)
            except Exception:  # noqa: BLE001 — one sick app must not
                pass           # starve the others' series
        self.ticks += 1
        self._last_tick_wall_ns = time.perf_counter_ns() - t_wall

    def _sample_app(self, name: str, rt, now: float) -> None:
        store = rt.__dict__.get("_timeseries")
        if store is None or store.window != self.window:
            store = rt.__dict__["_timeseries"] = SeriesStore(self.window)
        st = rt.stats
        # refresh the state observatory from the host mirrors before
        # snapshotting, so the tick's series see current occupancy
        from .stateobs import collect as _stateobs_collect
        _stateobs_collect(rt)
        snap = st.exposition_snapshot()
        acct = tenant_account(rt, snap)
        rt._tenant_account = acct

        rec = store.record
        # tenant accounting: cumulative counters sampled as series
        rec("events_in", now, acct["events_in"])
        rec("events_out", now, acct["events_out"])
        rec("emitted_bytes", now, acct["emitted_bytes"])
        rec("dispatch_wall_ns", now, acct["dispatch_wall_ns"])
        rec("dropped", now, acct["dropped"])
        rec("cap_growths", now, acct["cap_growths"])
        rec("recompiles", now, acct["recompiles"])
        rec("state_bytes", now, acct["state_bytes"])
        # queue/backpressure gauges
        rec("buffered_emissions", now, rt.buffered_emissions()
            if hasattr(rt, "buffered_emissions") else 0)
        rec("async_queue_depth", now, acct["queue_depth"])
        rec("drainer_queue_depth", now, rt.drainer_depth()
            if hasattr(rt, "drainer_depth") else 0)
        # sink resilience + error store
        sink = _sink_totals(rt)
        rec("sink_retries", now, sink["retries"])
        rec("sink_dropped", now, sink["dropped"])
        rec("sink_buffered", now, sink["buffered"])
        rec("sink_broken", now, sink["broken"])
        es = getattr(rt, "error_store", None)
        if es is not None:
            try:
                rec("errorstore_buffered", now,
                    es.stats().get("buffered", 0))
            except Exception:  # noqa: BLE001 — custom SPI must not break
                pass
        # per-stream throughput + ingress queue depth
        for sid, n in snap.get("stream_in", {}).items():
            rec(f"stream.{sid}.events", now, n)
        if hasattr(rt, "queue_depths"):
            for sid, d in rt.queue_depths().items():
                rec(f"stream.{sid}.queue_depth", now, d)
        # per-query latency quantiles (cumulative log2 histograms — the
        # series is the TRAJECTORY of the quantile, i.e. the p99 curve
        # the soak artifact plots) + processed-event counters
        for q, h in snap.get("query_hist", {}).items():
            rec(f"query.{q}.p50_us", now, h.quantile(0.50) / 1e3)
            rec(f"query.{q}.p99_us", now, h.quantile(0.99) / 1e3)
        for q, n in snap.get("query_events", {}).items():
            rec(f"query.{q}.events", now, n)
        # phase profiler series: cumulative per-phase ns plus the sampled
        # deep-mode dispatch counter (observability/phases.py) — windowed
        # per-phase rates derive below with the other counter rates
        ph_snap = snap.get("phases", {})
        for q, phases in ph_snap.get("queries", {}).items():
            for p, v in phases.items():
                rec(f"phase.{q}.{p}_ns", now, v["ns"])
        for q, n in ph_snap.get("sampled", {}).items():
            rec(f"phase.{q}.sampled_dispatches", now, n)
        # state observatory series: per-(query, structure) utilization +
        # high-water trajectories and per-query hot-set concentration —
        # the occupancy histogram ROADMAP item 4's tiering design reads
        so_snap = snap.get("stateobs", {})
        for q, structures in so_snap.get("structures", {}).items():
            for s, v in structures.items():
                rec(f"state.{q}.{s}.utilization", now, v["utilization"])
                rec(f"state.{q}.{s}.high_water", now, v["high_water"])
        for q, hot in so_snap.get("hotness", {}).items():
            rec(f"state.{q}.hot_share_1pct", now, hot["hot_share_1pct"])
        # shard balance (meshed apps): skew gauge from host counters
        try:
            from ..sharding.metrics import shard_report
            rep = shard_report(rt)
            if rep is not None and rep.get("event_skew_max_over_mean"):
                rec("shard_skew", now, rep["event_skew_max_over_mean"])
        except Exception:  # noqa: BLE001 — metrics must not throw
            pass
        # @async(queue.policy='shed') losses, summed across streams
        a_shed = sum(v for k, v in snap.get("counters", {}).items()
                     if k.startswith("async.") and k.endswith(".shed"))
        if a_shed:
            rec("async_shed", now, a_shed)
        # derived windowed rates, recorded as series themselves so the
        # artifact carries the ev/s curve, not just the raw counter
        rate_w = min(60.0, self.window * self.interval_s)
        for src, dst in (("events_in", "rate.events_in_per_s"),
                         ("events_out", "rate.events_out_per_s"),
                         ("dropped", "rate.dropped_per_s"),
                         ("recompiles", "rate.recompiles_per_s")):
            s = store.get(src)
            if s is not None:
                rec(dst, now, s.rate(rate_w))
        # per-phase burn rates (ns of phase wall accumulated per second):
        # the live view of where the pipeline budget is going right now
        for q, phases in ph_snap.get("queries", {}).items():
            for p in phases:
                s = store.get(f"phase.{q}.{p}_ns")
                if s is not None:
                    rec(f"rate.phase.{q}.{p}_ns_per_s", now,
                        s.rate(rate_w))
        # SLO rules evaluate over the freshly-appended series
        rt._slo_state = self.slo.evaluate(name, rt, store, now)

    # -- thread lifecycle ------------------------------------------------------
    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="siddhi-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — sampler must not die
                pass
