"""Chrome trace-event export of the tracer's ring (port of
`siddhi_tpu/observability/chrome_trace.py`): every finished batch trace
becomes complete ("X") events on one process, a track per thread, loadable
in chrome://tracing or Perfetto.

Also here: a guarded `torch.profiler` start / stop (one session at a time)
in place of the JAX package's `jax.profiler`, for device-level deep dives.
"""
from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List, Optional

# drain tracks sit far above any realistic trace id so they never collide
# with per-batch tids (trace ids are a process-global counter from 1)
_DRAIN_TID_BASE = 1_000_000_000


def trace_events(runtimes: Dict, query: Optional[str] = None,
                 limit: int = 256) -> List[Dict]:
    """Flat trace-event list for every app's recent batch traces."""
    events: List[Dict] = []
    for pid, (app_name, rt) in enumerate(sorted(runtimes.items()), 1):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"siddhi:{app_name}"}})
        # all drain-side (adopted) spans of an app share one track: the
        # drainer really is one thread, and a shared track makes its
        # serialised deliveries visually obvious
        drain_tid = _DRAIN_TID_BASE + pid
        drain_named = False
        for tr in rt.trace_dump(query, limit):
            tid = int(tr["trace_id"])
            spans = tr.get("spans", ())
            # batch-level umbrella event spans the whole dispatch
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"batch {tr['trace_id']} "
                                 f"[{tr['stream']}]"}})
            # offsets are relative to the batch start; re-anchor on the
            # batch's wall clock (ms resolution) so tracks align in time
            base_us = float(tr.get("wall_ms", 0)) * 1e3
            events.append({
                "ph": "X", "name": f"dispatch {tr['stream']}",
                "cat": "batch", "pid": pid, "tid": tid,
                "ts": base_us, "dur": float(tr.get("total_us", 0.0)),
                "args": {"events": tr.get("events"),
                         "trace_id": tr.get("trace_id")}})
            first_drain_ts = None
            last_dispatch_end = base_us
            for s in spans:
                on_drain = s.get("track") == "drain"
                ts = base_us + float(s.get("offset_us") or 0.0)
                dur = float(s.get("duration_us", 0.0))
                args = {k: v for k, v in s.items()
                        if k not in ("stage", "duration_us", "offset_us",
                                     "track")}
                events.append({
                    "ph": "X", "name": s["stage"], "cat": "span",
                    "pid": pid, "tid": drain_tid if on_drain else tid,
                    "ts": ts, "dur": dur, "args": args})
                if on_drain:
                    if first_drain_ts is None or ts < first_drain_ts:
                        first_drain_ts = ts
                else:
                    last_dispatch_end = max(last_dispatch_end, ts + dur)
            if first_drain_ts is None:
                continue
            # flow arrow: dispatch track -> drainer delivery.  The start
            # binds at the last dispatch-side span (the emit/handoff) and
            # the finish (bp:"e" = bind to enclosing slice) at the first
            # adopted span, so Perfetto draws one arrow per batch.
            if not drain_named:
                drain_named = True
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": drain_tid, "args": {"name": "drain"}})
            flow_id = int(tr["trace_id"])
            events.append({
                "ph": "s", "name": "handoff", "cat": "flow",
                "id": flow_id, "pid": pid, "tid": tid,
                "ts": min(last_dispatch_end, first_drain_ts)})
            events.append({
                "ph": "f", "bp": "e", "name": "handoff", "cat": "flow",
                "id": flow_id, "pid": pid, "tid": drain_tid,
                "ts": first_drain_ts})
    # a stable time order keeps the JSON loadable by strict parsers and
    # the tracks deterministic (metadata records lead, then global ts
    # order across all processes)
    events.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                               e.get("ts", 0.0)))
    return events


def chrome_trace(runtimes: Dict, query: Optional[str] = None,
                 limit: int = 256) -> Dict:
    """Chrome trace-event JSON object (the format Perfetto ingests)."""
    return {
        "traceEvents": trace_events(runtimes, query, limit),
        "displayTimeUnit": "ms",
        "otherData": {"source": "siddhi_tpu_torch PipelineTracer",
                      "format": "chrome-trace-event"},
    }


# ---------------------------------------------------------------------------
# torch.profiler guard: explicit start/stop, one session at a time
# ---------------------------------------------------------------------------

_prof_lock = threading.Lock()
_prof_dir: Optional[str] = None
_prof = None


def start_profiler(log_dir: Optional[str] = None) -> Dict:
    """Start a `torch.profiler` session (CPU and, where a card is present,
    CUDA activity).  Returns {started, log_dir} or raises RuntimeError
    when a session is already active (the profiler is process-global: two
    sessions would corrupt each other's capture).  `log_dir` defaults to
    a directory under the temporary directory."""
    global _prof_dir, _prof
    with _prof_lock:
        if _prof_dir is not None:
            raise RuntimeError(
                f"profiler already running (log_dir={_prof_dir!r}); "
                f"stop it first")
        import torch
        from torch.profiler import ProfilerActivity, profile
        if log_dir is None:
            log_dir = os.path.join(tempfile.gettempdir(),
                                   "siddhi_tpu_torch_profile")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        p = profile(activities=acts)
        p.start()
        _prof, _prof_dir = p, log_dir
    return {"started": True, "log_dir": log_dir}


def stop_profiler() -> Dict:
    """Stop the active session and write its Chrome trace to
    `<log_dir>/trace.json`; raises RuntimeError when none is running."""
    global _prof_dir, _prof
    with _prof_lock:
        if _prof_dir is None:
            raise RuntimeError("no profiler session running")
        p, d = _prof, _prof_dir
        _prof = _prof_dir = None
        p.stop()
        os.makedirs(d, exist_ok=True)
        p.export_chrome_trace(os.path.join(d, "trace.json"))
    return {"stopped": True, "log_dir": d}


def profiler_status() -> Dict:
    with _prof_lock:
        return {"running": _prof_dir is not None, "log_dir": _prof_dir}
