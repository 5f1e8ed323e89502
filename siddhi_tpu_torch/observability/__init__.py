"""Observability for the port (port of `siddhi_tpu/observability/`): the
statistics layer's host modules and the state observatory.

- log2 latency histograms per query, junction and `<query>:e2e`
  (`histogram.py`), surfaced by `rt.statistics()` and
  `render_prometheus`;
- DETAIL-level per-batch pipeline traces (`tracing.py`), `trace_dump()`
  and a Chrome trace export (`chrome_trace.py`, with a guarded
  `torch.profiler` session);
- the per-(query, phase) budget (`phases.py`, `phase_report()`);
- the state observatory (`stateobs.py`, `state_report()`): occupancy and
  high-water of every sized structure, key hotness, and the window-fill
  probe (kernel K33);
- state bytes per component (`memory.py`, `state_memory()`), health
  probes (`health.py`, `health()`, `healthz(manager)`), time series and
  SLO rules (`timeseries.py`, `slo.py`, `SiddhiManager.start_sampler`);
- the recompile registry (`recompile.py`), which nothing feeds yet.

EXPLAIN (`explain.py`) waits for its design note (ROADMAP A15).  Every hook
sits behind one `enabled` / `active()` check, and every scrape / probe path
reads host-side values only: never a device fetch.
"""
from .histogram import LogHistogram                       # noqa: F401
from .recompile import RECOMPILES, RecompileRegistry      # noqa: F401
from .tracing import (PipelineTracer, active, adopt,      # noqa: F401
                      handoff, span)
from .phases import PHASES, PhaseProfiler, phase_report   # noqa: F401
from .stateobs import (STRUCTURES, KeyHotness,            # noqa: F401
                       StateObservatory, state_report)
from .exposition import render_prometheus                 # noqa: F401
from .memory import component_bytes, total_bytes          # noqa: F401
from .chrome_trace import (chrome_trace, profiler_status,  # noqa: F401
                           start_profiler, stop_profiler)
from .health import app_health, healthz, liveness, readiness  # noqa: F401
from .timeseries import (Series, SeriesStore,                 # noqa: F401
                         TimeSeriesSampler, tenant_account)
from .slo import SLOEngine, SLORule, default_rules            # noqa: F401

__all__ = [
    "LogHistogram", "PipelineTracer", "RECOMPILES", "RecompileRegistry",
    "active", "adopt", "handoff", "span", "render_prometheus",
    "PHASES", "PhaseProfiler", "phase_report",
    "STRUCTURES", "KeyHotness", "StateObservatory", "state_report",
    "component_bytes", "total_bytes",
    "chrome_trace", "start_profiler", "stop_profiler", "profiler_status",
    "app_health", "healthz", "liveness", "readiness",
    "Series", "SeriesStore", "TimeSeriesSampler", "tenant_account",
    "SLOEngine", "SLORule", "default_rules",
]
