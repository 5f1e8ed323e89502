"""Extended window processors (port of `siddhi_tpu/core/window_ext.py`).

Ported: `externalTime`, `externalTimeBatch`, `timeLength`, `delay`,
`sort` and `session(gap[, key])` (reference:
CORE/query/processor/stream/window/{ExternalTime,ExternalTimeBatch,
TimeLength,Delay,Sort,Session}WindowProcessor.java).  Their steps are CUDA
kernels, each with its plain PyTorch version, which runs on the CPU:
  * `externalTime`, `timeLength`, `delay`: K16 (`kernels/ext_window.py`);
  * `externalTimeBatch`: K12's external mode (`kernels/time_batch.py`);
  * `sort`: K17 (`kernels/sort_window.py`);
  * `session`: K11's session mode (`kernels/keyed_window.py`), per key for
    `session(gap, key)` (the planner keys the query's window by the
    attribute, as a partition would) and on one key row for
    `session(gap)`.
Parameter lists are accepted and rejected as the reference accepts and
rejects them.  The other kinds (`cron`, `batch`, `frequent`,
`lossyFrequent`, `hopping`, `session(gap, key, allowed.latency)`) raise
`CompileError` naming ROADMAP B12.
"""
from __future__ import annotations

import torch

from ..exceptions import CompileError
from ..query_api.expression import Constant, Variable
from .window import WindowOutput, WindowProcessor, _arrivals, _param_int

UNPORTED = ("cron", "batch", "frequent", "lossyFrequent", "hopping",
            "hoping")


def _param_var_position(params, i, schema, what="window"):
    if i >= len(params) or not isinstance(params[i], Variable):
        raise ValueError(f"{what} parameter {i} must be an attribute name")
    return schema.position(params[i].attribute_name)


class ExternalTimeWindow(WindowProcessor):
    """Sliding window over an event-time attribute: a row expires when an
    arrival's event time passes its own + t; no timer (kernel K16)."""

    name = "externalTime"

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.ts_pos = _param_var_position(params, 0, schema, "externalTime")
        self.time_ms = _param_int(params, 1)
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def init_state(self, device):
        from ..kernels.ext_window import MODE_EXT, ExtState
        return ExtState.empty(MODE_EXT, self.schema, self.capacity, device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.ext_window import ext_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = ext_window_step(state, arr, n_arr, now, self.time_ms,
                                    ets=arr.cols[self.ts_pos])
        return state, WindowOutput(out, wake)


class ExternalTimeBatchWindow(WindowProcessor):
    """Tumbling window over an event-time attribute: the slices
    [start + k*t, start + (k+1)*t) of the attribute, flushed when an
    arrival's event time crosses the slice's end (kernel K12, external
    mode)."""

    name = "externalTimeBatch"
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.ts_pos = _param_var_position(params, 0, schema,
                                          "externalTimeBatch")
        self.time_ms = _param_int(params, 1)
        self.start = _param_int(params, 2, default=-1) if len(params) > 2 \
            else -1
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def init_state(self, device):
        from ..kernels.time_batch import START, TimeBatchState
        st = TimeBatchState.empty(self.schema, self.capacity, device)
        st.meta[START] = self.start
        st.h_start = self.start
        return st

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.time_batch import time_batch_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = time_batch_step(
            state, arr, n_arr, now, self.time_ms, facts,
            exact=not fspec.compiled, ets=arr.cols[self.ts_pos],
            cur_ets=facts.staged.cols[self.ts_pos][facts.cur]
            .astype("int64"))
        return state, WindowOutput(out, wake)


class TimeLengthWindow(WindowProcessor):
    """Sliding window bounded by time and count: a row leaves t ms after
    it arrived, or when n newer rows have arrived (kernel K16)."""

    name = "timeLength"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.time_ms = _param_int(params, 0)
        self.length = _param_int(params, 1)
        self.capacity = self.length

    def init_state(self, device):
        from ..kernels.ext_window import MODE_TLEN, ExtState
        return ExtState.empty(MODE_TLEN, self.schema, self.capacity, device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.ext_window import ext_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = ext_window_step(state, arr, n_arr, now, self.time_ms,
                                    length=self.length)
        return state, WindowOutput(out, wake)


class DelayWindow(WindowProcessor):
    """Rows are held t ms and released as CURRENT (kernel K16)."""

    name = "delay"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.time_ms = _param_int(params, 0)
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def init_state(self, device):
        from ..kernels.ext_window import MODE_DELAY, ExtState
        return ExtState.empty(MODE_DELAY, self.schema, self.capacity,
                              device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.ext_window import ext_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = ext_window_step(state, arr, n_arr, now, self.time_ms)
        return state, WindowOutput(out, wake)


class SortWindow(WindowProcessor):
    """Keeps the n rows with the least key (the greatest under 'desc');
    the others leave as EXPIRED rows (kernel K17)."""

    name = "sort"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.length = _param_int(params, 0)
        self.key_pos = _param_var_position(params, 1, schema, "sort")
        self.descending = False
        if len(params) > 2:
            p = params[2]
            if isinstance(p, Constant) and str(p.value).lower() == "desc":
                self.descending = True
        if len(params) > 3:
            raise ValueError("sort window supports a single sort key in "
                             "this build")
        self.capacity = self.length

    def init_state(self, device):
        from ..kernels.sort_window import SortState
        return SortState.empty(self.schema, self.capacity, device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.sort_window import sort_window_step
        arr, n_arr = _arrivals(rows, fspec, now)     # seq: input positions
        out = sort_window_step(state, arr, n_arr, self.length, self.key_pos,
                               self.descending, facts.capacity)
        return state, WindowOutput(out, None)


class SessionWindow(WindowProcessor):
    """Sessions: rows gather while arrivals come less than `gap` apart and
    expire together when the gap passes (kernel K11, session mode).
    `session(gap, key)` keeps a session per key value: the planner keys
    the window by `session_key_pos`."""

    name = "session"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.gap_ms = _param_int(params, 0)
        if len(params) > 2:
            raise CompileError(
                "window 'session(gap, key, allowed.latency)' is not yet "
                "ported (ROADMAP B12)")
        self.session_key_pos = None
        if len(params) == 2:
            self.session_key_pos = _param_var_position(params, 1, schema,
                                                       "session")
        self.capacity = max(capacity_hint, 2 * batch_capacity)
        self._sel = {}

    def init_state(self, device):
        from ..kernels.keyed_window import MODE_SESSION, KeyedSlab
        return KeyedSlab.empty(MODE_SESSION, self.schema.types, 1,
                               self.capacity, device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.keyed_window import keyed_window_step
        B, dev = rows.ts.shape[0], rows.ts.device
        if (B, dev) not in self._sel:
            # one key row whose events are the whole batch
            self._sel[(B, dev)] = (
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.arange(B, dtype=torch.int32, device=dev).view(1, B))
        key_idx, sel = self._sel[(B, dev)]
        out, wake = keyed_window_step(state, fspec, rows.ts, rows.kind,
                                      rows.valid, rows.gslot, rows.cols,
                                      key_idx, sel, now, self.gap_ms)
        return state, WindowOutput(out, wake)


def register(window_types: dict) -> None:
    for cls in (ExternalTimeWindow, ExternalTimeBatchWindow,
                TimeLengthWindow, DelayWindow, SortWindow, SessionWindow):
        window_types[cls.name] = cls
