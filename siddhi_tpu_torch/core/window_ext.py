"""Extended window processors (port of `siddhi_tpu/core/window_ext.py`).

Ported: `externalTime`, `externalTimeBatch`, `timeLength`, `delay`,
`batch`, `sort`, `cron`, `session`, `frequent`, `lossyFrequent` and
`hopping` (also spelt `hoping`) (reference:
CORE/query/processor/stream/window/{ExternalTime,ExternalTimeBatch,
TimeLength,Delay,Batch,Sort,Cron,Session,Frequent,LossyFrequent}
WindowProcessor.java and the JAX package's hopping window).  Their steps
are CUDA kernels, each with its plain PyTorch version, which runs on the
CPU:
  * `externalTime`, `timeLength`, `delay`: K16 (`kernels/ext_window.py`);
  * `externalTimeBatch`, `batch`, `cron`: K12's external, chunk and cron
    modes (`kernels/time_batch.py`);
  * `sort`: K17 (`kernels/sort_window.py`);
  * `hopping`: K18 (`kernels/hop_window.py`);
  * `frequent`, `lossyFrequent`: K19 (`kernels/frequent.py`);
  * `session`: K11's session mode (`kernels/keyed_window.py`), per key for
    `session(gap, key)` (the planner keys the query's window by the
    attribute, as a partition would) and on one key row for
    `session(gap)`; `session(gap, key, allowed.latency)` is K11's latency
    mode, always per key.
Parameter lists are accepted and rejected as the reference accepts and
rejects them.  Two reference behaviours the port keeps: `batch(length)`
ignores its length (each send's chunk is the window), and `lossyFrequent`
is Misra-Gries over int(1 / support) counters that drops its error
parameter.  One it does not: the reference keeps at most `batch_capacity`
rows of a chunk and drops the rest silently; the port's chunk buffer
grows to the largest chunk.
"""
from __future__ import annotations

import numpy as np

from ..query_api.expression import Constant, Variable
from . import event as ev
from .window import (WindowOutput, WindowProcessor, _arrivals, _param_int,
                     one_key_row, prefix_view, slab_view, slice_fills,
                     slice_view)


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

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.meta, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.ext_window import MODE_EXT, ExtState
        return ExtState.empty(MODE_EXT, self.schema, self.capacity, device)

    def current_buffer(self, state):
        return prefix_view(state.ts, state.cols, int(state.meta[0]))

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

    def fill_sources(self, state):
        return slice_fills(state)

    def init_state(self, device):
        from ..kernels.time_batch import START, TimeBatchState
        st = TimeBatchState.empty(self.schema, self.capacity, device)
        st.meta[START] = self.start
        st.h_start = self.start
        return st

    def current_buffer(self, state):
        """The pending slice (the reference's first buffer)."""
        return slice_view(state, pending=True)

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

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.meta, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.ext_window import MODE_TLEN, ExtState
        return ExtState.empty(MODE_TLEN, self.schema, self.capacity, device)

    def current_buffer(self, state):
        return prefix_view(state.ts, state.cols, int(state.meta[0]))

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

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.meta, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.ext_window import MODE_DELAY, ExtState
        return ExtState.empty(MODE_DELAY, self.schema, self.capacity,
                              device)

    def current_buffer(self, state):
        return prefix_view(state.ts, state.cols, int(state.meta[0]))

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

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.meta, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.sort_window import SortState
        return SortState.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        return prefix_view(state.ts, state.cols, int(state.meta[0]))

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.sort_window import sort_window_step
        arr, n_arr = _arrivals(rows, fspec, now)     # seq: input positions
        out = sort_window_step(state, arr, n_arr, self.length, self.key_pos,
                               self.descending, facts.capacity)
        return state, WindowOutput(out, None)


class ChunkBatchWindow(WindowProcessor):
    """`batch()`: each send's chunk is the window; the previous chunk is
    replayed as EXPIRED ahead of the new one (kernel K12, chunk mode)."""

    name = "batch"
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.capacity = batch_capacity

    def fill_sources(self, state):
        return slice_fills(state, pending=False)

    def init_state(self, device):
        from ..kernels.time_batch import TimeBatchState
        return TimeBatchState.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        """The previous chunk (the reference's buffer)."""
        return slice_view(state, pending=False)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.time_batch import MODE_CHUNK, time_batch_step
        n = int(facts.cur_ts.shape[0])
        if n > state.C:
            # a chunk above the buffers: they grow to hold it
            state.grow(1 << (n - 1).bit_length())
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = time_batch_step(state, arr, n_arr, now, 0, facts,
                                    exact=not fspec.compiled,
                                    mode=MODE_CHUNK)
        return state, WindowOutput(out, wake)


class CronWindow(WindowProcessor):
    """Rows gather and flush at the cron expression's fire times (kernel
    K12, cron mode).  The host computes the fire times
    (`host_next_wakeup`, the runtime's wake after every step) and a step
    flushes when its batch holds a TIMER row."""

    name = "cron"
    needs_timer = True
    host_scheduled = True
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        if not params or not isinstance(params[0], Constant):
            raise ValueError("cron window needs a cron expression string")
        from ..utils.cron import CronExpression
        self.cron = CronExpression(str(params[0].value))
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def host_next_wakeup(self, now: int) -> int:
        return self.cron.next_fire(now)

    def fill_sources(self, state):
        return slice_fills(state)

    def init_state(self, device):
        from ..kernels.time_batch import TimeBatchState
        return TimeBatchState.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        """The pending slice (the reference's first buffer)."""
        return slice_view(state, pending=True)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.time_batch import MODE_CRON, time_batch_step
        st = facts.staged
        flush = bool(np.any(st.valid & (st.kind == ev.TIMER)))
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = time_batch_step(state, arr, n_arr, now, 0, facts,
                                    exact=not fspec.compiled,
                                    mode=MODE_CRON, flush=flush)
        return state, WindowOutput(out, wake)


class HoppingWindow(WindowProcessor):
    """`hopping(window.time, hop.time)`: every hop the rows of the trailing
    window come out as one batch, after the previous hop's batch as
    EXPIRED and a RESET row (kernel K18)."""

    name = "hopping"
    needs_timer = True
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.win_ms = _param_int(params, 0)
        self.hop_ms = _param_int(params, 1, default=self.win_ms)
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.meta, 0, state.b_ts[0].shape[0])]

    def init_state(self, device):
        from ..kernels.hop_window import HopState
        return HopState.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        """The kept candidates, in candidate order."""
        n, _, _, cur = (int(x) for x in state.meta[:4].tolist())
        return prefix_view(state.b_ts[cur], state.b_cols[cur], n)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.hop_window import hop_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = hop_window_step(state, arr, n_arr, now, self.win_ms,
                                    self.hop_ms)
        return state, WindowOutput(out, wake)


class FrequentWindow(WindowProcessor):
    """Misra-Gries over n counters: the latest event of each of up to n
    keys (kernel K19)."""

    name = "frequent"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.n = _param_int(params, 0)
        if len(params) > 1:
            self.key_positions = [
                _param_var_position(params, i, schema, "frequent")
                for i in range(1, len(params))]
        else:
            self.key_positions = list(range(len(schema.names)))

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.mask(state.counts)]

    def init_state(self, device):
        from ..kernels.frequent import FreqState
        return FreqState.empty(self.schema, self.n, len(self.key_positions),
                               device)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.frequent import frequent_step
        arr, n_arr = _arrivals(rows, fspec, now)  # seq: input positions
        return state, WindowOutput(
            frequent_step(state, arr, n_arr, self.key_positions), None)


class LossyFrequentWindow(FrequentWindow):
    """`lossyFrequent(support[, error][, attrs])`: the Misra-Gries window
    over n = max(int(1 / support), 1) counters; float parameters after the
    support (the reference's error bound) are dropped, as the reference
    does."""

    name = "lossyFrequent"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        if not params or not isinstance(params[0], Constant):
            raise ValueError("lossyFrequent needs a support fraction")
        support = float(params[0].value)
        if not (0.0 < support < 1.0):
            raise ValueError("support must be in (0, 1)")
        n = max(int(1.0 / support), 1)
        rest = [p for p in params[1:]
                if not (isinstance(p, Constant)
                        and isinstance(p.value, float))]
        super().__init__(schema, [Constant(n, "INT")] + rest,
                         batch_capacity, capacity_hint)


class SessionWindow(WindowProcessor):
    """Sessions: rows gather while arrivals come less than `gap` apart and
    expire together when the gap passes (kernel K11, session mode).
    `session(gap, key)` keeps a session per key value: the planner keys
    the window by `session_key_pos`."""

    # its kernel evaluates the filters itself
    prefilters = False
    name = "session"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.gap_ms = _param_int(params, 0)
        self.session_key_pos = None
        if len(params) == 2:
            self.session_key_pos = _param_var_position(params, 1, schema,
                                                       "session")
        self.capacity = max(capacity_hint, 2 * batch_capacity)
        self._sel = {}

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.count(state.count, 0, state.C)]

    def init_state(self, device):
        from ..kernels.keyed_window import MODE_SESSION, KeyedSlab
        return KeyedSlab.empty(MODE_SESSION, self.schema.types, 1,
                               self.capacity, device)

    def current_buffer(self, state):
        return slab_view(state)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.keyed_window import keyed_window_step
        key_idx, sel = one_key_row(self._sel, rows.ts)
        out, wake = keyed_window_step(state, fspec, rows.ts, rows.kind,
                                      rows.valid, rows.gslot, rows.cols,
                                      key_idx, sel, now, self.gap_ms)
        return state, WindowOutput(out, wake)


class SessionLatencyWindow(WindowProcessor):
    """`session(gap, key, allowed.latency)`: per key a current session and
    one previous session that lingers `allowed.latency` past its gap, so
    late arrivals can still join or merge them (kernel K11, latency mode;
    always per key: the planner keys the window by `session_key_pos`)."""

    # its kernel evaluates the filters itself
    prefilters = False
    name = "session"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.gap_ms = _param_int(params, 0)
        self.session_key_pos = _param_var_position(
            params, 1, schema, "session") \
            if not isinstance(params[1], Constant) else None
        if self.session_key_pos is None:
            raise ValueError("session's 2nd parameter must name the "
                             "session key attribute")
        self.latency_ms = _param_int(params, 2)
        if self.latency_ms > self.gap_ms:
            # reference: validateAllowedLatency
            raise ValueError(
                "session window's allowed.latency must not exceed the "
                "session gap")
        self.capacity = max(capacity_hint, 2 * batch_capacity)


def _session_factory(schema, params, batch_capacity, capacity_hint=2048):
    """session(gap) and session(gap, key): `SessionWindow`;
    session(gap, key, allowed.latency): `SessionLatencyWindow` (reference:
    SessionWindowProcessor.java:86-88)."""
    cls = SessionLatencyWindow if len(params) >= 3 else SessionWindow
    return cls(schema, params, batch_capacity, capacity_hint=capacity_hint)


def register(window_types: dict) -> None:
    for cls in (ExternalTimeWindow, ExternalTimeBatchWindow,
                TimeLengthWindow, DelayWindow, ChunkBatchWindow, SortWindow,
                CronWindow, FrequentWindow, LossyFrequentWindow,
                HoppingWindow):
        window_types[cls.name] = cls
    window_types["session"] = _session_factory
    window_types["hoping"] = HoppingWindow   # the reference's spelling
