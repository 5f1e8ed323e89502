"""Window processors (port of `siddhi_tpu/core/window.py`).

Every event a window admits gets a monotone sequence number `add_seq`; one
`process` call consumes a whole micro-batch and emits `Rows` that carry
their own sequence numbers, valid rows first in seq order, so the selector
recovers the exact per-event order (expired-before-current interleavings
included).

Ported: `NoWindow` (pass-through), `PassAllWindow` (a named window's
reader), `LengthWindow` (`length`),
`TimeWindow` (`time`), `LengthBatchWindow` (`lengthBatch`) and
`TimeBatchWindow` (`timeBatch`) here; `externalTime`,
`externalTimeBatch`, `timeLength`, `delay`, `batch`, `sort`, `cron`,
`session`, `frequent`, `lossyFrequent` and `hopping` in `window_ext.py`;
`expression` and `expressionBatch` in `window_expr.py`.
Their steps are the CUDA kernels under
`kernels/` (`filter_compact`, `length_window`, `time_window`,
`length_batch`, `time_batch`), each with its plain
PyTorch version, which runs on the CPU.  Unlike the
reference, whose output capacity is the window's worst case (B + C rows
for a time window), a step's output here is sized from what the host knows
about the rows that can expire or flush, and only valid rows are defined.

The length and time windows keep their buffers as rings in add_seq order,
so a step reads only the rows that leave and writes only the rows that
arrive;
`convert.py` turns the reference's compacted buffer into the ring and back.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch

from ..exceptions import CompileError
from ..query_api.expression import Constant
from . import event as ev

# "never expired" / "no timer wanted": a quarter of the int64 range, as the
# reference defines them
BIG_SEQ = (2 ** 63 - 1) // 4
NO_WAKEUP = BIG_SEQ

# emission cap meaning "effectively uncapped" (non-partitioned patterns)
UNCAPPED_SENTINEL = 1 << 30


class Rows(NamedTuple):
    """Ordered operator rows flowing between window -> selector -> output."""

    ts: Any     # i64[B]
    kind: Any   # i32[B] CURRENT/EXPIRED/TIMER/RESET
    valid: Any  # bool[B]
    seq: Any    # i64[B] global order
    gslot: Any  # i32[B] group-by slot (-1 none)
    cols: Tuple[Any, ...]


class Buffer(NamedTuple):
    """Columnar window contents in the reference's layout."""

    ts: Any          # i64[C] original event ts
    add_seq: Any     # i64[C]
    expire_seq: Any  # i64[C] BIG_SEQ if still in window
    expire_ts: Any   # i64[C] scheduled wall expiry (time windows) else BIG
    alive: Any       # bool[C]
    gslot: Any       # i32[C]
    cols: Tuple[Any, ...]


def empty_buffer(schema: ev.Schema, capacity: int,
                 device=None) -> Buffer:
    cols = tuple(
        torch.full((capacity,), ev.default_value(t), dtype=d, device=device)
        for t, d in zip(schema.types, schema.dtypes))

    def big():
        return torch.full((capacity,), BIG_SEQ, dtype=torch.int64,
                          device=device)
    return Buffer(
        ts=torch.zeros((capacity,), dtype=torch.int64, device=device),
        add_seq=big(), expire_seq=big(), expire_ts=big(),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        gslot=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        cols=cols)


def _gather_rows(rows: Rows, idx, valid) -> Rows:
    return Rows(ts=rows.ts[idx], kind=rows.kind[idx],
                valid=torch.logical_and(rows.valid[idx], valid),
                seq=rows.seq[idx], gslot=rows.gslot[idx],
                cols=tuple(c[idx] for c in rows.cols))


def sort_rows(rows: Rows) -> Rows:
    """Stable order by (valid desc, seq asc): invalid rows pushed to the
    end."""
    key = torch.where(rows.valid, rows.seq,
                      torch.full_like(rows.seq, BIG_SEQ))
    idx = torch.argsort(key, stable=True)
    return _gather_rows(rows, idx, torch.ones_like(rows.valid))


def concat_rows(a: Rows, b: Rows) -> Rows:
    return Rows(ts=torch.cat([a.ts, b.ts]), kind=torch.cat([a.kind, b.kind]),
                valid=torch.cat([a.valid, b.valid]),
                seq=torch.cat([a.seq, b.seq]),
                gslot=torch.cat([a.gslot, b.gslot]),
                cols=tuple(torch.cat([x, y])
                           for x, y in zip(a.cols, b.cols)))


class WindowOutput(NamedTuple):
    rows: Rows
    # i64[2] tensor [earliest pending expiry (NO_WAKEUP if none), rows
    # the step's expire bound missed (0 when the step was applied)], or
    # None for a window without timers
    next_wakeup: Any


# ---------------------------------------------------------------------------


class WindowProcessor:
    """Base.  `process(state, staged_rows, spec, now, host)` takes the
    batch's rows, the query's filter plan and the host facts of the batch
    (`BatchFacts`), and returns (state', WindowOutput)."""

    name = "?"
    needs_timer = False
    # batch windows that emit RESET rows (epoch flushes)
    emits_reset = False
    # the window takes its arrivals through `_arrivals` (kernel K1), so a
    # fused or merged dispatch may hand it rows K29 filtered already
    # (`kernels/multi_filter.py` `Prefiltered`); `keeps_expired` is the K1
    # flag it passes
    prefilters = True
    keeps_expired = False

    def arrival_seq(self, state):
        """The seq counter `_arrivals` numbers this window's rows from
        (a pass-through window's state), or None."""
        return None

    def __init__(self, schema: ev.Schema, params: List[Constant],
                 batch_capacity: int, capacity_hint: int = 1024):
        self.schema = schema
        self.batch_capacity = batch_capacity

    def init_state(self, device):
        raise NotImplementedError

    def process(self, state, rows: Rows, fspec, now: int, facts):
        raise NotImplementedError

    def current_buffer(self, state):
        """The window's contents for joins and on-demand reads (JAX
        `current_buffer`, `siddhi_tpu/core/window.py:147`): (cols, ts,
        alive), the rows the reference's buffer holds alive in its order,
        gathered on the device; None for a kind whose reference state
        exposes no buffer."""
        return None

    def fill_sources(self, state) -> list:
        """The state's fill for the window-fill probe (kernel K33): one
        `kernels/fill_probe.py` FillSource for each `alive` leaf the JAX
        package's state of this window holds, in its order and with its
        capacity (`siddhi_tpu/observability/stateobs.py`
        `_alive_leaves`); empty where that state holds no window
        Buffer."""
        return []


def table_view(ts, cols, idx):
    """(cols, ts, alive) of the rows at `idx` (a device index tensor), as
    a join reads a table side: a copy, so a later step that moves the
    window's buffers in place leaves it as it is; one dead row when `idx`
    is empty."""
    n = int(idx.numel())
    if n == 0:
        idx = torch.zeros(1, dtype=torch.int64, device=ts.device)
    alive = torch.full((idx.numel(),), n > 0, dtype=torch.bool,
                       device=ts.device)
    return tuple(c[idx] for c in cols), ts[idx], alive


def prefix_view(ts, cols, n: int):
    """`table_view` of the first n rows."""
    return table_view(ts, cols, torch.arange(n, device=ts.device))


class BatchFacts(NamedTuple):
    """What the host knows about a batch before its step: the timestamps of
    its valid CURRENT rows (a superset of the rows its filters keep), its
    capacity, and the staged batch with the mask of those rows.  Window
    steps size their outputs from it."""

    cur_ts: Any        # numpy i64[n]
    capacity: int
    staged: Any = None  # ev.StagedBatch
    cur: Any = None     # numpy bool[capacity]


def _param_int(params, i, default=None):
    if i >= len(params):
        if default is not None:
            return default
        raise CompileError("missing window parameter")
    p = params[i]
    if not isinstance(p, Constant):
        raise CompileError("window parameters must be constants")
    return int(p.value)


def one_key_row(cache: dict, ts):
    """A top-level window kept on a slab of one key: its key rows ([0])
    and selection (one row whose events are the whole batch), cached per
    batch size and device."""
    B, dev = ts.shape[0], ts.device
    if (B, dev) not in cache:
        cache[(B, dev)] = (
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.arange(B, dtype=torch.int32, device=dev).view(1, B))
    return cache[(B, dev)]


def _arrivals(rows: Rows, fspec, now: int, seq=None,
              keep_expired: bool = False, aligned: bool = False):
    from ..kernels.filter_compact import filter_compact
    return filter_compact(fspec, rows.ts, rows.kind, rows.valid, rows.gslot,
                          rows.cols, now, seq, keep_expired, aligned)


class NoWindow(WindowProcessor):
    """Pass-through when the query has no window handler: valid CURRENT
    rows that pass the filters, compacted to the front in input order and
    numbered from the seq counter (kernel K1).  With `index_seq` (a query
    whose selector reads host data keyed by input row: distinctCount's
    pair slots) each row's seq is its input index instead, and the
    counter advances all the same."""

    name = "(none)"
    index_seq = False
    # off on a mesh-sharded windowless group-by: the rows stay aligned to
    # the input (K1's aligned mode), so the shards' outputs merge row by
    # row (JAX `NoWindow.compact`)
    compact = True

    def init_state(self, device):
        return torch.zeros(1, dtype=torch.int64, device=device)

    def arrival_seq(self, state):
        return None if self.index_seq else state

    def process(self, state, rows: Rows, fspec, now: int, facts):
        if self.index_seq:
            out, n = _arrivals(rows, fspec, now)
            state.add_(n)
        else:
            out, _ = _arrivals(rows, fspec, now, seq=state,
                               aligned=not self.compact)
        return state, WindowOutput(out, None)


class PassAllWindow(WindowProcessor):
    """Pass-through for a query reading a named window (JAX
    `siddhi_tpu/core/window.py:199`; reference Window.java:65): the window
    publishes CURRENT and EXPIRED rows, which the query must not window
    again.  Both kinds pass the filters, so signed aggregation stays
    balanced, and come out compacted in order, numbered from the seq
    counter (kernel K1 with its EXPIRED rows kept)."""

    name = "(named-window input)"
    keeps_expired = True

    def init_state(self, device):
        return torch.zeros(1, dtype=torch.int64, device=device)

    def arrival_seq(self, state):
        return state

    def process(self, state, rows: Rows, fspec, now: int, facts):
        out, _ = _arrivals(rows, fspec, now, seq=state, keep_expired=True)
        return state, WindowOutput(out, None)


def slice_fills(state, pending: bool = True) -> list:
    """A TimeBatchState's fill sources: the pending slice's fill (where
    the JAX state keeps a pending buffer), then the previous slice's."""
    from ..kernels import fill_probe as fp
    from ..kernels.time_batch import PEND, PREV
    C = state.b_ts[0].shape[0]
    prev = fp.count(state.meta, PREV, C)
    return [fp.count(state.meta, PEND, C), prev] if pending else [prev]


class LengthWindow(WindowProcessor):
    """Sliding length window (reference: LengthWindowProcessor; JAX
    `siddhi_tpu/core/window.py:228`).

    On each arrival: if full, the oldest entry is emitted as EXPIRED just
    before the CURRENT event; the expired row keeps its original ts.  The
    step is kernel K5 (`kernels/length_window.py`)."""

    name = "length"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.length = _param_int(params, 0)
        if self.length <= 0:
            raise CompileError("length window length must be positive")

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.diff(state.meta, 1, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.length_window import LengthRing
        return LengthRing.empty(self.schema, self.length, device)

    def current_buffer(self, state):
        """The ring's rows in add_seq order, as the reference compacts
        them."""
        return table_view(state.ts, state.cols, state.live()[3])

    def process(self, state, rows: Rows, fspec, now: int, facts):
        from ..kernels.length_window import length_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        return state, WindowOutput(length_window_step(state, arr, n_arr),
                                   None)


class TimeWindow(WindowProcessor):
    """Sliding time window (reference: TimeWindowProcessor.java:86).

    Entries expire `t` ms after arrival; EXPIRED rows carry ts = expiry
    time.  Expiry is driven both by arrivals and by TIMER rows;
    `next_wakeup` reports the earliest pending expiry for the host
    scheduler.  The step is kernel K2 (`kernels/time_window.py`)."""

    name = "time"
    needs_timer = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.time_ms = _param_int(params, 0)
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        return [fp.diff(state.meta, 1, 0, state.ts.shape[0])]

    def init_state(self, device):
        from ..kernels.time_window import TimeRing
        return TimeRing.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        """The ring's rows in add_seq order, as the reference compacts
        them."""
        return table_view(state.ts, state.cols, state.live()[3])

    def process(self, state, rows: Rows, fspec, now: int, facts):
        from ..kernels.time_window import time_window_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = time_window_step(state, arr, n_arr, now, self.time_ms,
                                     facts)
        return state, WindowOutput(out, wake)


class LengthBatchWindow(WindowProcessor):
    """Tumbling length batch (reference: LengthBatchWindowProcessor).

    Arrivals accumulate silently; when `n` have gathered the whole batch is
    emitted as CURRENT, preceded by the previous batch as EXPIRED and a
    RESET row separating them.  The step is kernel K3
    (`kernels/length_batch.py`)."""

    name = "lengthBatch"
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.length = _param_int(params, 0)
        if self.length <= 0:
            raise CompileError("lengthBatch length must be positive")

    def fill_sources(self, state):
        from ..kernels import fill_probe as fp
        n = state.p_ts.shape[0]
        return [fp.count(state.meta, 0, n), fp.count(state.meta, 1, n)]

    def init_state(self, device):
        from ..kernels.length_batch import BatchState
        return BatchState.empty(self.schema, self.length, device)

    def current_buffer(self, state):
        """The pending batch (the reference's first buffer)."""
        return prefix_view(state.p_ts, state.p_cols, int(state.meta[0]))

    def process(self, state, rows: Rows, fspec, now: int, facts):
        from ..kernels.length_batch import length_batch_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out = length_batch_step(state, arr, n_arr, now, facts)
        return state, WindowOutput(out, None)


class TimeBatchWindow(WindowProcessor):
    """Tumbling time batch (reference: TimeBatchWindowProcessor; JAX
    `siddhi_tpu/core/window.py:573`).

    Time is cut into [start + k*t, start + (k+1)*t) slices; at each slice
    boundary the gathered events are emitted as CURRENT, preceded by the
    previous slice as EXPIRED and a RESET row.  Arrivals and TIMER rows
    drive it; the wake is the next boundary.  The step is kernel K12
    (`kernels/time_batch.py`)."""

    name = "timeBatch"
    needs_timer = True
    emits_reset = True

    def __init__(self, schema, params, batch_capacity, capacity_hint=2048):
        super().__init__(schema, params, batch_capacity)
        self.time_ms = _param_int(params, 0)
        if self.time_ms <= 0:
            raise CompileError("timeBatch period must be positive")
        self.capacity = max(capacity_hint, 2 * batch_capacity)

    def fill_sources(self, state):
        return slice_fills(state)

    def init_state(self, device):
        from ..kernels.time_batch import TimeBatchState
        return TimeBatchState.empty(self.schema, self.capacity, device)

    def current_buffer(self, state):
        """The pending slice (the reference's first buffer)."""
        return slice_view(state, pending=True)

    def process(self, state, rows: Rows, fspec, now: int, facts):
        from ..kernels.time_batch import time_batch_step
        arr, n_arr = _arrivals(rows, fspec, now)
        out, wake = time_batch_step(state, arr, n_arr, now, self.time_ms,
                                    facts, exact=not fspec.compiled)
        return state, WindowOutput(out, wake)


def slab_view(slab):
    """`table_view` of a one-key KeyedSlab's (first) block in window
    order: a ring from the key's head, or a block from row 0."""
    from ..kernels.keyed_window import _TWO_BLOCKS
    n = int(slab.count[0])
    idx = torch.arange(n, device=slab.ts.device)
    if slab.mode not in _TWO_BLOCKS:
        idx = torch.remainder(idx + slab.head[0].long(), slab.C)
    return table_view(slab.ts[0], tuple(c[0] for c in slab.cols), idx)


def slice_view(state, pending: bool):
    """`table_view` of a TimeBatchState's pending or previous slice."""
    from ..kernels.time_batch import PARITY, PEND, PREV
    m = state.meta.tolist()
    b = int(m[PARITY]) if pending else 1 - int(m[PARITY])
    return prefix_view(state.b_ts[b], state.b_cols[b],
                       int(m[PEND if pending else PREV]))


# ---------------------------------------------------------------------------

WINDOW_TYPES = {
    "length": LengthWindow,
    "time": TimeWindow,
    "lengthBatch": LengthBatchWindow,
    "timeBatch": TimeBatchWindow,
}


def window_types() -> dict:
    """Every window kind by name (the extension kinds registered)."""
    from . import window_expr, window_ext
    window_ext.register(WINDOW_TYPES)
    window_expr.register(WINDOW_TYPES)
    return WINDOW_TYPES


def create_window(name: str, schema: ev.Schema, params, batch_capacity: int,
                  capacity_hint: int = 2048) -> WindowProcessor:
    window_types()
    if name not in WINDOW_TYPES:
        raise CompileError(f"unknown window type {name!r}; "
                           f"available: {sorted(WINDOW_TYPES)}")
    return WINDOW_TYPES[name](schema, params, batch_capacity,
                              capacity_hint=capacity_hint)
