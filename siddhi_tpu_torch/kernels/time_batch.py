"""State, wrapper and plain version of the `time_batch` CUDA kernel (K12).

The kernel (`siddhi_tpu_torch/csrc/time_batch.cu`) replaces the JAX
package's `TimeBatchWindow.process` (`siddhi_tpu/core/window.py:602`), a
tumbling window over the slices [start + k*t, start + (k+1)*t).  A step
whose `now` has passed at least one boundary flushes, emitting, numbered
from the step's `seq0`:
  * the previous slice as EXPIRED rows, seq `seq0 + rank`;
  * one RESET row, seq `seq0 + C`, ts `now`, group slot -1, default
    column values;
  * the pending slice and the arrivals with ts < boundary as CURRENT
    rows, seq `seq0 + C + 1 + rank`;
and advances the seq counter by `2C + B + 2` (B the batch capacity).
Several boundaries passed in one gap collapse into one flush.  Arrivals
at or past the boundary start the new pending slice; in a step that does
not flush they are dropped (both as in the reference).  The wake is
`start + t`.

State (`TimeBatchState`): two buffers of C rows (ts, group slot,
columns) and `meta` = [start (-1 unset), seq, pending fill, previous
fill, which buffer is pending, rows missed] on the device.  A slice that
would overflow C keeps the rows that fit and counts the rest in the
step's `missed`, on which the runtime raises (the reference drops them
silently).  The host keeps a mirror of the start and of upper bounds on
the fills (`h_start`, `h_pend`, `h_prev`), exact when the query has no
filter before the window, from which each step's output is sized without
a sync; with such a filter the mirror's start is fetched once after the
first step that can set it.  Output rows past the step's emitted ones
are invalid and zero.

External mode (`ets` given) replaces `ExternalTimeBatchWindow.process`
(`siddhi_tpu/core/window_ext.py:178`), externalTimeBatch(attr, t): the
slices are cut by the arrivals' event times `ets`, not by `now`.  The
start is the first arrival's event time; a step flushes when its latest
event time has passed a boundary (a step without arrivals never does);
arrivals with event time < boundary join the flushed slice; the RESET row
carries `now`; there is no timer (the wake is NO_WAKEUP).  The host sizes
an external step from the state's start and fills, read from the device
once a step, and the event times of the batch's valid CURRENT rows.

Chunk mode replaces `ChunkBatchWindow.process`
(`siddhi_tpu/core/window_ext.py:427`), `batch()`: the window is the last
chunk a send delivered.  A step with an arrival flushes: the previous
chunk as EXPIRED rows (seq `seq0 + rank`), a RESET row (seq `seq0 + qf`,
qf the previous chunk's rows), the arrivals as CURRENT rows (seq
`seq0 + qf + 1 + rank`); the arrivals become the previous chunk and the
counter advances by `qf + 1 + arrivals`.  A step without one (a TIMER
step, or a send its filters emptied) emits nothing and keeps the chunk.
There is no pending slice, no start and no timer.

Cron mode replaces `CronWindow.process` (`:579`): the host schedules the
fire times (`CronWindow.host_next_wakeup`) and a step flushes when its
batch holds a valid TIMER row (`flush`, a host fact).  The flush emits the
previous batch as EXPIRED, the RESET row and the pending rows as CURRENT,
numbered as timeBatch's; unlike timeBatch's, the step's own arrivals are
not in the flush: they start the new pending batch.  The counter advances
by `2C + 1`.  Without a flush the arrivals join the pending batch.  Rows
past C are counted in `missed` (the runtime raises; the reference drops
them).  The wake is NO_WAKEUP (the host schedules cron).

`time_batch_step` is what `TimeBatchWindow.process`,
`ExternalTimeBatchWindow.process`, `ChunkBatchWindow.process` and
`CronWindow.process` call: CPU tensors run `plain`, CUDA tensors launch
the kernel.  `launches` / `plain_calls` count them, `mode_launches` the
launches by mode (MODE_TIME for timeBatch, MODE_EXT for
externalTimeBatch, MODE_CHUNK for batch, MODE_CRON for cron);
`reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import event as ev
from ..core.window import BIG_SEQ, NO_WAKEUP, Rows, empty_buffer
from . import _nvcc

launches = 0
plain_calls = 0
mode_launches = [0, 0, 0, 0]

MODE_TIME, MODE_EXT, MODE_CHUNK, MODE_CRON = range(4)

MAX_COLS = 16
BLOCK = 256
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

# meta words
START, SEQ, PEND, PREV, PARITY, MISSED = range(6)


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0, 0, 0]


class TimeBatchState:
    """The pending and previous slices of a timeBatch window, and the
    host's mirror of its start and fills."""

    def __init__(self, C, b_ts, b_gslot, b_cols, meta, defaults,
                 h_start=-1, h_pend=0, h_prev=0):
        self.C = C
        self.b_ts, self.b_gslot = list(b_ts), list(b_gslot)
        self.b_cols = [tuple(c) for c in b_cols]
        self.meta = meta
        self.defaults = defaults        # RESET rows' column values
        self.h_start, self.h_pend, self.h_prev = h_start, h_pend, h_prev

    @classmethod
    def empty(cls, schema: ev.Schema, C: int, device) -> "TimeBatchState":
        a, b = (empty_buffer(schema, C, device) for _ in range(2))
        defaults = tuple(ev.default_value(t) for t in schema.types)
        meta = torch.zeros(6, dtype=torch.int64, device=device)
        meta[START] = -1
        return cls(C, (a.ts, b.ts), (a.gslot, b.gslot), (a.cols, b.cols),
                   meta, defaults)

    def clone(self) -> "TimeBatchState":
        return TimeBatchState(
            self.C, [x.clone() for x in self.b_ts],
            [x.clone() for x in self.b_gslot],
            [tuple(c.clone() for c in cols) for cols in self.b_cols],
            self.meta.clone(), self.defaults, self.h_start, self.h_pend,
            self.h_prev)

    def grow(self, C: int) -> None:
        """Make both buffers C rows long, their rows kept (chunk mode: a
        chunk larger than the buffers)."""
        def g(x):
            y = torch.zeros(C, dtype=x.dtype, device=x.device)
            y[:self.C] = x
            return y
        self.b_ts = [g(x) for x in self.b_ts]
        self.b_gslot = [g(x) for x in self.b_gslot]
        self.b_cols = [tuple(g(c) for c in cols) for cols in self.b_cols]
        self.C = C

    def slices(self):
        """((ts, gslot, cols) of the pending slice, of the previous one),
        each cut to its fill (host read)."""
        m = self.meta.tolist()
        p = int(m[PARITY])
        out = []
        for buf, n in ((p, m[PEND]), (1 - p, m[PREV])):
            n = int(n)
            out.append((self.b_ts[buf][:n], self.b_gslot[buf][:n],
                        tuple(c[:n] for c in self.b_cols[buf])))
        return out


def out_capacity(st: TimeBatchState, cur_ts: np.ndarray, now: int, t: int,
                 exact: bool) -> int:
    """Rows the step can emit, from the host mirror and the timestamps of
    the batch's valid CURRENT rows (a superset of its arrivals; the same
    set when `exact`); updates the mirror."""
    C = st.C
    if st.h_start is None:          # set by a filtered step: fetch it once
        st.h_start = int(st.meta[START])
    n = int(cur_ts.shape[0])
    start = st.h_start
    if start < 0 and n == 0:
        return 0
    if start < 0 and not exact:
        # the first arrival that passes the filters is not known here
        first = int(cur_ts.min())
        can = max(now - first, 0) // t > 0
        st.h_prev = min(C, max(st.h_prev, st.h_pend + n)) if can \
            else st.h_prev
        st.h_pend = min(C, st.h_pend + n)
        st.h_start = None
        return 1 + n if can else 0
    if start < 0:
        start = int(cur_ts.min())
    nflush = max(now - start, 0) // t
    boundary = start + (nflush if nflush else 1) * t
    n_in = int(np.count_nonzero(cur_ts < boundary))
    if not nflush:
        st.h_pend = min(C, st.h_pend + n_in)
        st.h_start = start
        return 0
    cap = st.h_prev + 1 + st.h_pend + n_in
    st.h_prev = min(C, st.h_pend + n_in)
    st.h_pend = min(C, n - n_in)
    st.h_start = start + nflush * t
    return cap


def out_capacity_ext(st: TimeBatchState, cur_ets: np.ndarray, t: int,
                     exact: bool) -> int:
    """Rows an external step can emit, from the state (one device read)
    and the event times of the batch's valid CURRENT rows (a superset of
    its arrivals; the same set when `exact`)."""
    start, _, pend, prev = (int(x) for x in st.meta[:4].tolist())
    n = int(cur_ets.shape[0])
    if n == 0:
        return 0
    if start < 0:
        start = int(cur_ets.min())
    nflush = max(int(cur_ets.max()) - start, 0) // t
    if not nflush:
        return 0
    boundary = start + nflush * t
    n_in = int(np.count_nonzero(cur_ets < boundary)) if exact else n
    return prev + 1 + pend + n_in


def out_capacity_chunk(st: TimeBatchState, n: int, exact: bool) -> int:
    """Rows a chunk step can emit, from the host mirror and the number n
    of the batch's valid CURRENT rows (its arrivals when `exact`, else an
    upper bound); updates the mirror."""
    if n == 0:
        return 0
    cap = st.h_prev + 1 + n
    st.h_prev = min(n, st.C) if exact else max(st.h_prev, min(n, st.C))
    return cap


def out_capacity_cron(st: TimeBatchState, n: int, flush: bool) -> int:
    """Rows a cron step can emit (n as for `out_capacity_chunk`);
    updates the mirror."""
    if not flush:
        st.h_pend = min(st.C, st.h_pend + n)
        return 0
    cap = st.h_prev + 1 + st.h_pend
    st.h_prev, st.h_pend = st.h_pend, min(n, st.C)
    return cap


def time_batch_step(st: TimeBatchState, arr: Rows, n_arr, now: int, t: int,
                    facts, exact: bool, ets=None, cur_ets=None,
                    mode: int = None, flush: bool = False):
    """One step: `arr` are the batch's arrivals compacted to the front,
    `n_arr` their count (i64[1]); in external mode `ets` are the
    arrivals' event times (int64) and `cur_ets` those of the batch's valid
    CURRENT rows on the host; `mode` MODE_CHUNK or MODE_CRON for those
    windows (cron: `flush` when the batch holds a valid TIMER row).
    Updates `st` in place; returns (rows, i64[2] [wake, rows missed])."""
    if mode is None:
        mode = MODE_TIME if ets is None else MODE_EXT
    if mode == MODE_EXT:
        cap_out = out_capacity_ext(st, cur_ets, t, exact)
    elif mode == MODE_CHUNK:
        cap_out = out_capacity_chunk(st, int(facts.cur_ts.shape[0]), exact)
    elif mode == MODE_CRON:
        cap_out = out_capacity_cron(st, int(facts.cur_ts.shape[0]), flush)
    else:
        cap_out = out_capacity(st, facts.cur_ts, now, t, exact)
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, now, t, cap_out, ets, mode, flush)
    return plain(st, arr, n_arr, now, t, cap_out, ets, mode, flush)


def plain(st: TimeBatchState, arr: Rows, n_arr, now: int, t: int,
          cap_out: int, ets=None, mode: int = None, flush: bool = False):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    if mode is None:
        mode = MODE_TIME if ets is None else MODE_EXT
    dev = st.meta.device
    C, B = st.C, int(arr.ts.shape[0])
    start0, seq0, pf, qf, par, _ = (int(x) for x in st.meta.tolist())
    P, Q = par, 1 - par
    na = int(n_arr)
    start = nflush = 0
    if mode in (MODE_TIME, MODE_EXT):
        # what slices the time: the arrivals' ts, or their event times
        a_key = (ets if ets is not None else arr.ts)[:na].to(torch.int64)
        first = int(a_key.min()) if na else BIG_SEQ
        start = start0 if start0 >= 0 else first
        if ets is not None:
            nflush = max(int(a_key.max()) - start, 0) // t if na else 0
        elif start0 >= 0:
            nflush = max(now - start0, 0) // t
        else:
            nflush = max(now - first, 0) // t if na else 0
        flush = nflush > 0
        boundary = start + (nflush if flush else 1) * t
        f = a_key < boundary
    else:
        # chunk: every arrival is in the flushed chunk; cron: none is in
        # the flushed batch, all join the pending one
        flush = na > 0 if mode == MODE_CHUNK else bool(flush)
        f = torch.full((na,), mode == MODE_CHUNK or not flush,
                       dtype=torch.bool, device=dev)
    n_in = int(f.sum())
    i_in = torch.nonzero(f).flatten()
    i_next = torch.nonzero(~f).flatten()
    # the RESET row's seq offset (the CURRENT rows follow it)
    rs = qf if mode == MODE_CHUNK else C

    # output: previous slice, RESET, pending slice, arrivals in the slice
    n_out = qf + 1 + pf + n_in if flush else 0

    def column(q_col, p_col, a_col, reset_val, dtype):
        o = torch.zeros(cap_out, dtype=dtype, device=dev)
        if n_out:
            o[:qf] = q_col[:qf]
            o[qf] = reset_val
            o[qf + 1:qf + 1 + pf] = p_col[:pf]
            o[qf + 1 + pf:n_out] = a_col[i_in][:max(cap_out - qf - 1 - pf,
                                                     0)]
        return o

    kind = torch.zeros(cap_out, dtype=torch.int32, device=dev)
    seq = torch.zeros(cap_out, dtype=torch.int64, device=dev)
    valid = torch.zeros(cap_out, dtype=torch.bool, device=dev)
    if n_out:
        kind[:qf] = ev.EXPIRED
        kind[qf] = ev.RESET
        kind[qf + 1:n_out] = ev.CURRENT
        seq[:qf] = seq0 + torch.arange(qf, device=dev)
        seq[qf] = seq0 + rs
        seq[qf + 1:n_out] = seq0 + rs + 1 + torch.arange(
            n_out - qf - 1, device=dev)
        valid[:n_out] = True
    out = Rows(
        ts=column(st.b_ts[Q], st.b_ts[P], arr.ts, now, torch.int64),
        kind=kind, valid=valid, seq=seq,
        gslot=column(st.b_gslot[Q], st.b_gslot[P], arr.gslot, -1,
                     torch.int32),
        cols=tuple(column(qc, pc, ac, dv, pc.dtype) for qc, pc, ac, dv in
                   zip(st.b_cols[Q], st.b_cols[P], arr.cols, st.defaults)))

    # the pending buffer takes the arrivals in the slice; on a flush the
    # others start the new pending slice in the previous buffer
    def put(buf, lo, idx):
        k = max(min(C - lo, idx.shape[0]), 0)
        st.b_ts[buf][lo:lo + k] = arr.ts[idx[:k]]
        st.b_gslot[buf][lo:lo + k] = arr.gslot[idx[:k]]
        for bc, ac in zip(st.b_cols[buf], arr.cols):
            bc[lo:lo + k] = ac[idx[:k]]

    put(P, pf, i_in)
    fill = pf + n_in
    missed = max(fill - C, 0)
    meta = [start0, seq0, min(fill, C), qf, par]
    if flush:
        put(Q, 0, i_next)
        missed += max(na - n_in - C, 0)
        adv = {MODE_CHUNK: qf + 1 + na, MODE_CRON: 2 * C + 1}.get(
            mode, 2 * C + B + 2)
        meta = [start + nflush * t, seq0 + adv,
                min(na - n_in, C), min(fill, C), 1 - par]
    elif start0 >= 0 or na:
        meta[START] = start
    else:
        meta[START] = -1
    if mode in (MODE_CHUNK, MODE_CRON):
        meta[START] = -1
    nstart = meta[START]
    st.meta.copy_(torch.tensor(meta + [int(st.meta[MISSED]) + missed],
                               dtype=torch.int64))
    wake = torch.tensor([nstart + t if nstart >= 0 and mode == MODE_TIME
                         else NO_WAKEUP, missed],
                        dtype=torch.int64, device=dev)
    return out, wake


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class TimeBatchPlan(ctypes.Structure):
    """Mirrors `struct TimeBatchPlan` in csrc/time_batch.cu."""
    _fields_ = (
        [(n, _L) for n in ("C", "t", "now", "B", "cap_out")] +
        [("ncols", _I), ("mode", _I), ("flush", _I), ("pad", _I),
         ("col_bytes", _I * MAX_COLS),
         ("reset_val", _L * MAX_COLS),
         ("b_ts", _P * 2), ("b_gslot", _P * 2),
         ("b_col", (_P * MAX_COLS) * 2),
         ("meta", _P), ("a_ts", _P), ("a_ets", _P), ("a_gslot", _P),
         ("a_col", _P * MAX_COLS), ("n_arr", _P), ("flags", _P),
         ("block_sums", _P), ("step", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("wake", _P)])


def launch(st: TimeBatchState, arr: Rows, n_arr, now: int, t: int,
           cap_out: int, ets=None, mode: int = None, flush: bool = False):
    global launches
    if mode is None:
        mode = MODE_TIME if ets is None else MODE_EXT
    dev = st.meta.device
    cols0 = st.b_cols[0]
    if len(cols0) > MAX_COLS or len(arr.cols) != len(cols0):
        raise ValueError("time_batch: column count")
    if arr.ts.dtype != torch.int64 or arr.gslot.dtype != torch.int32 or \
            arr.ts.device != dev or n_arr.dtype != torch.int64:
        raise ValueError("time_batch: arrival rows dtype or device")
    B = int(arr.ts.shape[0])
    pl = TimeBatchPlan()
    pl.C, pl.t, pl.now, pl.B, pl.cap_out = st.C, int(t), int(now), B, cap_out
    pl.ncols, pl.mode, pl.flush = len(cols0), mode, int(bool(flush))
    if mode == MODE_EXT:
        ets = ets.to(torch.int64).contiguous()
        if ets.device != dev or ets.shape[0] != B:
            raise ValueError("time_batch: event-time column")
        pl.a_ets = ets.data_ptr()

    def e(d, n=max(cap_out, 1)):
        return torch.empty(n, dtype=d, device=dev)
    out_ts, out_kind, out_valid = e(torch.int64), e(torch.int32), \
        e(torch.bool)
    out_seq, out_gslot = e(torch.int64), e(torch.int32)
    out_cols = [e(c.dtype) for c in cols0]
    for j, (ac, dv) in enumerate(zip(arr.cols, st.defaults)):
        if ac.dtype != cols0[j].dtype or not ac.is_contiguous():
            raise ValueError("time_batch: arrival column dtype")
        pl.col_bytes[j] = cols0[j].element_size()
        pl.reset_val[j] = _nvcc.slot_bits(dv, cols0[j].dtype)
        pl.a_col[j], pl.out_col[j] = ac.data_ptr(), out_cols[j].data_ptr()
        for b in range(2):
            pl.b_col[b][j] = st.b_cols[b][j].data_ptr()
    for b in range(2):
        pl.b_ts[b], pl.b_gslot[b] = st.b_ts[b].data_ptr(), \
            st.b_gslot[b].data_ptr()
    nb = (B + BLOCK - 1) // BLOCK
    flags = e(torch.uint8, max(B, 1))
    block_sums = e(torch.int64, nb + 1)
    step = e(torch.int64, 4)
    wake = e(torch.int64, 2)
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    pl.flags, pl.block_sums, pl.step = flags.data_ptr(), \
        block_sums.data_ptr(), step.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    pl.out_seq, pl.out_gslot = out_seq.data_ptr(), out_gslot.data_ptr()
    pl.wake = wake.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("time_batch", "siddhi_time_batch",
                      "siddhi_time_batch_plan_size", pl, stream)
    launches += 1
    mode_launches[mode] += 1
    n = cap_out
    return Rows(ts=out_ts[:n], kind=out_kind[:n], valid=out_valid[:n],
                seq=out_seq[:n], gslot=out_gslot[:n],
                cols=tuple(c[:n] for c in out_cols)), wake
