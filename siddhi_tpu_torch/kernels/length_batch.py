"""State, wrapper and plain version of the `length_batch` CUDA kernel (K3).

The kernel (`siddhi_tpu_torch/csrc/length_batch.cu`) replaces the JAX
package's `LengthBatchWindow.process` (`siddhi_tpu/core/window.py:447`).
Arrivals fill a pending batch of n rows; a send may complete several
batches (flushes).  Flush f of a step emits, numbered from the step's
`seq0`:
  * the previous batch as EXPIRED rows (original ts), seq
    `seq0 + f*(2n+2) + [0, n)` -- at f = 0 the batch kept from earlier
    sends, none before the first flush ever;
  * one RESET row, seq `seq0 + f*(2n+2) + n`, ts = now, group slot -1,
    default column values;
  * the completed batch as CURRENT rows, seq `seq0 + f*(2n+2) + n+1+[0,n)`.
The seq counter advances by `nflush*(2n+2)`; the pending rows and the last
flushed batch carry across sends.  Every output row's place follows from
its flush and offset, so the kernel writes each row from one thread with
no sort and no scan.

State (`BatchState`): pending and previous batches (ts, group slot,
columns) of n rows each and `meta` = [fill, prev_count, seq] on the device.

`length_batch_step` is what `LengthBatchWindow.process` calls: CPU tensors
run `plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls`
count them; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import Rows, empty_buffer
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS = 16
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class BatchState:
    """Pending / previous batches of a lengthBatch window."""

    def __init__(self, n, p_ts, p_gslot, p_cols, q_ts, q_gslot, q_cols,
                 meta, defaults):
        self.n = n
        self.p_ts, self.p_gslot, self.p_cols = p_ts, p_gslot, tuple(p_cols)
        self.q_ts, self.q_gslot, self.q_cols = q_ts, q_gslot, tuple(q_cols)
        self.meta = meta
        self.defaults = defaults        # RESET rows' column values

    @classmethod
    def empty(cls, schema: ev.Schema, n: int, device) -> "BatchState":
        p, q = (empty_buffer(schema, n, device) for _ in range(2))
        defaults = tuple(ev.default_value(t) for t in schema.types)
        return cls(n, p.ts, p.gslot, p.cols, q.ts, q.gslot, q.cols,
                   torch.zeros(3, dtype=torch.int64, device=device),
                   defaults)

    def clone(self) -> "BatchState":
        return BatchState(
            self.n, self.p_ts.clone(), self.p_gslot.clone(),
            tuple(c.clone() for c in self.p_cols), self.q_ts.clone(),
            self.q_gslot.clone(), tuple(c.clone() for c in self.q_cols),
            self.meta.clone(), self.defaults)


def out_capacity(n: int, n_cur: int) -> int:
    """Rows a step can emit when at most `n_cur` rows arrive: every flush
    it can complete (the pending batch holds at most n-1 rows) emits at
    most 2n+1 rows."""
    return ((n - 1 + n_cur) // n) * (2 * n + 1)


def length_batch_step(st: BatchState, arr: Rows, n_arr, now: int, facts):
    """One step: `arr` are the batch's arrivals compacted to the front,
    `n_arr` their count (i64[1]).  Updates `st` in place; returns rows."""
    cap_out = out_capacity(st.n, int(facts.cur_ts.shape[0]))
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, now, cap_out)
    return plain(st, arr, n_arr, now, cap_out)


def plain(st: BatchState, arr: Rows, n_arr, now: int, cap_out: int):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = st.p_ts.device
    n = st.n
    fill0, pc, seq0 = (int(x) for x in st.meta.tolist())
    na = int(n_arr)
    G = fill0 + na
    nflush = G // n
    # the step's rows in arrival order: pending ones, then arrivals
    c_ts = torch.cat([st.p_ts[:fill0], arr.ts[:na]])
    c_gslot = torch.cat([st.p_gslot[:fill0], arr.gslot[:na]])
    c_cols = [torch.cat([p[:fill0], a[:na]])
              for p, a in zip(st.p_cols, arr.cols)]
    shift = n if (pc == 0 and nflush > 0) else 0
    n_out = max(0, nflush * (2 * n + 1) - shift)
    q = torch.arange(n_out, dtype=torch.int64, device=dev) + shift
    f, loc = q // (2 * n + 1), q % (2 * n + 1)
    is_exp, is_reset = loc < n, loc == n
    # source of each row: prev batch (flush 0 expired), else step row g
    from_prev = torch.logical_and(is_exp, f == 0)
    g = torch.where(is_exp, (f - 1) * n + loc, f * n + loc - n - 1)
    gi = torch.clamp(g, 0, max(G - 1, 0))
    pi = torch.clamp(loc, 0, n - 1)

    def pick(prev_col, step_col, reset_val):
        if G:
            v = torch.where(from_prev, prev_col[pi], step_col[gi])
        else:
            v = prev_col[pi]
        return torch.where(is_reset, torch.full_like(v, reset_val), v)

    def padded(x, fill=0):
        o = torch.full((cap_out,), fill, dtype=x.dtype, device=dev)
        o[:n_out] = x
        return o

    kind = torch.where(is_exp, ev.EXPIRED,
                       torch.where(is_reset, ev.RESET, ev.CURRENT))
    out = Rows(
        ts=padded(pick(st.q_ts, c_ts, now)),
        kind=padded(kind.to(torch.int32)),
        valid=padded(torch.ones(n_out, dtype=torch.bool, device=dev), False),
        seq=padded(seq0 + f * (2 * n + 2) + loc),
        gslot=padded(pick(st.q_gslot, c_gslot, -1)),
        cols=tuple(padded(pick(qc, cc, dv)) for qc, cc, dv in
                   zip(st.q_cols, c_cols, st.defaults)))
    # new previous batch: the last flushed one; new pending: the rest
    if nflush:
        lo = (nflush - 1) * n
        st.q_ts.copy_(c_ts[lo:lo + n])
        st.q_gslot.copy_(c_gslot[lo:lo + n])
        for qc, cc in zip(st.q_cols, c_cols):
            qc.copy_(cc[lo:lo + n])
        pc = n
    rest = G - nflush * n
    lo = nflush * n
    st.p_ts[:rest] = c_ts[lo:G]
    st.p_gslot[:rest] = c_gslot[lo:G]
    for p, cc in zip(st.p_cols, c_cols):
        p[:rest] = cc[lo:G]
    st.meta.copy_(torch.tensor([rest, pc, seq0 + nflush * (2 * n + 2)],
                               dtype=torch.int64))
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class BatchPlan(ctypes.Structure):
    """Mirrors `struct BatchPlan` in csrc/length_batch.cu."""
    _fields_ = (
        [("n", _L), ("now", _L), ("cap_out", _L),
         ("ncols", _I), ("col_bytes", _I * MAX_COLS),
         ("reset_val", _L * MAX_COLS),
         ("p_ts", _P), ("p_gslot", _P), ("p_col", _P * MAX_COLS),
         ("q_ts", _P), ("q_gslot", _P), ("q_col", _P * MAX_COLS),
         ("meta", _P), ("a_ts", _P), ("a_gslot", _P),
         ("a_col", _P * MAX_COLS), ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS)])


def launch(st: BatchState, arr: Rows, n_arr, now: int, cap_out: int):
    global launches
    dev = st.p_ts.device
    if len(st.p_cols) > MAX_COLS or len(arr.cols) != len(st.p_cols):
        raise ValueError("length_batch: column count")
    if arr.ts.dtype != torch.int64 or arr.gslot.dtype != torch.int32 or \
            arr.ts.device != dev or n_arr.dtype != torch.int64:
        raise ValueError("length_batch: arrival rows dtype or device")
    pl = BatchPlan()
    pl.n, pl.now, pl.cap_out = st.n, int(now), cap_out
    pl.ncols = len(st.p_cols)
    e = lambda d: torch.empty(max(cap_out, 1), dtype=d,  # noqa: E731
                              device=dev)
    out_ts, out_kind, out_valid = e(torch.int64), e(torch.int32), \
        e(torch.bool)
    out_seq, out_gslot = e(torch.int64), e(torch.int32)
    out_cols = [e(c.dtype) for c in st.p_cols]
    for j, (pc, qc, ac, dv) in enumerate(zip(st.p_cols, st.q_cols,
                                             arr.cols, st.defaults)):
        if ac.dtype != pc.dtype or not ac.is_contiguous():
            raise ValueError("length_batch: arrival column dtype")
        pl.col_bytes[j] = pc.element_size()
        pl.reset_val[j] = _nvcc.slot_bits(dv, pc.dtype)
        pl.p_col[j], pl.q_col[j] = pc.data_ptr(), qc.data_ptr()
        pl.a_col[j], pl.out_col[j] = ac.data_ptr(), out_cols[j].data_ptr()
    pl.p_ts, pl.p_gslot = st.p_ts.data_ptr(), st.p_gslot.data_ptr()
    pl.q_ts, pl.q_gslot = st.q_ts.data_ptr(), st.q_gslot.data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    pl.out_seq, pl.out_gslot = out_seq.data_ptr(), out_gslot.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("length_batch", "siddhi_length_batch",
                      "siddhi_batch_plan_size", pl, stream)
    launches += 1
    n = cap_out
    return Rows(ts=out_ts[:n], kind=out_kind[:n], valid=out_valid[:n],
                seq=out_seq[:n], gslot=out_gslot[:n],
                cols=tuple(c[:n] for c in out_cols))
