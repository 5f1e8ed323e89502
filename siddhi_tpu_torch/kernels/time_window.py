"""Ring state, wrapper and plain version of the `time_window` CUDA kernel
(K2).

The kernel (`siddhi_tpu_torch/csrc/time_window.cu`) replaces the JAX
package's `TimeWindow.process` (`siddhi_tpu/core/window.py:346`) with its
`sort_rows` / `concat_rows` calls.  Its observable rows are the
reference's:
  * rows that expire (`expire_ts <= now`) come out EXPIRED with
    ts = expire_ts, arrivals come out CURRENT; the order is a stable sort
    by `expire_ts*2` (expired, in buffer order) and `ts*2+1` (arrivals, in
    batch order), numbered `seq0 + rank`;
  * arrivals enter the buffer with add_seq = their seq and
    expire_ts = ts + t; when more than C rows are alive the oldest drop
    silently, unemitted;
  * the seq counter advances by C + B (B = the batch's capacity) whenever
    any row is emitted, as the reference's `rank.max() + 1` does;
  * `wake` is the least expire_ts of the rows alive after the step.

The host sizes a step from a bound on the rows it can expire
(`RingFacts.expire_bound`).  When more rows expire than that bound, both
versions leave the ring as it was, emit nothing valid, and write the
number of rows the bound missed as the second word of `wake` (0 after a
step that was applied); the runtime reads it in the same fetch as the
wake and raises.

State (`TimeRing`): the buffer as a ring of capacity C in add_seq order,
alive rows at logical positions [head, tail) (physical = logical mod C),
and `meta` = [head, tail, seq, 0] on the device.  A step reads the rows
that expire and writes the rows that arrive; the rest of the buffer is
not touched.  While expire_ts rises along the ring (event time in order),
the rows that expire are a prefix found by binary search; otherwise the
step scans the ring, sorts the expiring rows and compacts the survivors
toward the tail.  The host knows which case holds from the timestamps it
has sent (`RingFacts`), and also bounds how many rows can expire, which
sizes the step's output.

`time_window_step` is what `TimeWindow.process` calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls`
count them; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows, concat_rows, sort_rows
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS, BLOCK = 16, 256
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_MAX_ENTRIES = 256


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class RingFacts:
    """Host-side facts about a ring, kept from the timestamps sent into
    it: whether expire_ts rises along the ring (`sorted`), the largest
    expire_ts ever admitted (`hmax`), the time after which the rows behind
    the last out-of-order arrival have all expired (`dis_until`), and
    per-send (least, largest expire_ts, rows) entries that bound how many
    rows a step can expire."""

    def __init__(self, C: int):
        self.C = C
        self.sorted = True
        self.hmax = -(2 ** 62)
        self.dis_until = -(2 ** 62)
        self.entries: List[List[int]] = []

    def copy(self) -> "RingFacts":
        f = RingFacts(self.C)
        f.sorted, f.hmax, f.dis_until = self.sorted, self.hmax, \
            self.dis_until
        f.entries = [list(e) for e in self.entries]
        return f

    def expire_bound(self, now: int) -> int:
        """At least as many rows as this step can expire; forgets sends
        whose rows all expire in it."""
        eb = sum(n for lo, _, n in self.entries if lo <= now)
        self.entries = [e for e in self.entries if e[1] > now]
        return min(eb, self.C)

    def after_step(self, cur_ts: np.ndarray, now: int, t: int) -> None:
        if not self.sorted and now >= self.dis_until:
            # the general step just expired every row behind the last
            # out-of-order arrival and compacted the survivors
            self.sorted = True
        if cur_ts.shape[0] == 0:
            return
        lo, hi = int(cur_ts.min()) + t, int(cur_ts.max()) + t
        if self.hmax > lo and self.hmax > now:
            self.dis_until = self.hmax if self.sorted else \
                max(self.dis_until, self.hmax)
            self.sorted = False
        self.hmax = max(self.hmax, hi)
        self.entries.append([lo, hi, int(cur_ts.shape[0])])
        if len(self.entries) > _MAX_ENTRIES:
            a, b = self.entries[0], self.entries[1]
            self.entries[:2] = [[min(a[0], b[0]), max(a[1], b[1]),
                                 a[2] + b[2]]]


class TimeRing:
    """A time window's buffer as a ring (see the module docstring)."""

    def __init__(self, ts, add_seq, expire_ts, gslot, cols, meta, facts):
        self.ts, self.add_seq, self.expire_ts = ts, add_seq, expire_ts
        self.gslot, self.cols, self.meta = gslot, tuple(cols), meta
        self.facts = facts

    @property
    def C(self) -> int:
        return self.ts.shape[0]

    @classmethod
    def empty(cls, schema: ev.Schema, C: int, device) -> "TimeRing":
        z64 = lambda: torch.zeros(C, dtype=torch.int64,  # noqa: E731
                                  device=device)
        cols = tuple(torch.zeros(C, dtype=d, device=device)
                     for d in schema.dtypes)
        return cls(z64(), z64(), z64(),
                   torch.zeros(C, dtype=torch.int32, device=device), cols,
                   torch.zeros(4, dtype=torch.int64, device=device),
                   RingFacts(C))

    def clone(self) -> "TimeRing":
        return TimeRing(self.ts.clone(), self.add_seq.clone(),
                        self.expire_ts.clone(), self.gslot.clone(),
                        tuple(c.clone() for c in self.cols),
                        self.meta.clone(), self.facts.copy())

    def live(self):
        """(head, tail, seq, physical positions of the alive rows)."""
        head, tail, seq = (int(x) for x in self.meta[:3].tolist())
        pos = torch.remainder(
            head + torch.arange(tail - head, dtype=torch.int64,
                                device=self.ts.device), self.C)
        return head, tail, seq, pos

    def grown(self, C: int) -> "TimeRing":
        """This ring's rows in a ring of capacity C (>= the alive rows),
        at logical positions [0, L); the host facts carried over."""
        _, _, seq, pos = self.live()
        L = pos.shape[0]

        def g(x):
            y = torch.zeros(C, dtype=x.dtype, device=x.device)
            y[:L] = x[pos]
            return y
        f = self.facts.copy()
        f.C = C
        meta = torch.tensor([0, L, seq, 0], dtype=torch.int64,
                            device=self.meta.device)
        return TimeRing(g(self.ts), g(self.add_seq), g(self.expire_ts),
                        g(self.gslot), tuple(g(c) for c in self.cols), meta,
                        f)


def time_window_step(st: TimeRing, arr: Rows, n_arr, now: int, t: int,
                     facts):
    """One step: `arr` are the batch's arrivals compacted to the front
    (filter_compact's output), `n_arr` their count (i64[1]).  Updates `st`
    in place; returns (rows, wake i64[2] = [least expire_ts alive, rows
    the expire bound missed])."""
    f = st.facts
    cur = facts.cur_ts
    e_bound = f.expire_bound(now)
    cap_out = e_bound + int(cur.shape[0])
    a_sorted = cur.shape[0] < 2 or bool(np.all(cur[1:] >= cur[:-1]))
    if arr.ts.is_cuda:
        out = launch(st, arr, n_arr, now, t, facts.capacity, cap_out,
                     e_bound, f.sorted, a_sorted)
    else:
        out = plain(st, arr, n_arr, now, t, facts.capacity, cap_out,
                    e_bound)
    f.after_step(cur, now, t)
    return out


def plain(st: TimeRing, arr: Rows, n_arr, now: int, t: int, B: int,
          cap_out: int, e_bound: int):
    """The plain PyTorch version (the kernel's reference): the general
    step, whatever order the ring is in."""
    global plain_calls
    plain_calls += 1
    dev = st.ts.device
    C = st.C
    head, tail, seq0, pos = st.live()
    na = int(n_arr)
    due = st.expire_ts[pos] <= now
    epos = pos[due]
    epos = epos[torch.argsort(st.expire_ts[epos], stable=True)]
    ne = epos.shape[0]

    def zeros(x):
        return torch.zeros((cap_out,), dtype=x.dtype, device=dev)
    if ne > e_bound:
        return (Rows(*(zeros(x) for x in arr[:5]),
                     cols=tuple(zeros(c) for c in st.cols)),
                torch.tensor([NO_WAKEUP, ne - e_bound], dtype=torch.int64,
                             device=dev))
    a_ts = arr.ts[:na]
    aidx = torch.argsort(a_ts, stable=True)
    keys = torch.cat([2 * st.expire_ts[epos], 2 * a_ts[aidx] + 1])
    m = torch.argsort(keys, stable=True)
    n_out = ne + na
    rank = torch.empty_like(m)
    rank[m] = torch.arange(n_out, dtype=torch.int64, device=dev)

    def full(n, v, dtype=torch.int32):
        return torch.full((n,), v, dtype=dtype, device=dev)
    expired = Rows(ts=st.expire_ts[epos], kind=full(ne, ev.EXPIRED),
                   valid=full(ne, True, torch.bool), seq=seq0 + rank[:ne],
                   gslot=st.gslot[epos], cols=tuple(c[epos] for c in st.cols))
    arrived = Rows(ts=a_ts[aidx], kind=full(na, ev.CURRENT),
                   valid=full(na, True, torch.bool), seq=seq0 + rank[ne:],
                   gslot=arr.gslot[:na][aidx],
                   cols=tuple(c[:na][aidx] for c in arr.cols))
    rows = sort_rows(concat_rows(expired, arrived))

    def padded(x):
        o = zeros(x)
        o[:n_out] = x
        return o
    out = Rows(*(padded(x) for x in rows[:5]),
               cols=tuple(padded(c) for c in rows.cols))

    # survivors keep their order and move to the tail end of the old range;
    # arrivals follow in emission order; the oldest beyond C drop
    kept = pos[torch.logical_not(due)]
    nk = kept.shape[0]
    dst = torch.remainder(tail - nk + torch.arange(nk, device=dev), C)
    for buf in (st.ts, st.add_seq, st.expire_ts, st.gslot, *st.cols):
        buf[dst] = buf[kept].clone()
    head2 = tail - nk + max(0, nk + na - C)
    lpos = tail + torch.arange(na, dtype=torch.int64, device=dev)
    w = lpos >= head2
    adst = torch.remainder(lpos[w], C)
    src = aidx[w]
    st.ts[adst] = a_ts[src]
    st.add_seq[adst] = seq0 + rank[ne:][w]
    st.expire_ts[adst] = a_ts[src] + t
    st.gslot[adst] = arr.gslot[:na][src]
    for rc, ac in zip(st.cols, arr.cols):
        rc[adst] = ac[:na][src]
    tail2 = tail + na
    seq2 = seq0 + C + B if n_out else seq0
    lpos2 = torch.remainder(
        head2 + torch.arange(tail2 - head2, dtype=torch.int64, device=dev), C)
    wake = int(st.expire_ts[lpos2].min()) if tail2 > head2 else NO_WAKEUP
    st.meta.copy_(torch.tensor([head2, tail2, seq2, 0], dtype=torch.int64))
    return out, torch.tensor([wake, 0], dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class TimePlan(ctypes.Structure):
    """Mirrors `struct TimePlan` in csrc/time_window.cu."""
    _fields_ = (
        [(n, _L) for n in ("C", "B", "now", "t", "cap_out", "e_bound",
                           "arr_cap", "e_sort_n", "a_sort_n")] +
        [("ncols", _I), ("e_prefix", _I), ("a_sorted", _I),
         ("col_bytes", _I * MAX_COLS),
         ("ts", _P), ("add_seq", _P), ("expire_ts", _P), ("gslot", _P),
         ("col", _P * MAX_COLS), ("meta", _P),
         ("a_ts", _P), ("a_gslot", _P), ("a_col", _P * MAX_COLS),
         ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("wake", _P), ("work", _P), ("block_sums", _P), ("e_list", _P),
         ("k_list", _P), ("s_ts", _P), ("s_add", _P), ("s_exp", _P),
         ("s_gslot", _P), ("s_col", _P * MAX_COLS),
         ("e_keys", _P), ("e_vals", _P), ("a_keys", _P), ("a_vals", _P),
         ("a_seq", _P)])


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def launch(st: TimeRing, arr: Rows, n_arr, now: int, t: int, B: int,
           cap_out: int, e_bound: int, e_prefix: bool, a_sorted: bool):
    """Launch the step on the current stream.  `e_prefix`: the host knows
    expire_ts rises along the ring; `a_sorted`: the batch's timestamps do
    not fall.  `e_bound` bounds the rows that can expire, `cap_out` the
    rows emitted."""
    global launches
    dev = st.ts.device
    C = st.C
    A = arr.ts.shape[0]
    for x, d in ((arr.ts, torch.int64), (arr.gslot, torch.int32),
                 (n_arr, torch.int64)):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError("time_window: arrival rows have the wrong "
                             "device, dtype or layout")
    if len(st.cols) > MAX_COLS or len(arr.cols) != len(st.cols):
        raise ValueError("time_window: column count")

    def e(n, d=torch.int64):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    general = not e_prefix
    pl = TimePlan()
    pl.C, pl.B, pl.now, pl.t = C, B, int(now), int(t)
    pl.cap_out, pl.e_bound, pl.arr_cap = cap_out, e_bound, A
    pl.e_sort_n = _pow2(max(e_bound, 1)) if general else 0
    pl.a_sort_n = _pow2(max(A, 1)) if not a_sorted else 0
    pl.ncols, pl.e_prefix, pl.a_sorted = len(st.cols), int(e_prefix), \
        int(a_sorted)
    out = Rows(ts=e(cap_out), kind=e(cap_out, torch.int32),
               valid=e(cap_out, torch.bool), seq=e(cap_out),
               gslot=e(cap_out, torch.int32),
               cols=tuple(e(cap_out, c.dtype) for c in st.cols))
    wake = e(2)
    work = torch.zeros(8, dtype=torch.int64, device=dev)
    # scratch of the general step (sized 1 when unused)
    gn = C if general else 0
    block_sums = e((gn + BLOCK - 1) // BLOCK + 1)
    e_list, k_list = e(gn), e(gn)
    stash = (e(gn), e(gn), e(gn), e(gn, torch.int32))
    s_cols = [e(gn, c.dtype) for c in st.cols]
    e_keys, e_vals = e(pl.e_sort_n), e(pl.e_sort_n, torch.int32)
    a_keys, a_vals = e(pl.a_sort_n), e(pl.a_sort_n, torch.int32)
    a_seq = e(A)
    for j, (rc, ac) in enumerate(zip(st.cols, arr.cols)):
        if ac.dtype != rc.dtype or not ac.is_contiguous():
            raise ValueError("time_window: arrival column dtype")
        pl.col_bytes[j] = rc.element_size()
        pl.col[j], pl.a_col[j] = rc.data_ptr(), ac.data_ptr()
        pl.out_col[j] = out.cols[j].data_ptr()
        pl.s_col[j] = s_cols[j].data_ptr()
    pl.ts, pl.add_seq, pl.expire_ts = st.ts.data_ptr(), \
        st.add_seq.data_ptr(), st.expire_ts.data_ptr()
    pl.gslot, pl.meta = st.gslot.data_ptr(), st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out.ts.data_ptr(), \
        out.kind.data_ptr(), out.valid.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    pl.wake, pl.work = wake.data_ptr(), work.data_ptr()
    pl.block_sums, pl.e_list, pl.k_list = block_sums.data_ptr(), \
        e_list.data_ptr(), k_list.data_ptr()
    pl.s_ts, pl.s_add, pl.s_exp, pl.s_gslot = (x.data_ptr() for x in stash)
    pl.e_keys, pl.e_vals = e_keys.data_ptr(), e_vals.data_ptr()
    pl.a_keys, pl.a_vals = a_keys.data_ptr(), a_vals.data_ptr()
    pl.a_seq = a_seq.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("time_window", "siddhi_time_window",
                      "siddhi_time_plan_size", pl, stream)
    launches += 1
    if cap_out == 0:
        out = Rows(*(x[:0] for x in out[:5]),
                   cols=tuple(c[:0] for c in out.cols))
    return out, wake
