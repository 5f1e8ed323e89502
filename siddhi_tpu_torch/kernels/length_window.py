"""Ring state, wrapper and plain version of the `length_window` CUDA kernel
(K5).

The kernel (`siddhi_tpu_torch/csrc/length_window.cu`) replaces the JAX
package's `LengthWindow.process` (`siddhi_tpu/core/window.py:249-316`)
with its `sort_rows` / `concat_rows` calls.  Its observable rows are the
reference's:
  * the k-th CURRENT arrival of the batch (k = 0..n-1, after the filters'
    compaction) evicts virtual entry `count0 + k - C` when that is >= 0,
    where the virtual sequence is the window's rows by age followed by
    the batch's arrivals; that entry comes out EXPIRED with its original
    ts, just before arrival k comes out CURRENT;
  * EXPIRED k is numbered `seq0 + 2k`, CURRENT k `seq0 + 2k + 1`, and the
    counter advances to `seq0 + 2n`;
  * the window keeps the last C rows of the virtual sequence.
Output rows are valid-first in seq order, as `sort_rows` leaves them, at
closed-form positions: with k0 = max(0, C - count0) arrivals that evict
nothing, CURRENT k < k0 sits at k, and for k >= k0 EXPIRED k sits at
k0 + 2(k - k0) and CURRENT k right after it.  The output has 2B rows (B the
arrivals' capacity); only the valid ones are defined.

State (`LengthRing`): the window as a ring of capacity C in add_seq order,
alive rows at logical positions [head, tail) (physical = logical mod C),
and `meta` = [head, tail, seq, 0] on the device, the layout of
`kernels/time_window.py`'s `TimeRing`, so the join kernels read either.
The ring stores no add_seq: from the empty ring, seq advances by 2n
whenever tail advances by n, so the row at logical position p has add_seq
2p + 1, and nothing reads it.
A step reads the ring rows that are evicted and writes the arrivals that
stay (the last C); the rest of the ring is not touched.

`length_window_step` is what `LengthWindow.process` calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls` count
them; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import Rows
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS = 16
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class LengthRing:
    """A length window's buffer as a ring (see the module docstring)."""

    def __init__(self, ts, gslot, cols, meta):
        self.ts, self.gslot = ts, gslot
        self.cols, self.meta = tuple(cols), meta

    @property
    def C(self) -> int:
        return self.ts.shape[0]

    @classmethod
    def empty(cls, schema: ev.Schema, C: int, device) -> "LengthRing":
        def z(d):
            return torch.zeros(C, dtype=d, device=device)
        return cls(z(torch.int64), z(torch.int32),
                   tuple(z(d) for d in schema.dtypes),
                   torch.zeros(4, dtype=torch.int64, device=device))

    def clone(self) -> "LengthRing":
        return LengthRing(self.ts.clone(), self.gslot.clone(),
                          tuple(c.clone() for c in self.cols),
                          self.meta.clone())

    def live(self):
        """(head, tail, seq, physical positions of the alive rows)."""
        head, tail, seq = (int(x) for x in self.meta[:3].tolist())
        pos = torch.remainder(
            head + torch.arange(tail - head, dtype=torch.int64,
                                device=self.ts.device), self.C)
        return head, tail, seq, pos


def length_window_step(st: LengthRing, arr: Rows, n_arr) -> Rows:
    """One step: `arr` are the batch's arrivals compacted to the front
    (filter_compact's output), `n_arr` their count (i64[1]).  Updates `st`
    in place; returns the 2B output rows."""
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr)
    return plain(st, arr, n_arr)


def plain(st: LengthRing, arr: Rows, n_arr) -> Rows:
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = st.ts.device
    C, B = st.C, arr.ts.shape[0]
    head, tail, seq0, _ = st.live()
    n = int(n_arr)
    count0 = tail - head
    k0 = max(0, C - count0)
    k = torch.arange(n, dtype=torch.int64, device=dev)
    ek = k[k >= k0]                      # arrivals that evict
    v = count0 + ek - C                  # the virtual entries they evict
    old = v < count0
    rpos = torch.remainder(head + v[old], C)
    apos = v[~old] - count0

    def evicted(ring_col, arr_col):
        out = torch.empty(ek.shape[0], dtype=ring_col.dtype, device=dev)
        out[old] = ring_col[rpos]
        out[~old] = arr_col[apos]
        return out
    e_ts = evicted(st.ts, arr.ts)
    e_gslot = evicted(st.gslot, arr.gslot)
    e_cols = [evicted(rc, ac) for rc, ac in zip(st.cols, arr.cols)]

    def zeros(x):
        return torch.zeros(2 * B, dtype=x.dtype, device=dev)
    out = Rows(ts=zeros(arr.ts), kind=zeros(arr.kind),
               valid=torch.zeros(2 * B, dtype=torch.bool, device=dev),
               seq=zeros(arr.ts), gslot=zeros(arr.gslot),
               cols=tuple(zeros(c) for c in arr.cols))
    cpos = torch.where(k < k0, k, k0 + 2 * (k - k0) + 1)
    epos = k0 + 2 * (ek - k0)
    for pos, ts, kind, seq, gslot, cols in (
            (cpos, arr.ts[:n], ev.CURRENT, seq0 + 2 * k + 1, arr.gslot[:n],
             [c[:n] for c in arr.cols]),
            (epos, e_ts, ev.EXPIRED, seq0 + 2 * ek, e_gslot, e_cols)):
        out.ts[pos] = ts
        out.kind[pos] = kind
        out.valid[pos] = True
        out.seq[pos] = seq
        out.gslot[pos] = gslot
        for oc, c in zip(out.cols, cols):
            oc[pos] = c
    # the arrivals that stay: the last C
    w = k[k >= n - C]
    dst = torch.remainder(tail + w, C)
    st.ts[dst] = arr.ts[w]
    st.gslot[dst] = arr.gslot[w]
    for rc, ac in zip(st.cols, arr.cols):
        rc[dst] = ac[w]
    tail2 = tail + n
    st.meta.copy_(torch.tensor([tail2 - min(count0 + n, C), tail2,
                                seq0 + 2 * n, 0], dtype=torch.int64))
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class LengthPlan(ctypes.Structure):
    """Mirrors `struct LengthPlan` in csrc/length_window.cu."""
    _fields_ = (
        [("C", _L), ("B", _L), ("ncols", _I), ("col_bytes", _I * MAX_COLS),
         ("ts", _P), ("gslot", _P), ("col", _P * MAX_COLS),
         ("meta", _P),
         ("a_ts", _P), ("a_gslot", _P), ("a_col", _P * MAX_COLS),
         ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS)])


def launch(st: LengthRing, arr: Rows, n_arr) -> Rows:
    """Launch the step on the current stream."""
    global launches
    dev = st.ts.device
    C, B = st.C, arr.ts.shape[0]
    for x, d in ((arr.ts, torch.int64), (arr.gslot, torch.int32),
                 (n_arr, torch.int64)):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError("length_window: arrival rows have the wrong "
                             "device, dtype or layout")
    if len(st.cols) > MAX_COLS or len(arr.cols) != len(st.cols):
        raise ValueError("length_window: column count")

    def e(d):
        return torch.empty(max(2 * B, 1), dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=e(torch.bool),
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(c.dtype) for c in st.cols))
    pl = LengthPlan()
    pl.C, pl.B, pl.ncols = C, B, len(st.cols)
    for j, (rc, ac) in enumerate(zip(st.cols, arr.cols)):
        if ac.dtype != rc.dtype or not ac.is_contiguous() or \
                ac.device != dev:
            raise ValueError("length_window: arrival column dtype")
        pl.col_bytes[j] = rc.element_size()
        pl.col[j], pl.a_col[j] = rc.data_ptr(), ac.data_ptr()
        pl.out_col[j] = out.cols[j].data_ptr()
    pl.ts, pl.gslot = st.ts.data_ptr(), st.gslot.data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out.ts.data_ptr(), \
        out.kind.data_ptr(), out.valid.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("length_window", "siddhi_length_window",
                      "siddhi_length_plan_size", pl, stream)
    launches += 1
    if B == 0:
        out = Rows(*(x[:0] for x in out[:5]),
                   cols=tuple(c[:0] for c in out.cols))
    return out
