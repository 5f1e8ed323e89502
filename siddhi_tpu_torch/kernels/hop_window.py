"""State, wrapper and plain version of the `hop_window` CUDA kernel (K18).

The kernel (`siddhi_tpu_torch/csrc/hop_window.cu`) replaces the JAX
package's `HoppingWindow.process` (`siddhi_tpu/core/window_ext.py:1166`,
with its `sort_rows` / `concat_rows` / `_scatter_buffer` calls),
`hopping(window.time, hop.time)` and its spelling `hoping`: every hop the
rows of the trailing window come out as one batch, so consecutive batches
overlap when hop < window.

The candidates of a step are the buffer's alive rows, then the arrivals,
in that order.  The first boundary `next` is the first arrival's ts + hop
(the least ts of the step that first has arrivals).  A step with
`now >= next` flushes at `emit = next + ((now - next) // hop) * hop` (the
boundaries passed in one gap collapse into one) and emits, numbered from
the step's seq0 with CB = C + B (B the batch's capacity):
  * the candidates with ts in [emit - hop - win, emit - hop) as EXPIRED
    rows, in candidate order, seq `seq0 + rank`;
  * one RESET row (ts now, group slot -1, default columns), seq
    `seq0 + CB`;
  * the candidates with ts in [emit - win, emit) as CURRENT rows, in
    candidate order, seq `seq0 + CB + 1 + rank`;
so one row can come out EXPIRED and CURRENT in the same step; the counter
advances by `2CB + 2` and `next` becomes emit + hop.  The buffer keeps the
candidates with ts >= next - win - hop (all of them while `next` is
unset), in candidate order; those past C drop, as in the reference, and
are counted in `missed` (the runtime raises).  The wake is `next`.

State (`HopState`): two buffers of C rows (ts, group slot, columns), the
alive rows of the current one at [0, n), and `meta` = [n, next (-1
unset), seq, which buffer is current, rows missed].  A step writes the
kept rows into the other buffer and flips the parity, so no buffer is
allocated per step.  A step's output is exactly its emitted rows.

`hop_window_step` is what `HoppingWindow.process` calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls` count
them; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows, empty_buffer
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS, BLOCK, SCAN_BLOCK = 16, 256, 1024
# meta words
N, NEXT, SEQ, PARITY, MISSED = range(5)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class HopState:
    """A hopping window's retained rows, in two buffers (see the module
    docstring)."""

    def __init__(self, C, b_ts, b_gslot, b_cols, meta, defaults):
        self.C = C
        self.b_ts, self.b_gslot = list(b_ts), list(b_gslot)
        self.b_cols = [tuple(c) for c in b_cols]
        self.meta = meta
        self.defaults = defaults        # the RESET row's column values

    @classmethod
    def empty(cls, schema: ev.Schema, C: int, device) -> "HopState":
        a, b = (empty_buffer(schema, C, device) for _ in range(2))
        meta = torch.zeros(5, dtype=torch.int64, device=device)
        meta[NEXT] = -1
        return cls(C, (a.ts, b.ts), (a.gslot, b.gslot), (a.cols, b.cols),
                   meta, tuple(ev.default_value(t) for t in schema.types))

    def tensors(self):
        return [*self.b_ts, *self.b_gslot,
                *(c for cols in self.b_cols for c in cols), self.meta]

    def clone(self) -> "HopState":
        return HopState(self.C, [x.clone() for x in self.b_ts],
                        [x.clone() for x in self.b_gslot],
                        [tuple(c.clone() for c in cols)
                         for cols in self.b_cols],
                        self.meta.clone(), self.defaults)

    def copy_from(self, other: "HopState") -> None:
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)

    def alive(self) -> dict:
        """The alive rows in buffer order and the counters (host read)."""
        n, nxt, seq, par, missed = (int(x) for x in self.meta.tolist())
        out = {"ts": self.b_ts[par][:n], "gslot": self.b_gslot[par][:n],
               "next": nxt, "seq": seq, "missed": missed}
        for j, c in enumerate(self.b_cols[par]):
            out[f"col{j}"] = c[:n]
        return out


def hop_window_step(st: HopState, arr: Rows, n_arr, now: int, win: int,
                    hop: int):
    """One step: `arr` are the batch's arrivals compacted to the front
    (filter_compact's output), `n_arr` their count (i64[1]).  Moves `st`
    in place; returns (Rows of exactly the emitted rows, i64[2] [wake,
    rows dropped])."""
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, now, win, hop)
    return plain(st, arr, n_arr, now, win, hop)


def plain(st: HopState, arr: Rows, n_arr, now: int, win: int, hop: int):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = st.meta.device
    C, B = st.C, int(arr.ts.shape[0])
    CB = C + B
    n, nxt0, seq0, par, missed0 = (int(x) for x in st.meta.tolist())
    na = int(n_arr)
    c_ts = torch.cat([st.b_ts[par][:n], arr.ts[:na]])
    c_gs = torch.cat([st.b_gslot[par][:n], arr.gslot[:na]])
    c_cols = [torch.cat([b[:n], a[:na]])
              for b, a in zip(st.b_cols[par], arr.cols)]
    nxt = nxt0 if nxt0 >= 0 else (int(arr.ts[:na].min()) + hop if na
                                  else -1)
    flush = nxt >= 0 and now >= nxt
    emit = nxt + ((now - nxt) // hop) * hop if flush else nxt
    i64 = torch.int64
    if flush:
        prev = emit - hop
        d = torch.nonzero((c_ts >= prev - win) & (c_ts < prev)).flatten()
        c = torch.nonzero((c_ts >= emit - win) & (c_ts < emit)).flatten()
        nd, nc = d.shape[0], c.shape[0]

        def full(v, d_):
            return torch.full((1,), v, dtype=d_, device=dev)
        kind = torch.cat([torch.full((nd,), ev.EXPIRED, dtype=torch.int32,
                                     device=dev), full(ev.RESET, torch.int32),
                          torch.full((nc,), ev.CURRENT, dtype=torch.int32,
                                     device=dev)])
        out = Rows(
            ts=torch.cat([c_ts[d], full(now, i64), c_ts[c]]), kind=kind,
            valid=torch.ones(nd + nc + 1, dtype=torch.bool, device=dev),
            seq=torch.cat([seq0 + torch.arange(nd, device=dev),
                           full(seq0 + CB, i64),
                           seq0 + CB + 1 + torch.arange(nc, device=dev)]),
            gslot=torch.cat([c_gs[d], full(-1, torch.int32), c_gs[c]]),
            cols=tuple(torch.cat([x[d], full(dv, x.dtype), x[c]])
                       for x, dv in zip(c_cols, st.defaults)))
    else:
        out = Rows(ts=c_ts[:0], kind=torch.zeros(0, dtype=torch.int32,
                                                 device=dev),
                   valid=torch.zeros(0, dtype=torch.bool, device=dev),
                   seq=c_ts[:0], gslot=c_gs[:0],
                   cols=tuple(x[:0] for x in c_cols))
    new_next = emit + hop if flush else nxt
    keep = c_ts >= new_next - win - hop if new_next >= 0 else \
        torch.ones_like(c_ts, dtype=torch.bool)
    k = torch.nonzero(keep).flatten()
    missed = max(k.shape[0] - C, 0)
    k = k[:C]
    m = k.shape[0]
    q = 1 - par
    st.b_ts[q][:m], st.b_gslot[q][:m] = c_ts[k], c_gs[k]
    for dst, src in zip(st.b_cols[q], c_cols):
        dst[:m] = src[k]
    st.meta.copy_(torch.tensor(
        [m, new_next, seq0 + 2 * CB + 2 if flush else seq0, q,
         missed0 + missed], dtype=i64))
    wake = torch.tensor([new_next if new_next >= 0 else NO_WAKEUP, missed],
                        dtype=i64, device=dev)
    return out, wake


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class HopPlan(ctypes.Structure):
    """Mirrors `struct HopPlan` in csrc/hop_window.cu."""
    _fields_ = (
        [(n, _L) for n in ("C", "A", "now", "win", "hop", "cap")] +
        [("ncols", _I), ("pad", _I), ("col_bytes", _I * MAX_COLS),
         ("reset_val", _L * MAX_COLS),
         ("b_ts", _P * 2), ("b_gslot", _P * 2),
         ("b_col", (_P * MAX_COLS) * 2), ("meta", _P),
         ("a_ts", _P), ("a_gslot", _P), ("a_col", _P * MAX_COLS),
         ("n_arr", _P), ("sums", _P * 3), ("scal", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS), ("wake", _P)])


# scal words the prepare launch leaves for the write launch and the host
S_NOUT = 0


def prepare(st: HopState, arr: Rows, n_arr, now: int, win: int, hop: int):
    """Check the inputs and fill a plan; returns (plan, the tensors the
    launches read, which stay referenced until both are queued:
    "scal"[S_NOUT] is the output row count after the prepare launch,
    "wake" the step's i64[2])."""
    dev = st.meta.device
    C, A = st.C, int(arr.ts.shape[0])
    for x, d, name in ((arr.ts, torch.int64, "ts"),
                       (arr.gslot, torch.int32, "gslot"),
                       (n_arr, torch.int64, "n_arr")):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError(f"hop_window: arrival {name} must be a "
                             f"contiguous {d} tensor on {dev}")
    cols0 = st.b_cols[0]
    if len(cols0) > MAX_COLS or len(arr.cols) != len(cols0):
        raise ValueError("hop_window: column count")
    pl = HopPlan()
    pl.C, pl.A, pl.now = C, A, int(now)
    pl.win, pl.hop, pl.ncols = int(win), int(hop), len(cols0)
    for j, (ac, dv) in enumerate(zip(arr.cols, st.defaults)):
        if ac.dtype != cols0[j].dtype or not ac.is_contiguous() or \
                ac.device != dev:
            raise ValueError(f"hop_window: arrival column {j} dtype")
        pl.col_bytes[j] = cols0[j].element_size()
        pl.reset_val[j] = _nvcc.slot_bits(dv, cols0[j].dtype)
        pl.a_col[j] = ac.data_ptr()
        for b in range(2):
            pl.b_col[b][j] = st.b_cols[b][j].data_ptr()
    for b in range(2):
        pl.b_ts[b], pl.b_gslot[b] = st.b_ts[b].data_ptr(), \
            st.b_gslot[b].data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    nb = (C + A + BLOCK - 1) // BLOCK
    sums = [torch.empty(nb + 1, dtype=torch.int64, device=dev)
            for _ in range(3)]
    scal = torch.zeros(8, dtype=torch.int64, device=dev)
    wake = torch.empty(2, dtype=torch.int64, device=dev)
    for j in range(3):
        pl.sums[j] = sums[j].data_ptr()
    pl.scal, pl.wake = scal.data_ptr(), wake.data_ptr()
    return pl, {"scal": scal, "wake": wake, "sums": sums, "inputs": arr}


def alloc_out(pl: HopPlan, st: HopState, n: int, dev) -> Rows:
    def e(d):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=None,
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(c.dtype) for c in st.b_cols[0]))
    pl.cap = n
    pl.out_ts, pl.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    for j, c in enumerate(out.cols):
        pl.out_col[j] = c.data_ptr()
    return out


def _call(entry: str, pl: HopPlan, dev) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("hop_window", entry, "siddhi_hop_plan_size", pl,
                      stream)


def launch(st: HopState, arr: Rows, n_arr, now: int, win: int, hop: int,
           n_out=None):
    """The prepare launch (the step's boundary, each candidate's flags and
    their scans), one fetch of the output row count (it sizes the output;
    `n_out`, when the caller knows it, skips the fetch), the write launch
    (the rows and the kept buffer at their ranks)."""
    global launches
    dev = st.meta.device
    pl, bufs = prepare(st, arr, n_arr, now, win, hop)
    _call("siddhi_hop_prepare", pl, dev)
    n = int(bufs["scal"][S_NOUT]) if n_out is None else n_out
    out = alloc_out(pl, st, n, dev)
    _call("siddhi_hop_write", pl, dev)
    launches += 1
    wake = bufs["wake"]
    del bufs
    return Rows(ts=out.ts[:n], kind=out.kind[:n],
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=out.seq[:n], gslot=out.gslot[:n],
                cols=tuple(c[:n] for c in out.cols)), wake
