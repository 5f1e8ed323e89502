"""State, wrapper and plain version of the `ext_window` CUDA kernel (K16).

The kernel (`siddhi_tpu_torch/csrc/ext_window.cu`) replaces three sliding
windows of the JAX package's `siddhi_tpu/core/window_ext.py`, each with its
`sort_rows` / `concat_rows` / `_scatter_buffer` calls.  One buffer of C
rows (ts, a 64-bit key, group slot, columns), its n alive rows at [0, n),
and three modes:

  * `externalTime(attr, t)` (`ExternalTimeWindow.process`, :83): the key
    is the row's event time `ets` (the attribute).  The clock is
    `ext_now`, the largest ets of the step's arrivals; a step without one
    expires nothing, and the window has no timer.  Rows (buffer first,
    then arrivals) with ets + t <= ext_now come out EXPIRED with ts =
    ets + t, ordered by 2*(ets + t); every arrival comes out CURRENT with
    its arrival ts, ordered by 2*ets + 1 (so an arrival more than t older
    than ext_now comes out CURRENT and EXPIRED in the same step); ties
    keep candidate order, and row r is numbered seq0 + r.  The buffer is
    kept sorted by (ets, candidate position): the survivors of the buffer
    and the surviving arrivals merge, the buffer's first on equal ets.
    When more than C survive, the oldest drop, as in the reference, and
    are counted in `missed` (the runtime raises).  The reference orders
    its survivors by the product `ets * (C + 2B) + pos`, which overflows
    past BIG_SEQ at epoch-millisecond event times and C + 2B above about
    1.3M (`siddhi_tpu/core/window_ext.py:124-127`); the port compares the
    pair (ets, position) and does not copy that.
  * `timeLength(t, n)` (`TimeLengthWindow.process`, :279, C = n): the key
    is expire_ts = ts + t, the rows lie in add_seq order.  Rows with
    expire_ts <= now come out EXPIRED at ts = expire_ts (key 4*expire_ts);
    arrival k of the step evicts survivor count0 + k - n (survivors in
    add_seq order, then the step's arrivals) as an EXPIRED row with the
    arrival's ts and the evicted row's columns (key 4*ts + 1), then comes
    out CURRENT (key 4*ts + 2); a stable sort of those keys in that
    candidate order numbers the rows.  The buffer keeps the last n of
    (survivors, arrivals in batch order); the arrivals it keeps enter in
    add_seq order (their CURRENT rows' order).  The wake is the least
    expire_ts alive.
  * `delay(t)` (`DelayWindow.process`, :375): the key is the release time
    ts + t.  Rows with release <= now come out CURRENT with their own ts,
    stably ordered by release time in candidate order; the others stay in
    candidate order; those past C drop, as in the reference, and are
    counted in `missed`.  The wake is the least pending release.

The seq counter advances by the rows emitted.  A step's output is exactly
its emitted rows (all valid).

`ext_window_step` is what the window processors call: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls`
count them, `mode_launches` the launches by mode; `reset_counts()` sets
them to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows
from . import _nvcc

launches = 0
plain_calls = 0
mode_launches = [0, 0, 0]

MODE_EXT, MODE_TLEN, MODE_DELAY = 0, 1, 2
MAX_COLS, BLOCK, SCAN_BLOCK = 16, 256, 1024
RADIX, RADIX_TILE = 256, 2048
# meta words: alive rows, seq counter, rows dropped over the window's life
N, SEQ, MISSED = range(3)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0, 0]


class ExtState:
    """One K16 window's buffer: C rows of (ts, key, gslot, columns), the
    alive ones at [0, meta[N])."""

    def __init__(self, mode, ts, key, gslot, cols, meta):
        self.mode = mode
        self.ts, self.key, self.gslot = ts, key, gslot
        self.cols, self.meta = tuple(cols), meta

    @property
    def C(self) -> int:
        return self.ts.shape[0]

    @classmethod
    def empty(cls, mode: int, schema: ev.Schema, C: int,
              device) -> "ExtState":
        def z(d):
            return torch.zeros(C, dtype=d, device=device)
        return cls(mode, z(torch.int64), z(torch.int64), z(torch.int32),
                   [z(d) for d in schema.dtypes],
                   torch.zeros(4, dtype=torch.int64, device=device))

    def tensors(self):
        return [self.ts, self.key, self.gslot, *self.cols, self.meta]

    def clone(self) -> "ExtState":
        return ExtState(self.mode, self.ts.clone(), self.key.clone(),
                        self.gslot.clone(), [c.clone() for c in self.cols],
                        self.meta.clone())

    def copy_from(self, other: "ExtState") -> None:
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)

    def alive(self) -> dict:
        """The alive rows in buffer order and the counters (host read)."""
        n, seq, missed = (int(x) for x in self.meta[:3].tolist())
        out = {"ts": self.ts[:n], "key": self.key[:n],
               "gslot": self.gslot[:n], "seq": seq, "missed": missed}
        for j, c in enumerate(self.cols):
            out[f"col{j}"] = c[:n]
        return out


def ext_window_step(st: ExtState, arr: Rows, n_arr, now: int, t: int,
                    length: int = 0, ets=None):
    """One step: `arr` are the batch's arrivals compacted to the front
    (filter_compact's output), `n_arr` their count (i64[1]); `ets` the
    arrivals' event times as an int64 column (externalTime); `length` the
    timeLength window's n.  Moves `st` in place; returns (Rows of exactly
    the emitted rows, i64[2] [wake, rows dropped])."""
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, now, t, length, ets)
    return plain(st, arr, n_arr, now, t, length, ets)


# ---------------------------------------------------------------------------
# the plain version: the reference's steps over the compacted arrivals
# ---------------------------------------------------------------------------

def _emit(dev, ts, kind, seq, gslot, cols) -> Rows:
    n = ts.shape[0]
    return Rows(ts=ts, kind=torch.full((n,), kind, dtype=torch.int32,
                                       device=dev),
                valid=torch.ones(n, dtype=torch.bool, device=dev), seq=seq,
                gslot=gslot, cols=tuple(cols))


def _cat_rows(parts, order) -> Rows:
    """Concatenate row blocks and take them in `order`."""
    def cat(i):
        return torch.cat([p[i] for p in parts])[order]
    return Rows(ts=cat(0), kind=cat(1), valid=cat(2), seq=cat(3),
                gslot=cat(4), cols=tuple(torch.cat([p.cols[j] for p in parts])
                                         [order]
                                         for j in range(len(parts[0].cols))))


def _rank_order(keys):
    """(stable sort order of `keys`, each element's rank)."""
    order = torch.argsort(keys, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(keys.shape[0], device=keys.device)
    return order, rank


def _store(st: ExtState, ts, key, gslot, cols, missed: int, seq: int):
    n = ts.shape[0]
    st.ts[:n], st.key[:n], st.gslot[:n] = ts, key, gslot
    for d, s in zip(st.cols, cols):
        d[:n] = s
    m = st.meta.tolist()
    st.meta.copy_(torch.tensor([n, seq, m[MISSED] + missed, 0],
                               dtype=torch.int64))


def plain(st: ExtState, arr: Rows, n_arr, now: int, t: int, length: int = 0,
          ets=None):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = st.ts.device
    n, seq0 = (int(x) for x in st.meta[:2].tolist())
    na = int(n_arr)
    b_ts, b_key, b_gs = st.ts[:n], st.key[:n], st.gslot[:n]
    b_cols = [c[:n] for c in st.cols]
    a_ts, a_gs = arr.ts[:na], arr.gslot[:na]
    a_cols = [c[:na] for c in arr.cols]
    i64 = torch.int64
    if st.mode == MODE_EXT:
        a_ets = ets[:na].to(i64)
        ext_now = int(a_ets.max()) if na else None
        c_ets = torch.cat([b_key, a_ets])
        due = c_ets + t <= ext_now if na else torch.zeros_like(
            c_ets, dtype=torch.bool)
        c_ts, c_gs = torch.cat([b_ts, a_ts]), torch.cat([b_gs, a_gs])
        c_cols = [torch.cat([b, a]) for b, a in zip(b_cols, a_cols)]
        d = torch.nonzero(due).flatten()
        keys = torch.cat([2 * (c_ets[d] + t), 2 * a_ets + 1])
        order, _ = _rank_order(keys)
        nem = keys.shape[0]
        seqs = seq0 + torch.arange(nem, device=dev)
        parts = [_emit(dev, c_ets[d] + t, ev.EXPIRED, seqs[:d.shape[0]],
                       c_gs[d], [c[d] for c in c_cols]),
                 _emit(dev, a_ts, ev.CURRENT, seqs[d.shape[0]:], a_gs,
                       a_cols)]
        out = _cat_rows(parts, order)
        out = out._replace(seq=seqs)
        # survivors by (ets, candidate position); the oldest beyond C drop
        k = torch.nonzero(torch.logical_not(due)).flatten()
        k = k[torch.argsort(c_ets[k], stable=True)]
        drop = max(k.shape[0] - st.C, 0)
        k = k[drop:]
        _store(st, c_ts[k], c_ets[k], c_gs[k], [c[k] for c in c_cols], drop,
               seq0 + nem)
        return out, torch.tensor([NO_WAKEUP, drop], dtype=i64, device=dev)
    if st.mode == MODE_TLEN:
        due = b_key <= now
        surv = torch.nonzero(torch.logical_not(due)).flatten()
        count0 = surv.shape[0]
        k = torch.arange(na, device=dev)
        evict = count0 + k - length
        has = evict >= 0
        v = evict[has]

        def evicted(b, a):
            # the survivors in add_seq order, then the arrivals
            return torch.cat([b[surv], a])[v]
        d = torch.nonzero(due).flatten()
        keys = torch.cat([4 * b_key[d], 4 * a_ts[has] + 1, 4 * a_ts + 2])
        order, rank = _rank_order(keys)
        nd, nv = d.shape[0], int(has.sum())
        seqs = seq0 + torch.arange(keys.shape[0], device=dev)
        parts = [_emit(dev, b_key[d], ev.EXPIRED, seqs[:nd], b_gs[d],
                       [c[d] for c in b_cols]),
                 _emit(dev, a_ts[has], ev.EXPIRED, seqs[nd:nd + nv],
                       evicted(b_gs, a_gs),
                       [evicted(b, a) for b, a in zip(b_cols, a_cols)]),
                 _emit(dev, a_ts, ev.CURRENT, seqs[nd + nv:], a_gs, a_cols)]
        out = _cat_rows(parts, order)._replace(seq=seqs)
        # the last n of (survivors, arrivals); kept arrivals in add_seq
        # (CURRENT rank) order
        total = count0 + na
        start = max(total - length, 0)
        ks = surv[min(start, count0):]
        a_keep = k >= start - count0
        a_rank = rank[nd + nv:]
        ka = torch.nonzero(a_keep).flatten()
        ka = ka[torch.argsort(a_rank[ka])]
        n_ts = torch.cat([b_ts[ks], a_ts[ka]])
        n_key = torch.cat([b_key[ks], a_ts[ka] + t])
        _store(st, n_ts, n_key, torch.cat([b_gs[ks], a_gs[ka]]),
               [torch.cat([b[ks], a[ka]]) for b, a in zip(b_cols, a_cols)],
               0, seq0 + keys.shape[0])
        wake = int(n_key.min()) if n_key.shape[0] else NO_WAKEUP
        return out, torch.tensor([wake, 0], dtype=i64, device=dev)
    # delay
    c_ts, c_gs = torch.cat([b_ts, a_ts]), torch.cat([b_gs, a_gs])
    c_rel = torch.cat([b_key, a_ts + t])
    c_cols = [torch.cat([b, a]) for b, a in zip(b_cols, a_cols)]
    rel = c_rel <= now
    r = torch.nonzero(rel).flatten()
    r = r[torch.argsort(c_rel[r], stable=True)]
    nr = r.shape[0]
    out = _emit(dev, c_ts[r], ev.CURRENT,
                seq0 + torch.arange(nr, device=dev), c_gs[r],
                [c[r] for c in c_cols])
    k = torch.nonzero(torch.logical_not(rel)).flatten()
    drop = max(k.shape[0] - st.C, 0)       # kept rows past C drop
    k = k[:st.C]
    _store(st, c_ts[k], c_rel[k], c_gs[k], [c[k] for c in c_cols], drop,
           seq0 + nr)
    wake = int(c_rel[k].min()) if k.shape[0] else NO_WAKEUP
    return out, torch.tensor([wake, drop], dtype=i64, device=dev)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class ExtPlan(ctypes.Structure):
    """Mirrors `struct ExtPlan` in csrc/ext_window.cu."""
    _fields_ = (
        [(n, _L) for n in ("C", "A", "t", "now", "length", "cap")] +
        [("mode", _I), ("ncols", _I), ("col_bytes", _I * MAX_COLS),
         ("b_ts", _P), ("b_key", _P), ("b_gslot", _P),
         ("b_col", _P * MAX_COLS),
         ("n_ts", _P), ("n_key", _P), ("n_gslot", _P),
         ("n_col", _P * MAX_COLS), ("meta", _P),
         ("a_ts", _P), ("a_ets", _P), ("a_gslot", _P),
         ("a_col", _P * MAX_COLS), ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS), ("wake", _P),
         ("scal", _P), ("block_sums", _P), ("list", _P),
         ("s_key", _P), ("r_key", _P * 2), ("r_idx", _P * 2),
         ("r_hist", _P), ("r_hist_sums", _P)])


# scal words the prepare launch leaves for the write launch and the host
S_NOUT = 0


def _pow_tiles(n: int) -> int:
    return (n + RADIX_TILE - 1) // RADIX_TILE


def prepare(st: ExtState, arr: Rows, n_arr, now: int, t: int,
            length: int = 0, ets=None):
    """Check the inputs and fill a plan with the state, the arrivals and
    the scratch; returns (plan, the tensors the launches read, which stay
    referenced until both are queued: "scal"[S_NOUT] is the output row
    count after the prepare launch, "wake" the step's i64[2])."""
    dev = st.ts.device
    C, A = st.C, int(arr.ts.shape[0])
    for x, d, name in ((arr.ts, torch.int64, "ts"),
                       (arr.gslot, torch.int32, "gslot"),
                       (n_arr, torch.int64, "n_arr")):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError(f"ext_window: arrival {name} must be a "
                             f"contiguous {d} tensor on {dev}")
    if len(st.cols) > MAX_COLS or len(arr.cols) != len(st.cols):
        raise ValueError("ext_window: column count")
    pl = ExtPlan()
    pl.C, pl.A, pl.t, pl.now, pl.length = C, A, int(t), int(now), \
        int(length)
    pl.mode, pl.ncols = st.mode, len(st.cols)
    keep = []
    if st.mode == MODE_EXT:
        if ets is None:
            raise ValueError("ext_window: externalTime needs the event "
                             "times")
        ets = ets.to(torch.int64).contiguous()
        if ets.device != dev or ets.shape[0] != A:
            raise ValueError("ext_window: event-time column")
        keep.append(ets)
        pl.a_ets = ets.data_ptr()

    def e(n, d=torch.int64):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    new = ExtState(st.mode, e(C), e(C), e(C, torch.int32),
                   [e(C, c.dtype) for c in st.cols], st.meta)
    for j, (bc, ac) in enumerate(zip(st.cols, arr.cols)):
        if ac.dtype != bc.dtype or not ac.is_contiguous() or \
                ac.device != dev:
            raise ValueError(f"ext_window: arrival column {j} dtype")
        pl.col_bytes[j] = bc.element_size()
        pl.b_col[j], pl.n_col[j] = bc.data_ptr(), new.cols[j].data_ptr()
        pl.a_col[j] = ac.data_ptr()
    pl.b_ts, pl.b_key, pl.b_gslot = st.ts.data_ptr(), st.key.data_ptr(), \
        st.gslot.data_ptr()
    pl.n_ts, pl.n_key, pl.n_gslot = new.ts.data_ptr(), new.key.data_ptr(), \
        new.gslot.data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), n_arr.data_ptr()
    # scratch: candidates are the C buffer rows and the A arrivals; the
    # emission items at most C + 2A
    M = C + 2 * A
    nb = (M + BLOCK - 1) // BLOCK
    scal = torch.zeros(16, dtype=torch.int64, device=dev)
    wake = e(2)
    block_sums = e(nb + 1)
    lst, s_key = e(C + A, torch.int32), e(A)
    r_key = [e(M), e(M)]
    r_idx = [e(M, torch.int32), e(M, torch.int32)]
    tiles = _pow_tiles(M)
    r_hist = e(RADIX * tiles)
    r_hist_sums = e((RADIX * tiles + SCAN_BLOCK - 1) // SCAN_BLOCK + 1)
    pl.wake, pl.scal = wake.data_ptr(), scal.data_ptr()
    pl.block_sums = block_sums.data_ptr()
    pl.list, pl.s_key = lst.data_ptr(), s_key.data_ptr()
    for b in range(2):
        pl.r_key[b], pl.r_idx[b] = r_key[b].data_ptr(), r_idx[b].data_ptr()
    pl.r_hist, pl.r_hist_sums = r_hist.data_ptr(), r_hist_sums.data_ptr()
    bufs = {"keep": keep, "scal": scal, "wake": wake, "new": new,
            "scratch": (block_sums, lst, s_key, *r_key, *r_idx,
                        r_hist, r_hist_sums),
            "inputs": arr}
    return pl, bufs


def alloc_out(pl: ExtPlan, st: ExtState, n: int, dev) -> Rows:
    def e(d):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=None,
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(c.dtype) for c in st.cols))
    pl.cap = n
    pl.out_ts, pl.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    for j, c in enumerate(out.cols):
        pl.out_col[j] = c.data_ptr()
    return out


def _call(entry: str, pl: ExtPlan, dev) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("ext_window", entry, "siddhi_ext_plan_size", pl,
                      stream)


def launch(st: ExtState, arr: Rows, n_arr, now: int, t: int,
           length: int = 0, ets=None, n_out=None):
    """The prepare launch, one fetch of the output row count (it sizes
    the output; `n_out`, when the caller knows it, skips the fetch), the
    write launch; the new buffer then replaces the old one."""
    global launches
    dev = st.ts.device
    pl, bufs = prepare(st, arr, n_arr, now, t, length, ets)
    _call("siddhi_ext_prepare", pl, dev)
    n = int(bufs["scal"][S_NOUT]) if n_out is None else n_out
    out = alloc_out(pl, st, n, dev)
    _call("siddhi_ext_write", pl, dev)
    new = bufs["new"]
    st.ts, st.key, st.gslot, st.cols = new.ts, new.key, new.gslot, new.cols
    launches += 1
    mode_launches[st.mode] += 1
    wake = bufs["wake"]
    del bufs
    return Rows(ts=out.ts[:n], kind=out.kind[:n],
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=out.seq[:n], gslot=out.gslot[:n],
                cols=tuple(c[:n] for c in out.cols)), wake
