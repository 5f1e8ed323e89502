"""State, wrapper and plain version of the `sort_window` CUDA kernel (K17).

The kernel (`siddhi_tpu_torch/csrc/sort_window.cu`) replaces the JAX
package's `SortWindow.process` (`siddhi_tpu/core/window_ext.py:496`), the
window `sort(n, attr[, 'asc'|'desc'])` that keeps the n rows with the
least key (the greatest under 'desc').  Its candidates are the C buffer
rows, then the batch's B rows; a dead candidate (a free buffer row, a
batch row that is not a valid CURRENT arrival that passes the filters) is
keyed +inf (float keys) or BIG_SEQ (integer keys).  A float key compares
as float64 with -0 equal to 0 and every NaN equal and above +inf, as the
reference's sort orders them; 'desc' negates the key in the column's own
type first (an integer null, INT_MIN or LONG_MIN, wraps to itself).  A
candidate's rank is its place in the stable sort of all C + B keys (so a
dead candidate ranks before an alive one of the same key when its position
is lower); an alive one is kept when its rank is below min(alive, n) and
evicted otherwise.  Output, numbered from the step's seq0: every arrival
CURRENT in batch order (seq0 + k), then the evicted rows EXPIRED with
their own ts in candidate order (seq0 + arrivals + rank among them).  The
buffer keeps the survivors in candidate order; the seq counter advances
by the rows emitted.

The arrivals come compacted (filter_compact's output); their input
positions, which place the dead batch rows, ride in their `seq` (the
filter's index mode).  State (`SortState`): the buffer of C = n rows (ts,
group slot, columns), its alive rows at [0, meta[0]), and the seq counter
in meta[1].

`sort_window_step` is what `SortWindow.process` calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls`
count them; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import BIG_SEQ, Rows
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS, BLOCK, SCAN_BLOCK = 16, 256, 1024
RADIX, RADIX_TILE = 256, 2048
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
KT_I32, KT_I64, KT_F32, KT_BOOL = range(4)
_FLIP = 0x7fffffffffffffff
# the dead candidates' keys: +inf's float64 bits, BIG_SEQ
DEAD_FLOAT, DEAD_INT = 0x7ff0000000000000, BIG_SEQ


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class SortState:
    """A sort window's buffer: C rows of (ts, gslot, columns), the alive
    ones at [0, meta[0]), the seq counter in meta[1]."""

    def __init__(self, ts, gslot, cols, meta):
        self.ts, self.gslot, self.cols, self.meta = ts, gslot, tuple(cols), \
            meta

    @property
    def C(self) -> int:
        return self.ts.shape[0]

    @classmethod
    def empty(cls, schema: ev.Schema, C: int, device) -> "SortState":
        def z(d):
            return torch.zeros(C, dtype=d, device=device)
        return cls(z(torch.int64), z(torch.int32),
                   [z(d) for d in schema.dtypes],
                   torch.zeros(2, dtype=torch.int64, device=device))

    def tensors(self):
        return [self.ts, self.gslot, *self.cols, self.meta]

    def clone(self) -> "SortState":
        return SortState(self.ts.clone(), self.gslot.clone(),
                         [c.clone() for c in self.cols], self.meta.clone())

    def copy_from(self, other: "SortState") -> None:
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)


def key_type(dtype: torch.dtype) -> int:
    return {torch.int32: KT_I32, torch.int64: KT_I64,
            torch.float32: KT_F32, torch.bool: KT_BOOL}[dtype]


def sort_keys(col, desc: bool):
    """The keys of a column as int64 whose signed order is the reference's
    sort order (see the module docstring)."""
    if col.dtype.is_floating_point:
        x = -col if desc else col
        x = x.to(torch.float64)
        x = torch.where(x == 0, torch.zeros_like(x), x)
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        b = x.view(torch.int64)
        return torch.where(b < 0, b ^ _FLIP, b)
    x = col.to(torch.int64) if col.dtype == torch.bool else col
    return (-x if desc else x).to(torch.int64)


def sort_window_step(st: SortState, arr: Rows, n_arr, length: int,
                     key_pos: int, desc: bool, B: int):
    """One step: `arr` are the arrivals compacted to the front with their
    input positions in `seq` (filter_compact without a counter), `n_arr`
    their count (i64[1]); `B` the batch's capacity.  Moves `st` in place;
    returns the Rows of exactly the emitted rows."""
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, length, key_pos, desc, B)
    return plain(st, arr, n_arr, length, key_pos, desc, B)


def plain(st: SortState, arr: Rows, n_arr, length: int, key_pos: int,
          desc: bool, B: int):
    """The plain PyTorch version (the kernel's reference): the reference's
    stable sort over all C + B candidates, dead ones included."""
    global plain_calls
    plain_calls += 1
    dev = st.ts.device
    C = st.C
    n, seq0 = (int(x) for x in st.meta.tolist())
    na = int(n_arr)
    kc = torch.cat([st.cols[key_pos][:n], arr.cols[key_pos][:na]])
    keys = sort_keys(kc, desc)
    dead = DEAD_FLOAT if kc.dtype.is_floating_point else DEAD_INT
    pos = torch.cat([torch.arange(n, device=dev), C + arr.seq[:na]])
    full = torch.full((C + B,), dead, dtype=torch.int64, device=dev)
    full[pos] = keys
    order = torch.argsort(full, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C + B, device=dev)
    total = n + na
    keep = rank[pos] < min(total, length)
    ev_idx = torch.nonzero(torch.logical_not(keep)).flatten()
    k_idx = torch.nonzero(keep).flatten()
    c_ts = torch.cat([st.ts[:n], arr.ts[:na]])
    c_gs = torch.cat([st.gslot[:n], arr.gslot[:na]])
    c_cols = [torch.cat([b[:n], a[:na]]) for b, a in zip(st.cols, arr.cols)]
    nev = ev_idx.shape[0]

    def full_kind(m, k):
        return torch.full((m,), k, dtype=torch.int32, device=dev)
    out = Rows(
        ts=torch.cat([arr.ts[:na], c_ts[ev_idx]]),
        kind=torch.cat([full_kind(na, ev.CURRENT),
                        full_kind(nev, ev.EXPIRED)]),
        valid=torch.ones(na + nev, dtype=torch.bool, device=dev),
        seq=seq0 + torch.arange(na + nev, device=dev),
        gslot=torch.cat([arr.gslot[:na], c_gs[ev_idx]]),
        cols=tuple(torch.cat([a[:na], c[ev_idx]])
                   for a, c in zip(arr.cols, c_cols)))
    nk = k_idx.shape[0]
    st.ts[:nk], st.gslot[:nk] = c_ts[k_idx], c_gs[k_idx]
    for d, c in zip(st.cols, c_cols):
        d[:nk] = c[k_idx]
    st.meta.copy_(torch.tensor([nk, seq0 + na + nev], dtype=torch.int64))
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class SortPlan(ctypes.Structure):
    """Mirrors `struct SortPlan` in csrc/sort_window.cu."""
    _fields_ = (
        [(n, _L) for n in ("C", "A", "B", "length", "cap", "dead")] +
        [("ncols", _I), ("key_col", _I), ("key_type", _I), ("desc", _I),
         ("col_bytes", _I * MAX_COLS),
         ("b_ts", _P), ("b_gslot", _P), ("b_col", _P * MAX_COLS),
         ("n_ts", _P), ("n_gslot", _P), ("n_col", _P * MAX_COLS),
         ("meta", _P), ("a_ts", _P), ("a_gslot", _P),
         ("a_col", _P * MAX_COLS), ("a_pos", _P), ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("scal", _P), ("keep", _P), ("block_sums", _P),
         ("r_key", _P * 2), ("r_idx", _P * 2), ("r_hist", _P),
         ("r_hist_sums", _P)])


S_NOUT = 0


def prepare(st: SortState, arr: Rows, n_arr, length: int, key_pos: int,
            desc: bool, B: int):
    """Check the inputs and fill a plan; returns (plan, the tensors the
    launches read: "scal"[S_NOUT] is the output row count after the
    prepare launch, "new" the buffer the write launch fills)."""
    dev = st.ts.device
    C, A = st.C, int(arr.ts.shape[0])
    for x, d, name in ((arr.ts, torch.int64, "ts"), (arr.seq, torch.int64,
                                                     "seq"),
                       (arr.gslot, torch.int32, "gslot"),
                       (n_arr, torch.int64, "n_arr")):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError(f"sort_window: arrival {name} must be a "
                             f"contiguous {d} tensor on {dev}")
    if len(st.cols) > MAX_COLS or len(arr.cols) != len(st.cols):
        raise ValueError("sort_window: column count")
    kdt = st.cols[key_pos].dtype
    pl = SortPlan()
    pl.C, pl.A, pl.B, pl.length = C, A, int(B), int(length)
    pl.dead = DEAD_FLOAT if kdt.is_floating_point else DEAD_INT
    pl.ncols, pl.key_col, pl.key_type, pl.desc = len(st.cols), key_pos, \
        key_type(kdt), int(desc)

    def e(n, d=torch.int64):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    new = SortState(e(C), e(C, torch.int32), [e(C, c.dtype)
                                              for c in st.cols], st.meta)
    for j, (bc, ac) in enumerate(zip(st.cols, arr.cols)):
        if ac.dtype != bc.dtype or not ac.is_contiguous() or \
                ac.device != dev:
            raise ValueError(f"sort_window: arrival column {j} dtype")
        pl.col_bytes[j] = bc.element_size()
        pl.b_col[j], pl.n_col[j] = bc.data_ptr(), new.cols[j].data_ptr()
        pl.a_col[j] = ac.data_ptr()
    pl.b_ts, pl.b_gslot = st.ts.data_ptr(), st.gslot.data_ptr()
    pl.n_ts, pl.n_gslot = new.ts.data_ptr(), new.gslot.data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot, pl.a_pos, pl.n_arr = arr.ts.data_ptr(), \
        arr.gslot.data_ptr(), arr.seq.data_ptr(), n_arr.data_ptr()
    M = C + A
    nb = (M + BLOCK - 1) // BLOCK
    tiles = (M + RADIX_TILE - 1) // RADIX_TILE
    scal = torch.zeros(8, dtype=torch.int64, device=dev)
    keep = e(M, torch.uint8)
    block_sums = e(nb + 1)
    r_key, r_idx = [e(M), e(M)], [e(M, torch.int32), e(M, torch.int32)]
    r_hist = e(RADIX * tiles)
    r_hist_sums = e((RADIX * tiles + SCAN_BLOCK - 1) // SCAN_BLOCK + 1)
    pl.scal, pl.keep, pl.block_sums = scal.data_ptr(), keep.data_ptr(), \
        block_sums.data_ptr()
    for b in range(2):
        pl.r_key[b], pl.r_idx[b] = r_key[b].data_ptr(), r_idx[b].data_ptr()
    pl.r_hist, pl.r_hist_sums = r_hist.data_ptr(), r_hist_sums.data_ptr()
    bufs = {"scal": scal, "new": new,
            "scratch": (keep, block_sums, *r_key, *r_idx, r_hist,
                        r_hist_sums), "inputs": arr}
    return pl, bufs


def _call(entry: str, pl: SortPlan, dev) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("sort_window", entry, "siddhi_sort_plan_size", pl,
                      stream)


def launch(st: SortState, arr: Rows, n_arr, length: int, key_pos: int,
           desc: bool, B: int, n_out=None):
    """The prepare launch, one fetch of the output row count (skipped
    when the caller gives `n_out`), the write launch; the new buffer then
    replaces the old one."""
    global launches
    dev = st.ts.device
    pl, bufs = prepare(st, arr, n_arr, length, key_pos, desc, B)
    _call("siddhi_sort_prepare", pl, dev)
    n = int(bufs["scal"][S_NOUT]) if n_out is None else n_out

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
    _call("siddhi_sort_write", pl, dev)
    new = bufs["new"]
    st.ts, st.gslot, st.cols = new.ts, new.gslot, new.cols
    launches += 1
    del bufs
    return Rows(ts=out.ts[:n], kind=out.kind[:n],
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=out.seq[:n], gslot=out.gslot[:n],
                cols=tuple(c[:n] for c in out.cols))
