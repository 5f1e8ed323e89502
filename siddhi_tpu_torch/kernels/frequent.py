"""State, wrapper and plain version of the `frequent` CUDA kernel (K19).

The kernel (`siddhi_tpu_torch/csrc/frequent.cu`) replaces the JAX
package's `FrequentWindow.process` (`siddhi_tpu/core/window_ext.py:1023`,
a `lax.scan` over the batch and a [B, n + 1] output grid sorted by seq),
the Misra-Gries window under `frequent(n[, attrs])` and
`lossyFrequent(support[, error][, attrs])` (n = max(int(1 / support),
1)).  n counters each hold a count (0: free), a key and the latest event
of that key.  Each arrival, in batch order, takes the first case that
holds:
  * hit (a counter with count > 0 holds its key): count + 1; the stored
    event comes out EXPIRED and the arrival replaces it;
  * a free counter (the lowest-indexed one): count 1, the arrival stored;
  * a full miss: every count - 1; each counter that reaches 0 comes out
    EXPIRED (in counter order); the arrival is not emitted.
A hit or an insert then emits the arrival CURRENT.  An EXPIRED row carries
the arrival's ts and the stored event's group slot and columns; arrival
i of the batch (its input row, `arr.seq`) numbers its counter j's row
`seq0 + i*(n+1) + j` and its CURRENT row `seq0 + i*(n+1) + n`, so the rows
come out in that order.  The counter advances by `B*(n+1)` a step (B the
batch's capacity).  A key is the tuple of the key columns (every column
when none is named), each as a 64-bit word: a float's bits as a float64
(so -0.0 and +0.0 differ, and NaNs differ by payload), an integer or an
interned string id as itself, a bool as 0 / 1.  A step emits at most
3A + n rows (A arrivals: A CURRENT, A replaced, n + A evictions); the
output is sized by that bound, and one fetch of the row count cuts it.

State (`FreqState`): counts i64[n], keys i64[n, K], the stored events'
ts i64[n], group slot i32[n] and columns, and `meta` = [seq].  Only the
counters with count > 0 are defined.

The kernel keeps the arrivals' order but resolves 32 at a time: one warp
of one block walks them against the counters in shared memory (device
memory when they do not fit), a hit found through an open-addressing hash
of the live keys, equal keys within a group matched by a warp vote, new
keys given the lowest free counters by rank, a full miss ending the group
there; producer warps stage the next tile's key words and hashes.  The
walk writes a small record an arrival; a grid over every SM then writes
the rows at the walk's offsets, and a last launch the stored events.  The
walk's chain of groups (about 2,200 at an FQ1 send) bounds it, not the
bytes.

`frequent_step` is what `FrequentWindow.process` calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls` count
them (one launch counts the kernel's three); `reset_counts()` sets them
to 0.
"""
from __future__ import annotations

import ctypes
import heapq

import numpy as np
import torch

from ..core import event as ev
from ..core.window import Rows
from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS = 16
# the walk's staged tile of arrivals (csrc/frequent.cu TILE) and the
# block's dynamic shared memory at most (the H100's less the static)
TILE = 512
SMEM_MAX = 232448 - 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# the kernel's column type codes
_TY = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
       torch.bool: 4}


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class FreqState:
    """The n counters of a frequent window (see the module docstring)."""

    def __init__(self, counts, keys, ts, gslot, cols, meta):
        self.counts, self.keys = counts, keys
        self.ts, self.gslot, self.cols = ts, gslot, tuple(cols)
        self.meta = meta

    @property
    def n(self) -> int:
        return self.counts.shape[0]

    @classmethod
    def empty(cls, schema: ev.Schema, n: int, nkeys: int,
              device) -> "FreqState":
        return cls(torch.zeros(n, dtype=torch.int64, device=device),
                   torch.zeros((n, nkeys), dtype=torch.int64, device=device),
                   torch.zeros(n, dtype=torch.int64, device=device),
                   torch.full((n,), -1, dtype=torch.int32, device=device),
                   [torch.full((n,), ev.default_value(t), dtype=d,
                               device=device)
                    for t, d in zip(schema.types, schema.dtypes)],
                   torch.zeros(1, dtype=torch.int64, device=device))

    def tensors(self):
        return [self.counts, self.keys, self.ts, self.gslot, *self.cols,
                self.meta]

    def clone(self) -> "FreqState":
        return FreqState(*(x.clone() for x in (self.counts, self.keys,
                                               self.ts, self.gslot)),
                         [c.clone() for c in self.cols], self.meta.clone())

    def copy_from(self, other: "FreqState") -> None:
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)

    def alive(self) -> dict:
        """The counters in use, their keys and stored events, and the
        counter (host read)."""
        live = self.counts > 0
        out = {"counts": self.counts, "keys": self.keys[live],
               "ts": self.ts[live], "gslot": self.gslot[live],
               "seq": int(self.meta[0])}
        for j, c in enumerate(self.cols):
            out[f"col{j}"] = c[live]
        return out


def key_words(col) -> torch.Tensor:
    """A key column as 64-bit words: a float's float64 bits, an integer or
    a bool as itself."""
    if col.dtype in (torch.float32, torch.float64):
        return col.to(torch.float64).view(torch.int64)
    return col.to(torch.int64)


def frequent_step(st: FreqState, arr: Rows, n_arr, key_pos):
    """One step: `arr` are the batch's arrivals compacted to the front
    (filter_compact's output, `arr.seq` each arrival's input row), `n_arr`
    their count (i64[1]), `key_pos` the key columns.  Moves `st` in place;
    returns Rows of exactly the emitted rows."""
    if arr.ts.is_cuda:
        return launch(st, arr, n_arr, key_pos)
    return plain(st, arr, n_arr, key_pos)


def plain(st: FreqState, arr: Rows, n_arr, key_pos):
    """The plain version (the kernel's reference): the counters walked
    arrival by arrival on the host, a key's counter found through a map
    (the keys of the counters in use are distinct), the first free
    counter through a heap."""
    global plain_calls
    plain_calls += 1
    dev = st.counts.device
    n, B = st.n, int(arr.ts.shape[0])
    na = int(n_arr)
    seq0 = int(st.meta[0])
    counts = st.counts.cpu().numpy().copy()
    keys = st.keys.cpu().numpy().copy()
    a_key = torch.stack([key_words(arr.cols[p][:na]) for p in key_pos], 1) \
        .cpu().numpy() if na else np.zeros((0, len(key_pos)), np.int64)
    a_row = arr.seq[:na].cpu().numpy()
    slot = {tuple(keys[j]): j for j in range(n) if counts[j] > 0}
    free = [j for j in range(n) if counts[j] == 0]
    heapq.heapify(free)
    # the stored events: (source, index), source 0 = the state, 1 = arrival
    stored = [(0, j) for j in range(n)]
    # output rows: (seq, kind, ts source index, (source, index) of the row)
    rows = []
    for q in range(na):
        k = tuple(a_key[q])
        base = seq0 + int(a_row[q]) * (n + 1)
        j = slot.get(k)
        if j is not None:
            counts[j] += 1
            rows.append((base + j, ev.EXPIRED, q, stored[j]))
        elif free:
            j = heapq.heappop(free)
            counts[j] = 1
            keys[j] = a_key[q]
            slot[k] = j
        else:
            counts -= 1
            for e in np.nonzero(counts == 0)[0].tolist():
                rows.append((base + e, ev.EXPIRED, q, stored[e]))
                del slot[tuple(keys[e])]
                heapq.heappush(free, e)
            continue
        stored[j] = (1, q)
        rows.append((base + n, ev.CURRENT, q, (1, q)))
    m = len(rows)
    src = torch.tensor([r[3][0] == 1 for r in rows], dtype=torch.bool)
    idx = torch.tensor([r[3][1] for r in rows], dtype=torch.int64)
    at = torch.tensor([r[2] for r in rows], dtype=torch.int64)

    def pick(s_col, a_col):
        """Each row's value: the arrival's or the stored event's."""
        if m == 0:
            return s_col[:0]
        s_col, a_col = s_col.cpu(), a_col[:na].cpu()
        return torch.where(src, a_col[torch.where(src, idx, 0)],
                           s_col[torch.where(src, 0, idx)]).to(dev)
    out = Rows(
        ts=arr.ts[:na].cpu()[at].to(dev) if m else arr.ts[:0],
        kind=torch.tensor([r[1] for r in rows], dtype=torch.int32,
                          device=dev),
        valid=torch.ones(m, dtype=torch.bool, device=dev),
        seq=torch.tensor([r[0] for r in rows], dtype=torch.int64,
                         device=dev),
        gslot=pick(st.gslot, arr.gslot),
        cols=tuple(pick(s, a) for s, a in zip(st.cols, arr.cols)))
    # the stored events after the step
    for j in range(n):
        s, i = stored[j]
        if s == 1:
            st.ts[j] = arr.ts[i]
            st.gslot[j] = arr.gslot[i]
            for sc, ac in zip(st.cols, arr.cols):
                sc[j] = ac[i]
    st.counts.copy_(torch.from_numpy(counts))
    st.keys.copy_(torch.from_numpy(keys))
    st.meta[0] = seq0 + B * (n + 1)
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class FreqPlan(ctypes.Structure):
    """Mirrors `struct FreqPlan` in csrc/frequent.cu."""
    _fields_ = (
        [(n, _L) for n in ("n", "B", "cap")] +
        [("ncols", _I), ("nkeys", _I), ("shared", _I), ("hbits", _I),
         ("smem", _I), ("pad", _I),
         ("col_bytes", _I * MAX_COLS), ("key_col", _I * MAX_COLS),
         ("key_ty", _I * MAX_COLS),
         ("counts", _P), ("keys", _P), ("s_ts", _P), ("s_gslot", _P),
         ("s_col", _P * MAX_COLS), ("meta", _P),
         ("a_ts", _P), ("a_gslot", _P), ("a_col", _P * MAX_COLS),
         ("a_row", _P), ("n_arr", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS), ("n_out", _P),
         ("g_tab", _P), ("g_src", _P), ("g_free", _P), ("rec", _P),
         ("evl", _P), ("n_ev", _P)])


def hash_bits(n: int) -> int:
    """log2 of the hash's slots: the least power of two >= 4n (at least
    64)."""
    return max(6, (4 * n - 1).bit_length())


def walk_smem(n: int, nkeys: int):
    """(counters in shared memory?, the walk's dynamic shared memory in
    bytes): the staged tiles' key words and hashes always; the counts,
    keys, hash, sources and free queue too when all fit."""
    stage = 2 * TILE * (8 * nkeys + 4)
    counters = 8 * n * (1 + nkeys) + 8 * (1 << hash_bits(n)) + 12 * n
    if stage + counters <= SMEM_MAX:
        return True, stage + counters
    return False, stage


def key_slot(words, n: int) -> np.ndarray:
    """Each key's first slot in the kernel's hash of n counters (`mix` /
    `fold` in csrc/frequent.cu) over i64 words [A, K]: for building keys
    that collide."""
    w = np.asarray(words, np.int64).view(np.uint64)
    h = np.full(w.shape[0], 0x9e3779b97f4a7c15, np.uint64)
    for k in range(w.shape[1]):
        h = (h ^ w[:, k]) * np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
    h = (h ^ (h >> np.uint64(32))) & np.uint64(0xffffffff)
    return (h & np.uint64((1 << hash_bits(n)) - 1)).astype(np.int64)


def launch(st: FreqState, arr: Rows, n_arr, key_pos, n_out: int = None):
    """Three launches (the walk, the rows, the stored events), one fetch
    of the row count (`n_out`, when the caller knows it, skips the fetch:
    CUDA-graph timing).  The output is sized by the bound 3A + n (A the
    batch's capacity, at least its arrivals)."""
    global launches
    dev = st.counts.device
    A = int(arr.ts.shape[0])
    for x, d, name in ((arr.ts, torch.int64, "ts"),
                       (arr.gslot, torch.int32, "gslot"),
                       (arr.seq, torch.int64, "seq"),
                       (n_arr, torch.int64, "n_arr")):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError(f"frequent: arrival {name} must be a "
                             f"contiguous {d} tensor on {dev}")
    if len(st.cols) > MAX_COLS or len(arr.cols) != len(st.cols) or \
            len(key_pos) != st.keys.shape[1] or not key_pos:
        raise ValueError("frequent: column or key count")
    n = st.n
    rows = 3 * A + n
    pl = FreqPlan()
    pl.n, pl.B, pl.cap = n, A, rows
    pl.ncols, pl.nkeys = len(st.cols), len(key_pos)
    shared, pl.smem = walk_smem(n, len(key_pos))
    pl.shared, pl.hbits = int(shared), hash_bits(n)

    def e(d, m=max(rows, 1)):
        return torch.empty(m, dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=None,
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(c.dtype) for c in st.cols))
    count = e(torch.int64, 1)
    for j, (sc, ac) in enumerate(zip(st.cols, arr.cols)):
        if ac.dtype != sc.dtype or not ac.is_contiguous() or \
                ac.device != dev:
            raise ValueError(f"frequent: arrival column {j} dtype")
        pl.col_bytes[j] = sc.element_size()
        pl.s_col[j], pl.a_col[j] = sc.data_ptr(), ac.data_ptr()
        pl.out_col[j] = out.cols[j].data_ptr()
    for j, p in enumerate(key_pos):
        pl.key_col[j], pl.key_ty[j] = p, _TY[st.cols[p].dtype]
    pl.counts, pl.keys = st.counts.data_ptr(), st.keys.data_ptr()
    pl.s_ts, pl.s_gslot = st.ts.data_ptr(), st.gslot.data_ptr()
    pl.meta = st.meta.data_ptr()
    pl.a_ts, pl.a_gslot = arr.ts.data_ptr(), arr.gslot.data_ptr()
    pl.a_row, pl.n_arr = arr.seq.data_ptr(), n_arr.data_ptr()
    pl.out_ts, pl.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    pl.n_out = count.data_ptr()
    # the walk's scratch: the hash and free queue (used when the counters
    # are in device memory), the sources, the records, the evictions
    i32 = torch.int32
    g_tab = e(torch.int64, 1 << pl.hbits) if not shared else None
    g_free = e(i32, 2 * n) if not shared else None
    g_src, rec = e(i32, n), e(i32, 3 * max(A, 1))
    evl, n_ev = e(i32, 4 * (n + A)), e(i32, 1)
    if g_tab is not None:
        pl.g_tab, pl.g_free = g_tab.data_ptr(), g_free.data_ptr()
    pl.g_src, pl.rec = g_src.data_ptr(), rec.data_ptr()
    pl.evl, pl.n_ev = evl.data_ptr(), n_ev.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("frequent", "siddhi_frequent", "siddhi_freq_plan_size",
                      pl, stream)
    launches += 1
    m = int(count) if n_out is None else n_out
    return Rows(ts=out.ts[:m], kind=out.kind[:m],
                valid=torch.ones(m, dtype=torch.bool, device=dev),
                seq=out.seq[:m], gslot=out.gslot[:m],
                cols=tuple(c[:m] for c in out.cols))
