"""Wrapper and plain version of the keyed frequent kernel K24 `keyed_freq`
(`siddhi_tpu_torch/csrc/keyed_freq.cu`): `frequent(n[, attrs])` and
`lossyFrequent(support[, error][, attrs])` kept once per partition key.

It replaces, in the JAX package's keyed step `kstep`
(`siddhi_tpu/core/planner.py:539-584`), the pre-window filters, the gather
of each key's events to [Kb, E], `FrequentWindow.process` /
`LossyFrequentWindow.process` (`siddhi_tpu/core/window_ext.py:1023`,
`:1103`) under `vmap` with B = E, the scatter back that drops padding keys
and the rows flattened key-major.  Each key keeps n counters (count 0:
free), each with a key and the latest event of that key; K19
(`kernels/frequent.py`) states the rules, which each key row applies to
its arrivals (its events that are valid CURRENT rows and pass the
filters) in batch order:
  * hit (a counter in use holds the arrival's key): count + 1; the stored
    event comes out EXPIRED and the arrival replaces it;
  * a free counter (the lowest-indexed one): count 1, the arrival stored;
  * a full miss: every count - 1; each counter that reaches 0 comes out
    EXPIRED (in counter order); the arrival is not emitted.
A hit or an insert then emits the arrival CURRENT.  An EXPIRED row carries
the arrival's ts and the stored event's group slot and columns.  The
arrival at column i of its key row (`sel`) numbers counter j's row
seq0 + i (n + 1) + j and its CURRENT row seq0 + i (n + 1) + n; the key's
counter advances by E (n + 1) a step.  A key is the tuple of the key
columns (every column when none is named), each a 64-bit word: a float's
float64 bits (so -0.0 and +0.0 differ, and NaNs differ by payload), an
integer or an interned string id as itself, a bool as 0 / 1.  Padding key
rows (`key_idx == K`) touch nothing.  No timer: the wake is always
[NO_WAKEUP, 0].

Slab: `keyed_window.KeyedSlab` in MODE_FREQ: per key the counts
`f_counts` [K, n], the key words `f_keys` [K, n, nk] and the stored
events in the main block [K, n] (in counter order; defined where the count
is above 0), and `seq`.

`keyed_freq_step` is what the keyed planner calls: CPU tensors run
`plain`, CUDA tensors launch the kernel.  `launches` / `plain_calls` count
the steps; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP
from . import _nvcc
from .filter_bytecode import type_code
from .frequent import key_words
from .in_probe import MAX_IN, InSet, fill_sets
from .keyed_ext import _Keys, _store_block
from .keyed_window import (MODE_FREQ, KeyedSlab, _wake, finish, no_wake,
                           record_key_offsets, slab_dtype)

launches = 0
plain_calls = 0

MAX_COLS, MAX_CODE, MAX_KEYS = 16, 256, 16
# warps a block runs (one key row each), and the shared memory a block's
# counters may take; past it they live in a global workspace
WARPS, SMEM_MAX = 4, 96 * 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


@dataclasses.dataclass(frozen=True)
class FreqParams:
    """A keyed frequent window's counters and key columns."""

    n: int
    key_pos: Tuple[int, ...]


def keyed_freq_step(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols,
                    key_idx, sel, now: int, prm: FreqParams,
                    tick: bool = False):
    """One keyed frequent step over the key rows `key_idx` [Kb] (K for a
    padding row) and their batch rows `sel` [Kb, E] (-1 for none).  Moves
    the slab in place; returns (Rows of exactly the emitted rows, i64[2]
    [NO_WAKEUP, 0])."""
    if ts.is_cuda:
        return launch(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                      sel, now, prm)
    return plain(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
                 now, prm)


def plain(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
          now: int, prm: FreqParams):
    """The plain PyTorch version (the kernel's reference): the reference's
    scan over a key row's arrivals, each arrival step batched over every
    key row, then the write back of the live key rows."""
    global plain_calls
    plain_calls += 1
    g = _Keys(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel, now)
    n, Kb, E, dev = prm.n, g.Kb, g.E, g.dev
    i64 = torch.int64
    k = g.kidx
    counts = slab.f_counts[k].clone()
    keys = slab.f_keys[k].clone()
    # each counter's stored event: -1 the slab's, else the arrival index
    src = torch.full((Kb, n), -1, dtype=i64, device=dev)
    o_ts, o_gs = slab.ts[k], slab.gslot[k]
    o_cols = [c[k] for c in slab.cols]
    a_key = torch.stack([key_words(g.cols[p]) for p in prm.key_pos], -1)
    jj = torch.arange(n, device=dev)[None, :]
    s0 = g.seq0[:, None]
    parts = []

    def stored(o, a, s):
        return torch.where(s >= 0, torch.gather(a, 1, s.clamp(min=0)), o)
    for q in range(E):
        act = g.valid[:, q]
        key = a_key[:, q]
        match = (counts > 0) & (keys == key[:, None, :]).all(-1)
        hit = match.any(1)
        midx = match.to(torch.int8).argmax(1)
        free = counts == 0
        has_free = free.any(1)
        fidx = free.to(torch.int8).argmax(1)
        ins = act & (hit | has_free)
        slot = torch.where(hit, midx, fidx)
        dec = act & ~(hit | has_free)
        onehot = jj == slot[:, None]
        exp = ((dec[:, None] & (counts == 1)) |
               ((hit & act)[:, None] & (jj == midx[:, None])))
        base = s0 + g.pos[:, q:q + 1] * (n + 1)
        parts.append((g.ts[:, q:q + 1].expand(Kb, n),
                      torch.full((Kb, n), ev.EXPIRED, dtype=torch.int32,
                                 device=dev), exp, base + jj,
                      stored(o_gs, g.gs, src),
                      [stored(o, a, src) for o, a in zip(o_cols, g.cols)]))
        parts.append(g.part(g.ts[:, q:q + 1], ev.CURRENT, ins[:, None],
                            base + n, g.gs[:, q:q + 1],
                            [c[:, q:q + 1] for c in g.cols]))
        counts = torch.where(dec[:, None], (counts - 1).clamp(min=0),
                             counts + (onehot & ins[:, None]).to(i64))
        put = onehot & ins[:, None]
        keys = torch.where(put[:, :, None], key[:, None, :], keys)
        src = torch.where(put, q, src)
    out = g.rows(parts) if parts else g.rows([g.part(
        g.ts[:, :0], ev.CURRENT, g.valid[:, :0], g.ts[:, :0], g.gs[:, :0],
        [c[:, :0] for c in g.cols])])
    new = [stored(o_ts, g.ts, src), stored(o_gs, g.gs, src),
           *(stored(o, a, src) for o, a in zip(o_cols, g.cols))]
    _store_block(g, slab, new, torch.zeros_like(g.cnt))
    g.store(slab.f_counts, counts)
    g.store(slab.f_keys, keys)
    g.store(slab.seq, g.seq0 + E * (n + 1))
    return out, _wake(NO_WAKEUP, 0, dev)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class KFreqPlan(ctypes.Structure):
    """Mirrors `struct KFreqPlan` in csrc/keyed_freq.cu."""
    _fields_ = (
        [(x, _L) for x in ("Kb", "E", "K", "n", "cap", "ws_words")] +
        [(x, _I) for x in ("nk", "ncols", "code_len", "ws_global")] +
        [("key_col", _I * MAX_KEYS), ("col_ty", _I * MAX_COLS),
         ("col_w", _I * MAX_COLS), ("code", _I * MAX_CODE),
         ("ts", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("col", _P * MAX_COLS), ("key_idx", _P), ("sel", _P),
         ("s_ts", _P), ("s_gslot", _P), ("s_col", _P * MAX_COLS),
         ("counts", _P), ("keys", _P), ("seq", _P),
         ("arr", _P), ("apos", _P), ("n_arr", _P), ("ocnt", _P),
         ("sums", _P), ("ws", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("in_sets", InSet * MAX_IN)])


def _check(x, name, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"keyed_freq: {name} must be a contiguous {list(shape)} {dtype} "
            f"tensor on {dev} (got {list(x.shape)} {x.dtype} on {x.device})")


def workspace_words(n: int, nk: int) -> int:
    """A key row's working copy of its counters: count, source and nk key
    words each."""
    return n * (2 + nk)


def prepare(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
            sel, prm: FreqParams):
    """Check the inputs and fill a plan; returns (plan, the tensors the
    launches read, which must stay referenced until both are queued)."""
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    dev = slab.ts.device
    B = ts.shape[0]
    Kb, E = sel.shape
    K, n, nk = slab.K, prm.n, len(prm.key_pos)
    if len(slab.types) > MAX_COLS or len(cols) != len(slab.types) or \
            not 0 < nk <= MAX_KEYS:
        raise ValueError("keyed_freq: column or key count")
    if len(spec.bytecode) > MAX_CODE:
        raise ValueError("keyed_freq: filter bytecode too long")
    _check(ts, "ts", torch.int64, (B,), dev)
    _check(kind, "kind", torch.int32, (B,), dev)
    _check(valid, "valid", torch.bool, (B,), dev)
    _check(gslot, "gslot", torch.int32, (B,), dev)
    _check(key_idx, "key_idx", torch.int32, (Kb,), dev)
    _check(sel, "sel", torch.int32, (Kb, E), dev)
    _check(slab.ts, "slab ts", torch.int64, (K, n), dev)
    _check(slab.gslot, "slab gslot", torch.int32, (K, n), dev)
    _check(slab.f_counts, "counts", torch.int64, (K, n), dev)
    _check(slab.f_keys, "keys", torch.int64, (K, n, nk), dev)
    _check(slab.seq, "seq", torch.int64, (K,), dev)
    pl = KFreqPlan()
    pl.Kb, pl.E, pl.K, pl.n = Kb, E, K, n
    pl.nk, pl.ncols = nk, len(cols)
    for j, p in enumerate(prm.key_pos):
        pl.key_col[j] = p
    pl.code_len = len(spec.bytecode)
    for j, w in enumerate(spec.bytecode):
        pl.code[j] = w
    keep = []
    for j, (c, tp) in enumerate(zip(cols, slab.types)):
        d = slab_dtype(tp)
        if c.dtype == torch.bool:
            c = c.to(torch.int32)
            keep.append(c)
        _check(c, f"column {j}", d, (B,), dev)
        _check(slab.cols[j], f"slab column {j}", d, (K, n), dev)
        pl.col_ty[j] = type_code(tp)
        pl.col_w[j] = torch.empty((), dtype=d).element_size()
        pl.col[j], pl.s_col[j] = c.data_ptr(), slab.cols[j].data_ptr()
    pl.ts, pl.kind, pl.valid, pl.gslot = (ts.data_ptr(), kind.data_ptr(),
                                          valid.data_ptr(), gslot.data_ptr())
    pl.key_idx, pl.sel = key_idx.data_ptr(), sel.data_ptr()
    pl.s_ts, pl.s_gslot = slab.ts.data_ptr(), slab.gslot.data_ptr()
    pl.counts, pl.keys = slab.f_counts.data_ptr(), slab.f_keys.data_ptr()
    pl.seq = slab.seq.data_ptr()

    def e(m, d=torch.int32):
        return torch.empty(max(m, 1), dtype=d, device=dev)
    arr, apos, n_arr = e(Kb * E), e(Kb * E), e(Kb)
    ocnt = e(Kb, torch.int64)
    sums = torch.zeros((Kb + 1023) // 1024 + 1, dtype=torch.int64,
                       device=dev)
    words = workspace_words(n, nk)
    pl.ws_words = words
    ws = None
    if WARPS * words * 8 > SMEM_MAX:
        # the counters past the shared memory: a global slice for each warp
        # of at most 1,024 blocks
        pl.ws_global = 1
        ws = e(min(max((Kb + WARPS - 1) // WARPS, 1), 1024) * WARPS * words,
               torch.int64)
        pl.ws = ws.data_ptr()
    pl.arr, pl.apos, pl.n_arr = arr.data_ptr(), apos.data_ptr(), \
        n_arr.data_ptr()
    pl.ocnt, pl.sums = ocnt.data_ptr(), sums.data_ptr()
    bufs = {"cols": keep, "sums": sums,
            "scratch": (arr, apos, n_arr, ocnt, ws),
            "inputs": (ts, kind, valid, gslot, key_idx, sel),
            "sets": fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)}
    return pl, bufs


def _call(pl: KFreqPlan, what: str, dev) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("keyed_freq", f"siddhi_keyed_freq_{what}",
                      "siddhi_keyed_freq_plan_size", pl, stream)


def alloc_out(pl: KFreqPlan, types, m: int, dev):
    def e(d):
        return torch.empty(max(m, 1), dtype=d, device=dev)
    out = (e(torch.int64), e(torch.int32), e(torch.int64), e(torch.int32),
           tuple(e(slab_dtype(tp)) for tp in types))
    pl.cap = m
    pl.out_ts, pl.out_kind = out[0].data_ptr(), out[1].data_ptr()
    pl.out_seq, pl.out_gslot = out[2].data_ptr(), out[3].data_ptr()
    for j, c in enumerate(out[4]):
        pl.out_col[j] = c.data_ptr()
    from ..core.window import Rows
    return Rows(ts=out[0], kind=out[1], valid=None, seq=out[2],
                gslot=out[3], cols=out[4])


def launch(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
           sel, now: int, prm: FreqParams, n_out: Optional[int] = None):
    """The count launch (each key row's walk on a copy of its counters,
    its rows counted, and their scan), one fetch of the total (it sizes
    the output), the write launch (the walk again, its rows written at
    the row's offset, the counters and stored events moved in place).
    `n_out`, when the caller knows the total, skips the fetch (CUDA-graph
    timing)."""
    global launches
    if slab.mode != MODE_FREQ:
        raise ValueError("keyed_freq: not a frequent slab")
    dev = slab.ts.device
    pl, bufs = prepare(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                       sel, prm)
    _call(pl, "count", dev)
    m = int(bufs["sums"][-1]) if n_out is None else n_out
    out = alloc_out(pl, slab.types, m, dev)
    _call(pl, "write", dev)
    record_key_offsets(bufs["scratch"][3], sel.shape[0], m)
    launches += 1
    del bufs
    return finish(out, slab.types, m), no_wake(dev)
