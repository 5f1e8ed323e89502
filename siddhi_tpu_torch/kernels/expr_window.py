"""Slabs, wrappers and plain versions of the expression window kernels K25
`expr_window` and K26 `expr_batch` (`siddhi_tpu_torch/csrc/expr_window.cu`).

They replace the JAX package's `ExpressionWindow.process` and
`ExpressionBatchWindow.process` (`siddhi_tpu/core/window_expr.py:227`,
`:329`): at the top level on one key row whose events are the whole batch,
and inside a partition under the keyed step `kstep`
(`siddhi_tpu/core/planner.py:539-584`: the pre-window filters, the gather
of each key's events to [Kb, E], `process` under `vmap` with B = E, the
scatter back that drops padding keys, the rows flattened key-major).  A
key row's arrivals are its events that are valid CURRENT rows and pass
the filters, in batch order (`k` an arrival's rank, `ncur` their number);
its combined array is its kept rows by age ([0, cnt)) then its arrivals;
arrival k is its index hi = cnt + k.  With N = C + B (B the batch's
per-key width, `sel.shape[1]`):
  * `expression` (K25): `sat(hi, j)` is the window's range program
    (`core/window_expr.py`) over [j, hi].  Each arrival in turn moves the
    key's front: the first j >= front with sat(hi, j) (hi + 1 when there
    is none: the arrival itself expires), then at least hi + 1 - C.  The
    candidates are j in [hi - C, hi]: the front is at least hi - C.  A row
    p the front passes at arrival k comes out EXPIRED with its own ts at
    seq0 + k (N + 1) + p - front before k; arrival k CURRENT at
    seq0 + k (N + 1) + N.  The key keeps [front, cnt + ncur) (at most C
    rows); its counter advances by B (N + 1) + 1.
  * `expressionBatch` (K26): the pending run starts at `start` (0 at the
    step's start).  Arrival k flushes when sat(hi, start) fails or the run
    [start, hi] is longer than C; the new start is hi + 1 with
    include.triggering.event, else hi.  With F flushes, flush f's batch is
    [s_f, s_f+1) (s_0 = 0, s_f the start after flush f).  The rows, with
    span = 2N + 2: the previous batch EXPIRED at base + rank when F > 0;
    batch f CURRENT at seq0 + f span + N + 1 + rank; batch f EXPIRED again
    at base + (f + 1) span + rank when f + 1 < F.  base is seq0, or with
    stream.current.event seq0 + B: every arrival then comes out CURRENT
    at seq0 + k instead of the batches.  The key keeps [start, cnt + ncur)
    pending and, after a flush, its last batch as the previous one (C + 1
    rows hold a full run and its triggering event); its counter advances
    by (B + 2) span.
A key row's rows come out in seq order (EXPIRED before CURRENT where the
reference orders them so), the keys' rows key-major in the order of
`key_idx`.  Padding key rows (`key_idx == K`) touch nothing.  Neither
window needs a timer: the wake is always [NO_WAKEUP, 0].

Slab: `keyed_window.KeyedSlab` in MODE_EXPR (each key's rows by age, a
compact prefix of its C) or MODE_EXPRB (the pending run there, the
previous batch in the `p_*` block of C + 1 rows).  The top-level windows
keep a slab of one key.

Tolerance: the sums are P[hi] - P[j] + x[j] over a float64 prefix of the
combined array, as the reference forms them; the kernel's prefix is a
block scan, the plain version's `torch.cumsum`, the reference's XLA's.
They agree exactly while every prefix is exact in float64 (integer-valued
data, or f32 values whose sums keep within 53 bits of mantissa); beyond
that a sum may differ in its last bits and a comparison at the boundary
with it.  Everything else is exact.

`expr_window_step` is what the windows and the keyed planner call: CPU
tensors run `plain`, CUDA tensors launch the kernel.  `launches` /
`plain_calls` count the steps, `mode_launches` the launches by mode;
`reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows
from ..core.window_expr import (A_ADD, A_DIV, A_MUL, A_SUB, AGG_AVG,
                                AGG_MIN, AGG_SUM,
                                MAX_AGGS, MAX_LANES, MAX_PROG, R_AGG,
                                R_AND, R_ARITH, R_CAST, R_CMP, R_COL,
                                R_CONST, R_COUNT, R_FIRST, R_LAST, R_NOT,
                                R_OR, R_TRUTH, T_BOOL, T_F32, T_F64, T_I32,
                                T_I64, TS_LANE, RangeProgram)
from . import _nvcc
from .filter_bytecode import type_code
from .in_probe import MAX_IN, InSet, fill_sets
from .keyed_ext import _cat, _compact, _Keys, _store_block
from .keyed_window import (MODE_EXPR, MODE_EXPRB, KeyedSlab, _wake, finish,
                           no_wake, record_key_offsets, slab_dtype)

launches = 0
plain_calls = 0
mode_launches = [0] * (MODE_EXPRB + 1)     # indexed by mode

MAX_COLS, MAX_CODE = 16, 256
# the (arrival, candidate) pairs the plain version evaluates at once
CHUNK = 1 << 21
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_DT = {T_I32: torch.int32, T_I64: torch.int64, T_F32: torch.float32,
       T_BOOL: torch.bool, T_F64: torch.float64}


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0] * (MODE_EXPRB + 1)


@dataclasses.dataclass(frozen=True)
class ExprParams:
    """An expression window's range program and options."""

    program: RangeProgram
    batch: bool = False
    include_trigger: bool = False
    stream_current: bool = False


def empty_slab(window, K: int, device) -> KeyedSlab:
    """K empty keys of an expression window."""
    mode = MODE_EXPRB if window.name == "expressionBatch" else MODE_EXPR
    return KeyedSlab.empty(mode, window.schema.types, K, window.capacity,
                           device)


def expr_window_step(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols,
                     key_idx, sel, now: int, prm: ExprParams,
                     tick: bool = False):
    """One step of an expression window over the key rows `key_idx` [Kb]
    (K for a padding row) and their batch rows `sel` [Kb, E] (-1 for
    none); `spec` the query's FilterSpec.  Moves the slab in place;
    returns (Rows of exactly the emitted rows, i64[2] [NO_WAKEUP, 0])."""
    if ts.is_cuda:
        return launch(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                      sel, now, prm)
    return plain(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
                 now, prm)


# ---------------------------------------------------------------------------
# the plain version: the sat predicate as torch ops, the walk on the host
# ---------------------------------------------------------------------------

def _ext(a, b, is_min):
    """jnp.minimum / jnp.maximum: NaN if either is NaN, -0.0 below +0.0."""
    first = (a < b) if is_min else (a > b)
    second = (b < a) if is_min else (b > a)
    tie = torch.signbit(a) if is_min else ~torch.signbit(a)
    r = torch.where(first, a, torch.where(second, b,
                                          torch.where(tie, a, b)))
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), r)


def _rev_ext(x, is_min):
    """y[:, o] = the extreme of x[:, o:] (a doubling scan from the top)."""
    y = torch.flip(x, [1])
    s = 1
    while s < y.shape[1]:
        y = torch.cat([y[:, :s], _ext(y[:, s:], y[:, :-s], is_min)], 1)
        s *= 2
    return torch.flip(y, [1])


def _arith(op, t, a, b):
    if op == A_ADD:
        return a + b
    if op == A_SUB:
        return a - b
    if op == A_MUL:
        return a * b
    if op == A_DIV:
        return a / b
    if t in (T_F32, T_F64):
        # jnp.remainder: fmod, moved to the divisor's sign
        tm = torch.fmod(a, b)
        plus = ((tm < 0) != (b < 0)) & (tm != 0)
        return torch.where(plus, tm + b, tm)
    # floor modulo; a zero divisor gives 0 (and -1 always does)
    one = torch.ones_like(b)
    return torch.remainder(a, torch.where((b == 0) | (b == -1), one, b))


_CMPF = (torch.lt, torch.le, torch.gt, torch.ge, torch.eq, torch.ne)


def _const(code, pc, dev):
    t, lo, hi = code[pc + 1], code[pc + 2], code[pc + 3]
    bits = (lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)
    raw = np.array([bits], dtype=np.uint64)
    if t == T_F64:
        v = raw.view(np.float64)[0].item()
    elif t == T_F32:
        v = raw.astype(np.uint32).view(np.float32)[0].item()
    elif t == T_BOOL:
        v = bool(bits)
    else:
        v = int(raw.view(np.int64)[0])
    return torch.tensor(v, dtype=_DT[t], device=dev)


def run_program(code, dev, load, count=None, agg=None):
    """Evaluate a postfix range or per-row program with torch ops:
    `load(op, lane, t)` gives R_FIRST / R_LAST / R_COL values, `count` and
    `agg(a)` the R_COUNT / R_AGG ones."""
    stk = []
    pc = 0
    while pc < len(code):
        op = code[pc]
        if op == R_CONST:
            stk.append(_const(code, pc, dev))
            pc += 4
        elif op in (R_FIRST, R_LAST, R_COL):
            stk.append(load(op, code[pc + 1], code[pc + 2]))
            pc += 3
        elif op == R_COUNT:
            stk.append(count)
            pc += 1
        elif op == R_AGG:
            stk.append(agg(code[pc + 1]))
            pc += 2
        elif op == R_CAST:
            stk.append(stk.pop().to(_DT[code[pc + 2]]))
            pc += 3
        elif op in (R_ARITH, R_CMP):
            b, a = stk.pop(), stk.pop()
            if op == R_ARITH:
                stk.append(_arith(code[pc + 1], code[pc + 2], a, b))
            else:
                stk.append(_CMPF[code[pc + 1]](a, b))
            pc += 3
        elif op in (R_AND, R_OR):
            b, a = stk.pop(), stk.pop()
            stk.append((torch.logical_and if op == R_AND
                        else torch.logical_or)(a, b))
            pc += 1
        elif op == R_NOT:
            stk.append(torch.logical_not(stk.pop()))
            pc += 1
        elif op == R_TRUTH:
            stk.append(stk.pop() != 0)
            pc += 2
        else:
            raise ValueError(f"range program opcode {op}")
    return stk[0]


class _Comb:
    """The key rows' combined arrays [Kb, C + E]: the slab rows [0, cnt),
    then the arrivals (positions past cnt + ncur are undefined)."""

    def __init__(self, g: _Keys, slab, prog: RangeProgram):
        C, E = g.C, g.E
        b_ts, b_gs, b_cols, _ = g.block(slab)
        v = torch.arange(C + E, device=g.dev)[None, :]
        cnt = g.cnt[:, None]
        self.phys = torch.where(v < cnt, v, C + v - cnt).clamp(0, C + E - 1)
        self.v = v
        self.ts = self.comb(b_ts, g.ts)
        self.gs = self.comb(b_gs, g.gs)
        self.cols = [self.comb(b, a) for b, a in zip(b_cols, g.cols)]
        self.lanes = []
        for pos, t in zip(prog.lanes, prog.lane_types):
            x = self.ts if pos == TS_LANE else self.cols[pos]
            self.lanes.append(x != 0 if t == T_BOOL else x.to(_DT[t]))
        # each aggregate's per-row values as float64, and their prefix
        self.x, self.P = [], []
        for kind, acode, _ in prog.aggs:
            x = run_program(acode, g.dev,
                            lambda op, lane, t: self.lanes[lane])
            x = x.expand(self.ts.shape).to(torch.float64)
            self.x.append(x)
            self.P.append(torch.cumsum(x, 1)
                          if kind in (AGG_SUM, AGG_AVG) else None)

    def comb(self, b, a):
        return torch.gather(_cat(b, a), 1, self.phys)


def _sat(g: _Keys, cb: _Comb, prog: RangeProgram, W: int, lo: int):
    """sat [arrivals, W] on the host, the arrivals key row by key row (key
    row r's arrival k at aoff[r] + k): whether the program holds over
    [j, hi] for hi = cnt + k and candidate j = hi - lo + o (False for
    j < 0)."""
    items = torch.nonzero(g.valid)            # (r, k) of each arrival
    out = np.zeros((items.shape[0], W), np.bool_)
    o = torch.arange(W, device=g.dev)[None, :]
    step = max(1, CHUNK // W)
    for i0 in range(0, items.shape[0], step):
        r, k = items[i0:i0 + step, 0], items[i0:i0 + step, 1]
        hi = g.cnt[r] + k
        j = hi[:, None] - lo + o
        jv = j >= 0
        jc = j.clamp(min=0)
        r2 = r[:, None]

        def load(op, lane, t, r=r, r2=r2, hi=hi, jc=jc):
            x = cb.lanes[lane]
            if op == R_FIRST:
                return x[r2, jc]
            y = x[r, hi][:, None]
            return y + 0.0 if t in (T_F32, T_F64) else y

        aggs = []
        for a, (kind, _, _) in enumerate(prog.aggs):
            x = cb.x[a]
            if kind in (AGG_SUM, AGG_AVG):
                P = cb.P[a]
                s = (P[r, hi][:, None] + 0.0 - P[r2, jc]) + x[r2, jc]
                if kind == AGG_AVG:
                    s = s / torch.clamp((hi[:, None] - j + 1).double(),
                                        min=1.0)
            else:
                s = _rev_ext(x[r2, jc], kind == AGG_MIN)
            aggs.append(s)
        res = run_program(prog.code, g.dev, load,
                          count=hi[:, None] - j + 1, agg=aggs.__getitem__)
        sat = (res.expand(j.shape) != 0) & jv
        out[i0:i0 + r.shape[0]] = sat.cpu().numpy()
    return out


def _active(ncur, E):
    """For each arrival rank k < E, the key rows with an arrival k: a
    prefix of the rows by falling ncur (so a hot key row costs the walk
    its own arrivals, not every row's)."""
    order = np.argsort(-ncur, kind="stable")
    n = ncur.shape[0] - np.searchsorted(np.sort(ncur), np.arange(E),
                                        side="right")
    aoff = np.concatenate([[0], np.cumsum(ncur)[:-1]]).astype(np.int64)
    return ((k, order[:n[k]], aoff[order[:n[k]]] + k) for k in range(E))


def _walk_sliding(sat, cnt, ncur, C, E):
    """Each arrival's front after it ([Kb, E]; past ncur the final one)."""
    o = np.arange(sat.shape[1])[None, :]
    front = np.zeros(cnt.shape[0], np.int64)
    fronts = np.zeros((cnt.shape[0], E), np.int64)
    for k, rows, at in _active(ncur, E):
        hi = cnt[rows] + k
        base = hi - C
        off = np.maximum(front[rows], base) - base
        m = sat[at] & (o >= off[:, None])
        nf = np.where(m.any(1), base + m.argmax(1), hi + 1)
        front[rows] = np.maximum(nf, hi + 1 - C)
        fronts[:, k] = front
    return fronts


def _walk_batch(sat, cnt, ncur, C, E, include):
    """Each arrival's flush flag and the start after it ([Kb, E] each)."""
    W = sat.shape[1]
    start = np.zeros(cnt.shape[0], np.int64)
    flush = np.zeros((cnt.shape[0], E), np.bool_)
    starts = np.zeros((cnt.shape[0], E), np.int64)
    for k, rows, at in _active(ncur, E):
        hi = cnt[rows] + k
        base = hi - C + 1
        st = start[rows]
        over = st < base                        # the run is longer than C
        s = sat[at, np.clip(st - base, 0, W - 1)] & ~over
        f = (st <= hi) & (~s | over)
        start[rows] = np.where(f, hi + 1 if include else hi, st)
        flush[rows, k] = f
        starts[:, k] = start
    return flush, starts


def plain(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
          now: int, prm: ExprParams):
    """The plain PyTorch version (the kernels' reference): the sat
    predicate over every (arrival, candidate) pair as torch ops, the walk
    over the arrivals on the host (vectorised over the key rows), the rows
    and the write back as torch ops."""
    global plain_calls
    plain_calls += 1
    g = _Keys(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel, now)
    cb = _Comb(g, slab, prm.program)
    C, E = g.C, g.E
    W, lo = (C, C - 1) if prm.batch else (C + 1, C)
    sat = _sat(g, cb, prm.program, W, lo)
    cnt, ncur = g.cnt.cpu().numpy(), g.ncur.cpu().numpy()
    if prm.batch:
        flush, starts = _walk_batch(sat, cnt, ncur, C, E,
                                    prm.include_trigger)
        return _emit_batch(g, cb, slab, prm, torch.from_numpy(flush)
                           .to(g.dev), torch.from_numpy(starts).to(g.dev))
    fronts = torch.from_numpy(_walk_sliding(sat, cnt, ncur, C, E)) \
        .to(g.dev)
    return _emit_sliding(g, cb, slab, fronts)


def _emit_sliding(g: _Keys, cb: _Comb, slab, fronts):
    C, E = g.C, g.E
    N = C + E
    span = N + 1
    s0 = g.seq0[:, None]
    total = (g.cnt + g.ncur)[:, None]
    ff = fronts[:, -1:] if E else torch.zeros_like(total)
    # the arrival that evicts p: the first k whose front passes it
    ek = torch.searchsorted(fronts.contiguous(), cb.v.expand(g.Kb, N)
                            .contiguous(), right=True)
    prev = torch.where(ek > 0, torch.gather(fronts, 1, (ek - 1).clamp(
        min=0, max=max(E - 1, 0))), 0)
    evicted = (cb.v < ff) & g.live[:, None]
    out = g.rows([
        g.part(cb.ts, ev.EXPIRED, evicted, s0 + ek * span + (cb.v - prev),
               cb.gs, cb.cols),
        g.part(g.ts, ev.CURRENT, g.valid, s0 + g.kk * span + span - 1, g.gs,
               g.cols)])
    keep = (cb.v >= ff) & (cb.v < total)
    new, _ = _compact(g, [cb.ts, cb.gs, *cb.cols], keep, cb.v - ff)
    _store_block(g, slab, new, (total - ff)[:, 0])
    g.store(slab.seq, g.seq0 + E * span + 1)
    return out, _wake(NO_WAKEUP, 0, g.dev)


def _emit_batch(g: _Keys, cb: _Comb, slab, prm: ExprParams, flush, starts):
    C, E, i64 = g.C, g.E, torch.int64
    N = C + E
    span = 2 * N + 2
    s0 = g.seq0[:, None]
    total = (g.cnt + g.ncur)[:, None]
    sfin = starts[:, -1:] if E else torch.zeros_like(total)
    F = flush.sum(1, keepdim=True)
    # each flush's start marks the combined array: a row's flush ordinal
    # is the marks at or before it, its batch's start the latest of them
    marks = torch.zeros((g.Kb, N + 1), dtype=i64, device=g.dev)
    marks.scatter_add_(1, torch.where(flush, starts, N).clamp(max=N),
                       flush.to(i64))
    marks = marks[:, :N]
    fp = torch.cumsum(marks, 1)
    bstart = torch.cummax(torch.where(marks > 0, cb.v, 0), 1).values
    rank = cb.v - bstart
    flushed = (cb.v < sfin) & (cb.v < total) & g.live[:, None]
    q_ts, q_gs, q_cols, q_alive = _prev_block(g, slab)
    base = s0 + E if prm.stream_current else s0
    parts = [g.part(q_ts, ev.EXPIRED, q_alive & (F > 0) & g.live[:, None],
                    base + torch.arange(C + 1, device=g.dev)[None, :],
                    q_gs, q_cols),
             g.part(cb.ts, ev.EXPIRED, flushed & (fp + 1 < F),
                    base + (fp + 1) * span + rank, cb.gs, cb.cols)]
    if prm.stream_current:
        parts.append(g.part(g.ts, ev.CURRENT, g.valid, s0 + g.kk, g.gs,
                            g.cols))
    else:
        parts.append(g.part(cb.ts, ev.CURRENT, flushed,
                            s0 + fp * span + N + 1 + rank, cb.gs, cb.cols))
    out = g.rows(parts)
    vals = [cb.ts, cb.gs, *cb.cols]
    # the previous batch: the last flushed one (kept when none flushed)
    last = flushed & (fp == F - 1)
    new_q, _ = _compact(g, vals, last, rank, C + 1)
    fl = F > 0
    old_q = [q_ts, q_gs, *q_cols]
    new_q = [torch.where(fl, a, b) for a, b in zip(new_q, old_q)]
    _store_block(g, slab, new_q, torch.where(
        fl[:, 0], last.sum(1), slab.p_count[g.kidx].long()), prev=True)
    keep = (cb.v >= sfin) & (cb.v < total)
    new, _ = _compact(g, vals, keep, cb.v - sfin)
    _store_block(g, slab, new, (total - sfin)[:, 0])
    g.store(slab.seq, g.seq0 + (E + 2) * span)
    return out, _wake(NO_WAKEUP, 0, g.dev)


def _prev_block(g: _Keys, slab):
    """The key rows' previous batch (C + 1 rows) and its alive mask."""
    k = g.kidx
    ar = torch.arange(slab.p_ts.shape[1], device=g.dev)[None, :]
    return (slab.p_ts[k], slab.p_gslot[k], [c[k] for c in slab.p_cols],
            ar < slab.p_count[k].long()[:, None])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

class ExprPlan(ctypes.Structure):
    """Mirrors `struct ExprPlan` in csrc/expr_window.cu."""
    _fields_ = (
        [(x, _L) for x in ("Kb", "E", "K", "C", "W", "nwords", "A", "LT",
                           "cap")] +
        [(x, _I) for x in ("ncols", "code_len", "prog_len", "nlanes",
                           "naggs", "inc", "stream", "pad")] +
        [("lane_col", _I * MAX_LANES), ("lane_ty", _I * MAX_LANES),
         ("agg_kind", _I * MAX_AGGS), ("agg_off", _I * MAX_AGGS),
         ("agg_len", _I * MAX_AGGS), ("agg_ty", _I * MAX_AGGS),
         ("col_ty", _I * MAX_COLS), ("col_w", _I * MAX_COLS),
         ("code", _I * MAX_CODE), ("prog", _I * MAX_PROG),
         ("ts", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("col", _P * MAX_COLS), ("key_idx", _P), ("sel", _P),
         ("s_ts", _P), ("s_gslot", _P), ("s_col", _P * MAX_COLS),
         ("count", _P), ("seq", _P), ("p_ts", _P), ("p_gslot", _P),
         ("p_col", _P * MAX_COLS), ("p_count", _P),
         ("arr", _P), ("n_arr", _P), ("aoff", _P), ("atot", _P),
         ("arow", _P), ("lane", _P), ("aggx", _P), ("aggp", _P),
         ("bits", _P), ("walk", _P), ("wres", _P), ("ocnt", _P),
         ("sums", _P), ("asums", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("in_sets", InSet * MAX_IN)])


def _check(x, name, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"expr_window: {name} must be a contiguous {list(shape)} "
            f"{dtype} tensor on {dev} (got {list(x.shape)} {x.dtype} on "
            f"{x.device})")


def candidates(C: int, batch: bool) -> int:
    """The candidate oldest rows of an arrival: C + 1 for K25, C for K26."""
    return C if batch else C + 1


def prepare(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
            sel, prm: ExprParams):
    """Check the inputs and fill a plan with the batch, the slab, the
    program and the scratch; returns (plan, the tensors the launches
    read, which must stay referenced until both are queued; "sums" ends
    with the total).  The scratch is sized by the batch, not by its
    widest key row: A = the batch's rows bounds the arrivals of all key
    rows together (a batch row is an arrival of at most one key row), a
    key row's combined array takes at most C + its arrivals."""
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    want = MODE_EXPRB if prm.batch else MODE_EXPR
    if slab.mode != want:
        raise ValueError("expr_window: the slab's mode is not the window's")
    dev = slab.ts.device
    B = ts.shape[0]
    Kb, E = sel.shape
    K, C = slab.K, slab.C
    prog = prm.program
    if len(slab.types) > MAX_COLS or len(cols) != len(slab.types):
        raise ValueError("expr_window: column count")
    if len(spec.bytecode) > MAX_CODE:
        raise ValueError("expr_window: filter bytecode too long")
    _check(ts, "ts", torch.int64, (B,), dev)
    _check(kind, "kind", torch.int32, (B,), dev)
    _check(valid, "valid", torch.bool, (B,), dev)
    _check(gslot, "gslot", torch.int32, (B,), dev)
    _check(key_idx, "key_idx", torch.int32, (Kb,), dev)
    _check(sel, "sel", torch.int32, (Kb, E), dev)
    _check(slab.ts, "slab ts", torch.int64, (K, C), dev)
    _check(slab.gslot, "slab gslot", torch.int32, (K, C), dev)
    _check(slab.count, "count", torch.int32, (K,), dev)
    _check(slab.seq, "seq", torch.int64, (K,), dev)
    pl = ExprPlan()
    W = candidates(C, prm.batch)
    nwords = (W + 31) // 32
    LT = Kb * C + B
    pl.Kb, pl.E, pl.K, pl.C, pl.W, pl.nwords, pl.A, pl.LT = Kb, E, K, C, \
        W, nwords, B, LT
    pl.inc, pl.stream = int(prm.include_trigger), int(prm.stream_current)
    pl.ncols = len(cols)
    pl.code_len = len(spec.bytecode)
    for j, w in enumerate(spec.bytecode):
        pl.code[j] = w
    words = list(prog.code)
    pl.prog_len = len(words)
    for a, (akind, acode, aty) in enumerate(prog.aggs):
        pl.agg_kind[a], pl.agg_off[a] = akind, len(words)
        pl.agg_len[a], pl.agg_ty[a] = len(acode), aty
        words += list(acode)
    if len(words) > MAX_PROG:
        raise ValueError("expr_window: range program too long")
    for j, w in enumerate(words):
        pl.prog[j] = w
    pl.nlanes, pl.naggs = len(prog.lanes), len(prog.aggs)
    for j, (pos, t) in enumerate(zip(prog.lanes, prog.lane_types)):
        pl.lane_col[j], pl.lane_ty[j] = pos, t
    keep = []
    two = prm.batch
    for j, (c, tp) in enumerate(zip(cols, slab.types)):
        d = slab_dtype(tp)
        if c.dtype == torch.bool:
            c = c.to(torch.int32)
            keep.append(c)
        _check(c, f"column {j}", d, (B,), dev)
        _check(slab.cols[j], f"slab column {j}", d, (K, C), dev)
        pl.col_ty[j] = type_code(tp)
        pl.col_w[j] = torch.empty((), dtype=d).element_size()
        pl.col[j], pl.s_col[j] = c.data_ptr(), slab.cols[j].data_ptr()
        if two:
            _check(slab.p_cols[j], f"slab p_column {j}", d, (K, C + 1), dev)
            pl.p_col[j] = slab.p_cols[j].data_ptr()
    pl.ts, pl.kind, pl.valid, pl.gslot = (ts.data_ptr(), kind.data_ptr(),
                                          valid.data_ptr(), gslot.data_ptr())
    pl.key_idx, pl.sel = key_idx.data_ptr(), sel.data_ptr()
    pl.s_ts, pl.s_gslot = slab.ts.data_ptr(), slab.gslot.data_ptr()
    pl.count, pl.seq = slab.count.data_ptr(), slab.seq.data_ptr()
    if two:
        _check(slab.p_ts, "slab p_ts", torch.int64, (K, C + 1), dev)
        _check(slab.p_gslot, "slab p_gslot", torch.int32, (K, C + 1), dev)
        _check(slab.p_count, "p_count", torch.int32, (K,), dev)
        pl.p_ts, pl.p_gslot = slab.p_ts.data_ptr(), slab.p_gslot.data_ptr()
        pl.p_count = slab.p_count.data_ptr()

    def e(m, d=torch.int32):
        return torch.empty(max(m, 1), dtype=d, device=dev)
    nsums = (Kb + 1023) // 1024 + 1
    scratch = dict(
        arr=e(Kb * E), n_arr=e(Kb), aoff=e(Kb, torch.int64), arow=e(B),
        lane=e(len(prog.lanes) * LT, torch.int64),
        aggx=e(len(prog.aggs) * LT, torch.float64),
        aggp=e(len(prog.aggs) * LT, torch.float64),
        bits=e(B * nwords), walk=e(B, torch.int64),
        wres=e(Kb * 2, torch.int64), ocnt=e(Kb, torch.int64),
        asums=torch.zeros(nsums, dtype=torch.int64, device=dev))
    for name, x in scratch.items():
        setattr(pl, name, x.data_ptr())
    pl.atot = scratch["asums"][nsums - 1:].data_ptr()
    sums = torch.zeros(nsums, dtype=torch.int64, device=dev)
    pl.sums = sums.data_ptr()
    bufs = {"cols": keep, "sums": sums, "scratch": scratch,
            "inputs": (ts, kind, valid, gslot, key_idx, sel),
            "sets": fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)}
    return pl, bufs


def _call(pl: ExprPlan, what: str, batch: bool, dev) -> None:
    fam = "expr_batch" if batch else "expr_window"
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("expr_window", f"siddhi_{fam}_{what}",
                      "siddhi_expr_plan_size", pl, stream)


def alloc_out(pl: ExprPlan, types, n: int, dev) -> Rows:
    """Output rows for `n` emitted rows, their pointers set in `pl`."""
    def e(d):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=None,
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(slab_dtype(tp)) for tp in types))
    pl.cap = n
    pl.out_ts, pl.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    for j, c in enumerate(out.cols):
        pl.out_col[j] = c.data_ptr()
    return out


def launch(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
           sel, now: int, prm: ExprParams, n_out: Optional[int] = None):
    """The count launch (stage, sat, walk, the scan of the key rows' row
    counts), one fetch of the total (it sizes the output), the write
    launch.  `n_out`, when the caller knows the total, skips the fetch
    (CUDA-graph timing)."""
    global launches
    dev = slab.ts.device
    pl, bufs = prepare(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                       sel, prm)
    _call(pl, "count", prm.batch, dev)
    n = int(bufs["sums"][-1]) if n_out is None else n_out
    out = alloc_out(pl, slab.types, n, dev)
    _call(pl, "write", prm.batch, dev)
    record_key_offsets(bufs["scratch"]["ocnt"], sel.shape[0], n)
    launches += 1
    mode_launches[slab.mode] += 1
    del bufs
    return finish(out, slab.types, n), no_wake(dev)
