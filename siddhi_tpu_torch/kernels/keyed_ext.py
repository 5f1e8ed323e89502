"""Wrapper and plain versions of the keyed window kernels K20-K23
(`siddhi_tpu_torch/csrc/keyed_ext.cu`): eight windows of the JAX package
kept once per partition key.

They replace, in the JAX package's keyed step `kstep`
(`siddhi_tpu/core/planner.py:539-584`), the pre-window filters, the gather
of each key's events to [Kb, E] by `sel_idx`, `window.process` under
`vmap` over the [K, ...] slab, the scatter back that drops padding keys
(`key_idx == K`), the flattening of the rows and the least wake, for:
  * K20 `keyed_ext`: `ExternalTimeWindow`, `TimeLengthWindow`,
    `DelayWindow` (`siddhi_tpu/core/window_ext.py:83`, `:279`, `:375`);
  * K21 `keyed_batch`: `ExternalTimeBatchWindow`, `ChunkBatchWindow`
    (`batch()`), `CronWindow` (`:178`, `:427`, `:579`);
  * K22 `keyed_sort`: `SortWindow` (`:496`);
  * K23 `keyed_hop`: `HoppingWindow` (`:1166`).
Each key row runs its key's window step with B = E (the batch's per-key
width, `sel.shape[1]`) over the key's kept arrivals: its events that are
valid CURRENT rows and pass the filters, in batch order (`k` below is an
arrival's index among them, `ncur` their number).  A key's rows come out
in its own order, numbered from its own counter `seq0`, and the keys'
rows key-major in the order of `key_idx`; only emitted rows come out.
Per mode (t the time, C the key's capacity):
  * externalTime(ets, t): `ext_now` is the greatest event time of the
    key's arrivals; the key's rows and arrivals with ets + t <= ext_now
    expire, EXPIRED with ts = ets + t, and the arrivals pass CURRENT, in a
    stable order by 2(ets + t) for the expiring rows (the slab's, then
    the arrivals') and 2 ets + 1 for the arrivals, numbered seq0 + rank.
    The survivors are kept sorted by (ets, candidate position); the
    oldest beyond C drop (counted as missed).
  * timeLength(t, n): the key's rows with ts + t <= now expire (EXPIRED,
    ts + t, key 4(ts + t)); arrival k evicts the survivor (or earlier
    arrival) n places before it (EXPIRED with the arrival's ts, key
    4 ts + 1) and passes CURRENT (key 4 ts + 2); stable order, numbered
    seq0 + rank; the last n of the survivors and arrivals stay, in
    arrival order; the wake is their least ts + t.
  * delay(t): the key's rows and arrivals with ts + t <= now pass CURRENT
    with their own ts, in a stable (ts + t) order, numbered seq0 + rank;
    the others stay in candidate order (beyond C: missed); the wake is
    their least ts + t.
  * externalTimeBatch(ets, t[, start]): the key's slices [start + i t,
    start + (i+1) t) of the event time, `start` its own (the parameter, or
    its first arrival's ets); arrivals whose ets passes the slice's end
    flush it once, at the latest boundary passed: the previous slice
    EXPIRED (seq0 + rank), a RESET row (ts now, seq0 + C), the pending
    slice and the arrivals before the boundary CURRENT (seq0 + C + 1 +
    rank); those become the previous slice, the later arrivals the
    pending one; the counter advances by 2C + E + 2.
  * batch(): a key with arrivals emits its previous chunk EXPIRED (seq0 +
    rank), a RESET row (seq0 + p), its arrivals CURRENT (seq0 + p + 1 + k),
    p the previous chunk's rows; the arrivals become the previous chunk;
    the counter advances by p + 1 + ncur.  The reference keeps at most
    its batch capacity (64 a key) and drops the rest silently; the port's
    slab grows to the widest key row of a step instead.
  * cron(expr): a key row that holds a valid TIMER row flushes: the
    previous batch EXPIRED (seq0 + rank), a RESET row (seq0 + C), the
    pending batch CURRENT (seq0 + C + 1 + rank); the pending batch becomes
    the previous one and the arrivals the pending one (otherwise they
    join it); the counter advances by 2C + 1.
  * sort(n, key[, order]): the reference's stable sort of the key's C + E
    candidate places (the slab's rows at [0, C), arrival k at C + its sel
    column; a dead place keyed +inf or BIG_SEQ, so it ties with an alive
    key of that value and wins by position; float keys compare as float64
    with -0 equal to 0 and every NaN above +inf; 'desc' negates in the
    column's own type); an alive candidate ranked at or past min(alive, n)
    is evicted.  Out: the arrivals CURRENT (seq0 + k), then the evicted
    EXPIRED in candidate order (seq0 + ncur + rank); the kept stay in
    candidate order.
  * hopping(win, hop): the key's first boundary `next` is its first
    arrival's ts + hop; a step with now >= next flushes at emit = next +
    ((now - next) // hop) hop: the candidates (the slab's rows, then the
    arrivals) with ts in [emit - hop - win, emit - hop) EXPIRED (seq0 +
    rank), a RESET row (seq0 + C + E), those in [emit - win, emit)
    CURRENT (seq0 + C + E + 1 + rank); next becomes emit + hop and the
    counter advances by 2(C + E) + 2; the candidates with ts >= next -
    win - hop stay, in candidate order (beyond C: missed); the wake is
    next.
Rows that do not fit a key's C are counted in the wake's second word, on
which the runtime raises; the reference drops them silently.  Padding key
rows touch nothing and are left out of the wake.

Slab (`keyed_window.KeyedSlab`, every key's rows a compact prefix of its
[C] row): externalTime's rows sorted by (event time, position), the
others' in the reference's buffer order; externalTimeBatch and cron keep
the pending block in the slab's main columns and the previous one in the
`p_*` columns; externalTimeBatch's per-key `start` and hopping's `next`
are in `key_state`.

K22's kernel ranks a key row's alive candidates on a warp when they are
at most SORT_LIMIT (warp mode) and on a block of its own otherwise (block
mode, enabled where C + E can pass the limit: `sort_plan`); both keep the
K20-K23 protocol below.

`keyed_ext_step` is what the keyed planner calls: CPU tensors run
`plain`, CUDA tensors launch the family's kernel; both return the rows
and i64[2] [least wake, rows missed].  `launches` / `plain_calls` count
them (one per step), `mode_launches` the launches by mode and
`tick_launches` those of timer ticks; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..core import event as ev
from ..core.window import BIG_SEQ, NO_WAKEUP, Rows
from . import _nvcc
from .filter_bytecode import type_code
from .in_probe import MAX_IN, InSet, fill_sets
from .keyed_window import (MODE_CHUNK, MODE_CRON, MODE_DELAY, MODE_EXT,
                           MODE_HOP, MODE_SORT, MODE_TLEN, MODE_XBATCH,
                           KeyedSlab, _keep, _rows, _wake, finish,
                           record_key_offsets, slab_dtype)
from .sort_window import DEAD_FLOAT, DEAD_INT, key_type, sort_keys

launches = 0
plain_calls = 0
mode_launches = [0] * (MODE_HOP + 1)     # indexed by mode
tick_launches = 0

# the kernel of each mode: (its name, its entry points' prefix)
FAMILY = {MODE_EXT: "keyed_ext", MODE_TLEN: "keyed_ext",
          MODE_DELAY: "keyed_ext", MODE_XBATCH: "keyed_batch",
          MODE_CHUNK: "keyed_batch", MODE_CRON: "keyed_batch",
          MODE_SORT: "keyed_sort", MODE_HOP: "keyed_hop"}
MAX_COLS, MAX_CODE = 16, 256
# threads a key row's block runs; the shared memory a block may take
BLOCK, SMEM_MAX = 128, 96 * 1024
# K22: SORT_R candidates a lane, so a warp ranks a key row of at most
# SORT_LIMIT candidates (warp mode); a larger row takes a block of its own
# (block mode), at most SORT_HOT_GRID blocks
SORT_R = 8
SORT_LIMIT = 32 * SORT_R
SORT_HOT_GRID = 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls, tick_launches
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0] * (MODE_HOP + 1)
    tick_launches = 0


@dataclasses.dataclass(frozen=True)
class ExtParams:
    """A keyed window's parameters: `t` the time (externalTime,
    timeLength, delay, externalTimeBatch), `length` the row count
    (timeLength, sort), `ts_pos` the event-time column, `key_pos` /
    `desc` sort's key column and order, `win` / `hop` hopping's."""

    t: int = 0
    length: int = 0
    ts_pos: int = -1
    key_pos: int = -1
    desc: bool = False
    win: int = 0
    hop: int = 0


def keyed_ext_step(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols,
                   key_idx, sel, now: int, prm: ExtParams,
                   tick: bool = False):
    """One keyed step of a K20-K23 window.  `ts`, `kind`, `valid`,
    `gslot`, `cols` are the flat batch; `key_idx` [Kb] the slot of each
    key row (K for a padding row), `sel` [Kb, E] each key's batch rows
    (-1 for none); `spec` the query's FilterSpec; `tick` marks a timer
    tick over every key.  A `batch()` slab narrower than E grows first.
    Moves the slab in place; returns (Rows of exactly the emitted rows,
    i64[2] [least wake, rows missed])."""
    fit(slab, int(sel.shape[1]))
    if ts.is_cuda:
        return launch(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                      sel, now, prm, tick=tick)
    return plain(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
                 now, prm)


def fit(slab: KeyedSlab, E: int) -> None:
    """Grow a `batch()` slab narrower than a step's widest key row (E
    events) to the next power of two, so every key's chunk fits."""
    if slab.mode == MODE_CHUNK and E > slab.C:
        slab.grow(1 << (E - 1).bit_length())


# ---------------------------------------------------------------------------
# the plain versions: each reference `process` written out over [Kb, ...]
# ---------------------------------------------------------------------------

class _Keys:
    """A step's gathered key rows: the kept arrivals of each key row
    compacted to the front in batch order ([Kb, E]: ts, gslot, columns,
    their sel column `pos`, `valid` for k < ncur), the keys' counters,
    and `timer`, whether the row holds a valid TIMER row."""

    def __init__(self, slab, spec, ts, kind, valid, gslot, cols, key_idx,
                 sel, now):
        dev = slab.ts.device
        self.dev, self.C, self.types = dev, slab.C, slab.types
        self.Kb, self.E = sel.shape
        K = slab.K
        keep = _keep(spec, ts, kind, valid, cols, now)
        self.live = key_idx.long() < K
        self.kidx = key_idx.long().clamp(0, K - 1)
        sidx = sel.long().clamp(min=0)
        has = (sel >= 0) & self.live[:, None]
        evm = has & keep[sidx]
        self.timer = (has & valid[sidx] & (kind[sidx] == ev.TIMER)).any(1)
        order = torch.argsort(torch.logical_not(evm).to(torch.int8), dim=1,
                              stable=True)
        src = torch.gather(sidx, 1, order)
        self.ncur = evm.sum(1)
        self.kk = torch.arange(self.E, device=dev)[None, :]
        self.ar = torch.arange(self.C, device=dev)[None, :]
        self.valid = self.kk < self.ncur[:, None]
        self.pos = order
        self.ts, self.gs = ts[src], gslot[src]
        self.cols = [(c.to(torch.int32) if c.dtype == torch.bool else c)[src]
                     for c in cols]
        self.seq0 = slab.seq[self.kidx]
        self.cnt = slab.count[self.kidx].long()

    def full(self, shape, v, d):
        return torch.full(shape, v, dtype=d, device=self.dev)

    def block(self, slab, prev=False):
        """The key rows' slab block (ts, gslot, columns) and alive mask."""
        k = self.kidx
        if prev:
            return (slab.p_ts[k], slab.p_gslot[k], [c[k] for c in slab.p_cols],
                    self.ar < slab.p_count[k].long()[:, None])
        return (slab.ts[k], slab.gslot[k], [c[k] for c in slab.cols],
                self.ar < self.cnt[:, None])

    def part(self, ts, kind, valid, seq, gs, cols):
        return (ts, self.full(ts.shape, kind, torch.int32), valid, seq, gs,
                list(cols))

    def reset(self, mask, seq, now):
        """One RESET row per key row where `mask` ([Kb])."""
        Kb = self.Kb
        return (self.full((Kb, 1), now, torch.int64),
                self.full((Kb, 1), ev.RESET, torch.int32), mask[:, None],
                seq[:, None], self.full((Kb, 1), -1, torch.int32),
                [self.full((Kb, 1), ev.default_value(tp), slab_dtype(tp))
                 for tp in self.types])

    def rows(self, parts):
        return _rows(parts, self.Kb, self.dev, self.types)

    def store(self, dst, src):
        """Write the live key rows' new values into a slab tensor."""
        dst[self.kidx[self.live]] = src[self.live].to(dst.dtype)


def _rank(keys, valid):
    """Each place's rank in the stable order of `keys` along dim 1 (the
    invalid places keyed BIG_SEQ, after every valid one)."""
    k = torch.where(valid, keys, torch.full_like(keys, BIG_SEQ))
    order = torch.argsort(k, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(k.shape[1], device=k.device)
                  .expand_as(k).contiguous())
    return rank


def _compact(g: _Keys, vals, mask, dest, width=None):
    """[Kb, C] blocks (C the slab's, or `width`) of the candidates `mask`
    placed at `dest` (those past C drop); returns them and the rows
    dropped per key row."""
    C = width or g.C
    w = mask & (dest < C)
    r = torch.arange(g.Kb, device=g.dev)[:, None].expand_as(w)[w]
    out = []
    for v in vals:
        o = torch.zeros((g.Kb, C), dtype=v.dtype, device=g.dev)
        o[r, dest[w]] = v[w]
        out.append(o)
    return out, (mask & (dest >= C)).sum(1)


def _store_block(g: _Keys, slab, new, count, prev=False):
    if prev:
        dst = [slab.p_ts, slab.p_gslot, *slab.p_cols]
        cnt = slab.p_count
    else:
        dst = [slab.ts, slab.gslot, *slab.cols]
        cnt = slab.count
    for d, s in zip(dst, new):
        g.store(d, s)
    g.store(cnt, count)


def _least(g: _Keys, wk):
    wk = wk[g.live]
    return int(wk.min()) if wk.numel() else NO_WAKEUP


def plain(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
          now: int, prm: ExtParams):
    """The plain PyTorch version (the kernels' reference): batched ops over
    the gathered [Kb, ...] state, step for step as the reference's `vmap`
    over `window.process`, then the write back of the live key rows."""
    global plain_calls
    plain_calls += 1
    g = _Keys(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel, now)
    fn = {MODE_EXT: _plain_ext, MODE_TLEN: _plain_tlen,
          MODE_DELAY: _plain_delay, MODE_XBATCH: _plain_xbatch,
          MODE_CHUNK: _plain_chunk, MODE_CRON: _plain_cron,
          MODE_SORT: _plain_sort, MODE_HOP: _plain_hop}[slab.mode]
    return fn(g, slab, now, prm)


def _cat(*xs):
    return torch.cat(xs, 1)


def _plain_ext(g: _Keys, slab, now, prm):
    """externalTime (`ExternalTimeWindow.process`)."""
    t, C, i64 = prm.t, g.C, torch.int64
    b_ts, b_gs, b_cols, alive = g.block(slab)
    b_ets = b_cols[prm.ts_pos].to(i64)
    a_ets = g.cols[prm.ts_pos].to(i64)
    ext_now = torch.where(g.valid, a_ets, -BIG_SEQ).max(1).values[:, None]
    due_b = alive & (b_ets + t <= ext_now)
    due_a = g.valid & (a_ets + t <= ext_now)
    rank = _rank(_cat(2 * (b_ets + t), 2 * (a_ets + t), 2 * a_ets + 1),
                 _cat(due_b, due_a, g.valid))
    s0 = g.seq0[:, None]
    E = g.E
    out = g.rows([
        g.part(b_ets + t, ev.EXPIRED, due_b & g.live[:, None],
               s0 + rank[:, :C], b_gs, b_cols),
        g.part(a_ets + t, ev.EXPIRED, due_a, s0 + rank[:, C:C + E], g.gs,
               g.cols),
        g.part(g.ts, ev.CURRENT, g.valid, s0 + rank[:, C + E:], g.gs,
               g.cols)])
    # survivors sorted by (event time, candidate position); the oldest
    # beyond C drop
    keep = _cat(alive & ~due_b, g.valid & ~due_a)
    srank = _rank(_cat(b_ets, a_ets), keep)
    total = keep.sum(1)
    drop = (total - C).clamp(min=0)
    new, _ = _compact(g, [_cat(b_ts, g.ts), _cat(b_gs, g.gs),
                          *(_cat(b, a) for b, a in zip(b_cols, g.cols))],
                      keep & (srank >= drop[:, None]),
                      srank - drop[:, None])
    _store_block(g, slab, new, total.clamp(max=C))
    nem = due_b.sum(1) + due_a.sum(1) + g.ncur
    g.store(slab.seq, g.seq0 + nem)
    return out, _wake(NO_WAKEUP, int(drop[g.live].sum()), g.dev)


def _plain_tlen(g: _Keys, slab, now, prm):
    """timeLength (`TimeLengthWindow.process`)."""
    t, n, C, i64 = prm.t, prm.length, g.C, torch.int64
    b_ts, b_gs, b_cols, alive = g.block(slab)
    due = alive & (b_ts + t <= now)
    keep_old = alive & ~due
    count0 = keep_old.sum(1)
    # the survivors compacted (slab order), then the arrivals
    srank = torch.cumsum(keep_old.to(i64), 1) - 1
    sv, _ = _compact(g, [b_ts, b_gs, *b_cols], keep_old, srank)
    c_ts, c_gs, c_cols = _cat(sv[0], g.ts), _cat(sv[1], g.gs), \
        [_cat(s, a) for s, a in zip(sv[2:], g.cols)]

    def virt(v):
        """Candidate column of virtual index v (survivor, else arrival)."""
        return torch.where(v < count0[:, None], v,
                           C + v - count0[:, None]).clamp(0, C + g.E - 1)
    evict = count0[:, None] + g.kk - n
    has_ev = g.valid & (evict >= 0)
    ep = virt(evict)
    rank = _rank(_cat(4 * (b_ts + t), 4 * g.ts + 1, 4 * g.ts + 2),
                 _cat(due, has_ev, g.valid))
    s0 = g.seq0[:, None]
    E = g.E
    out = g.rows([
        g.part(b_ts + t, ev.EXPIRED, due & g.live[:, None], s0 + rank[:, :C],
               b_gs, b_cols),
        g.part(g.ts, ev.EXPIRED, has_ev, s0 + rank[:, C:C + E],
               torch.gather(c_gs, 1, ep),
               [torch.gather(c, 1, ep) for c in c_cols]),
        g.part(g.ts, ev.CURRENT, g.valid, s0 + rank[:, C + E:], g.gs,
               g.cols)])
    total = count0 + g.ncur
    start = (total - n).clamp(min=0)
    take = g.ar + start[:, None]
    tvalid = take < total[:, None]
    # the kept arrivals in the order of their add_seq (their CURRENT rank:
    # by (ts, k)), after the survivors
    arr = tvalid & (take >= count0[:, None])
    a_key = torch.where(arr, torch.gather(c_ts, 1, virt(take)), -BIG_SEQ)
    tp = torch.gather(virt(take), 1, torch.argsort(
        torch.where(tvalid, a_key, BIG_SEQ), dim=1, stable=True))
    new = [torch.gather(x, 1, tp) for x in (c_ts, c_gs, *c_cols)]
    cnt = tvalid.sum(1)
    _store_block(g, slab, new, cnt)
    nem = due.sum(1) + has_ev.sum(1) + g.ncur
    g.store(slab.seq, g.seq0 + nem)
    wk = torch.where(tvalid, new[0], BIG_SEQ).min(1).values
    wk = torch.where(cnt > 0, wk + t, NO_WAKEUP)
    return out, _wake(_least(g, wk), 0, g.dev)


def _plain_delay(g: _Keys, slab, now, prm):
    """delay (`DelayWindow.process`)."""
    t, C, i64 = prm.t, g.C, torch.int64
    b_ts, b_gs, b_cols, alive = g.block(slab)
    c_ts, c_gs = _cat(b_ts, g.ts), _cat(b_gs, g.gs)
    c_cols = [_cat(b, a) for b, a in zip(b_cols, g.cols)]
    c_alive = _cat(alive, g.valid)
    rel = c_ts + t
    release = c_alive & (rel <= now) & g.live[:, None]
    rank = _rank(rel, release)
    out = g.rows([g.part(c_ts, ev.CURRENT, release, g.seq0[:, None] + rank,
                         c_gs, c_cols)])
    keep = c_alive & ~release
    new, missed = _compact(g, [c_ts, c_gs, *c_cols], keep,
                           torch.cumsum(keep.to(i64), 1) - 1)
    cnt = keep.sum(1).clamp(max=C)
    _store_block(g, slab, new, cnt)
    g.store(slab.seq, g.seq0 + release.sum(1))
    wk = torch.where(g.ar < cnt[:, None], new[0], BIG_SEQ).min(1).values
    wk = torch.where(cnt > 0, wk + t, NO_WAKEUP)
    return out, _wake(_least(g, wk), int(missed[g.live].sum()), g.dev)


def _flush_rows(g: _Keys, now, flush, q, s_reset, cur_parts):
    """A batch flush's rows: the previous block `q` (ts, gslot, columns,
    alive) EXPIRED at seq0 + rank, a RESET row at seq0 + s_reset, then
    `cur_parts` (ts, gslot, columns, mask, rank) CURRENT at seq0 +
    s_reset + 1 + rank."""
    fl = (flush & g.live)[:, None]
    s0 = g.seq0[:, None]
    q_ts, q_gs, q_cols, q_alive = q
    parts = [g.part(q_ts, ev.EXPIRED, q_alive & fl, s0 + g.ar, q_gs, q_cols),
             g.reset(flush & g.live, g.seq0 + s_reset, now)]
    for c_ts, c_gs, c_cols, m, r in cur_parts:
        parts.append(g.part(c_ts, ev.CURRENT, m & fl,
                            s0 + s_reset[:, None] + 1 + r, c_gs, c_cols))
    return g.rows(parts)


def _plain_xbatch(g: _Keys, slab, now, prm):
    """externalTimeBatch (`ExternalTimeBatchWindow.process`)."""
    t, C, E, i64 = prm.t, g.C, g.E, torch.int64
    p_ts, p_gs, p_cols, p_alive = g.block(slab)
    q = g.block(slab, prev=True)
    ets = g.cols[prm.ts_pos].to(i64)
    anyc = g.ncur > 0
    first = torch.where(g.valid, ets, BIG_SEQ).min(1).values
    last = torch.where(g.valid, ets, -BIG_SEQ).max(1).values
    start0 = slab.key_state["start"][g.kidx]
    start = torch.where(start0 >= 0, start0, first)
    nflush = torch.where(anyc, torch.div((last - start).clamp(min=0), t,
                                         rounding_mode="floor"), 0)
    flush = nflush > 0
    boundary = start + torch.where(flush, nflush, 1) * t
    to_pend = g.valid & (ets < boundary[:, None])
    to_next = g.valid & ~to_pend
    arr_rank = g.cnt[:, None] + torch.cumsum(to_pend.to(i64), 1) - 1
    out = _flush_rows(g, now, flush, q, torch.full_like(g.seq0, C),
                      [(p_ts, p_gs, p_cols, p_alive, g.ar),
                       (g.ts, g.gs, g.cols, to_pend, arr_rank)])
    fl = flush[:, None]
    c_vals = [_cat(p_ts, g.ts), _cat(p_gs, g.gs),
              *(_cat(p, a) for p, a in zip(p_cols, g.cols))]
    # the new pending block: the later arrivals after a flush, else the
    # pending rows and the arrivals
    pend_m = _cat(p_alive & ~fl, torch.where(fl, to_next, to_pend))
    pend_r = _cat(g.ar.expand_as(p_alive),
                  torch.where(fl, torch.cumsum(to_next.to(i64), 1) - 1,
                              arr_rank))
    new_p, miss_p = _compact(g, c_vals, pend_m, pend_r)
    # the new previous block (a flush): the pending rows and the arrivals
    # before the boundary
    prev_m = _cat(p_alive, to_pend) & fl
    new_q, miss_q = _compact(g, c_vals, prev_m,
                             _cat(g.ar.expand_as(p_alive), arr_rank))
    q_keep = [q[0], q[1], *q[2]]
    new_q = [torch.where(fl, a, b) for a, b in zip(new_q, q_keep)]
    _store_block(g, slab, new_q, torch.where(
        flush, prev_m.sum(1).clamp(max=C), slab.p_count[g.kidx].long()),
        prev=True)
    _store_block(g, slab, new_p, pend_m.sum(1).clamp(max=C))
    nstart = torch.where((start0 >= 0) | anyc,
                         torch.where(flush, start + nflush * t, start), -1)
    g.store(slab.key_state["start"], nstart)
    g.store(slab.seq, torch.where(flush, g.seq0 + 2 * C + E + 2, g.seq0))
    return out, _wake(NO_WAKEUP, int((miss_p + miss_q)[g.live].sum()),
                      g.dev)


def _plain_chunk(g: _Keys, slab, now, prm):
    """batch() (`ChunkBatchWindow.process`)."""
    i64 = torch.int64
    q = g.block(slab)
    flush = g.ncur > 0
    out = _flush_rows(g, now, flush, q, g.cnt,
                      [(g.ts, g.gs, g.cols, g.valid, g.kk)])
    fl = flush[:, None]
    new, missed = _compact(g, [g.ts, g.gs, *g.cols], g.valid,
                           g.kk.expand_as(g.valid))
    old = [q[0], q[1], *q[2]]
    C = g.C
    new = [torch.where(fl, a, b) for a, b in zip(new, old)]
    _store_block(g, slab, new, torch.where(flush, g.ncur.clamp(max=C),
                                           g.cnt))
    g.store(slab.seq, torch.where(flush, g.seq0 + g.cnt + 1 + g.ncur,
                                  g.seq0))
    return out, _wake(NO_WAKEUP, int(missed[g.live].sum()), g.dev)


def _plain_cron(g: _Keys, slab, now, prm):
    """cron (`CronWindow.process`): a key row with a TIMER row flushes."""
    C, i64 = g.C, torch.int64
    p_ts, p_gs, p_cols, p_alive = g.block(slab)
    q = g.block(slab, prev=True)
    flush = g.timer
    out = _flush_rows(g, now, flush, q, torch.full_like(g.seq0, C),
                      [(p_ts, p_gs, p_cols, p_alive, g.ar)])
    fl = flush[:, None]
    base = torch.where(flush, 0, g.cnt)
    pend_m = _cat(p_alive & ~fl, g.valid)
    pend_r = _cat(g.ar.expand_as(p_alive), base[:, None] + g.kk)
    new_p, missed = _compact(
        g, [_cat(p_ts, g.ts), _cat(p_gs, g.gs),
            *(_cat(p, a) for p, a in zip(p_cols, g.cols))], pend_m, pend_r)
    new_q = [torch.where(fl, a, b) for a, b in
             zip([p_ts, p_gs, *p_cols], [q[0], q[1], *q[2]])]
    _store_block(g, slab, new_q, torch.where(flush, g.cnt,
                                             slab.p_count[g.kidx].long()),
                 prev=True)
    _store_block(g, slab, new_p, pend_m.sum(1).clamp(max=C))
    g.store(slab.seq, torch.where(flush, g.seq0 + 2 * C + 1, g.seq0))
    return out, _wake(NO_WAKEUP, int(missed[g.live].sum()), g.dev)


def _plain_sort(g: _Keys, slab, now, prm):
    """sort (`SortWindow.process`) over the reference's C + E places."""
    C, E, i64 = g.C, g.E, torch.int64
    b_ts, b_gs, b_cols, alive = g.block(slab)
    kc = _cat(b_cols[prm.key_pos], g.cols[prm.key_pos])
    keys = sort_keys(kc, prm.desc)
    dead = DEAD_FLOAT if kc.dtype.is_floating_point else DEAD_INT
    c_alive = _cat(alive, g.valid)
    # candidate places: the slab's row j at j, arrival k at C + its column
    place = _cat(g.ar.expand_as(alive), C + g.pos)
    full = torch.full((g.Kb, C + E), dead, dtype=i64, device=g.dev)
    r, c = torch.nonzero(c_alive, as_tuple=True)
    full[r, place[r, c]] = keys[r, c]
    order = torch.argsort(full, dim=1, stable=True)
    prank = torch.empty_like(order)
    prank.scatter_(1, order, torch.arange(C + E, device=g.dev)
                   .expand_as(full).contiguous())
    rank = torch.gather(prank, 1, place)
    total = c_alive.sum(1)
    keep = c_alive & (rank < torch.minimum(total, torch.full_like(
        total, prm.length))[:, None])
    evict = c_alive & ~keep & g.live[:, None]
    # the candidates in place order: the slab's rows, then the arrivals by
    # column (the compacted arrivals already are)
    c_ts, c_gs = _cat(b_ts, g.ts), _cat(b_gs, g.gs)
    c_cols = [_cat(b, a) for b, a in zip(b_cols, g.cols)]
    s0 = g.seq0[:, None]
    erank = torch.cumsum(evict.to(i64), 1) - 1
    out = g.rows([
        g.part(g.ts, ev.CURRENT, g.valid, s0 + g.kk, g.gs, g.cols),
        g.part(c_ts, ev.EXPIRED, evict, s0 + g.ncur[:, None] + erank, c_gs,
               c_cols)])
    new, _ = _compact(g, [c_ts, c_gs, *c_cols], keep,
                      torch.cumsum(keep.to(i64), 1) - 1)
    _store_block(g, slab, new, keep.sum(1).clamp(max=C))
    g.store(slab.seq, g.seq0 + g.ncur + evict.sum(1))
    return out, _wake(NO_WAKEUP, 0, g.dev)


def _plain_hop(g: _Keys, slab, now, prm):
    """hopping (`HoppingWindow.process`)."""
    win, hop, C, E, i64 = prm.win, prm.hop, g.C, g.E, torch.int64
    b_ts, b_gs, b_cols, alive = g.block(slab)
    next0 = slab.key_state["next"][g.kidx]
    first = torch.where(g.valid, g.ts, BIG_SEQ).min(1).values
    nxt = torch.where(next0 >= 0, next0,
                      torch.where(g.ncur > 0, first + hop, -1))
    flush = (nxt >= 0) & (now >= nxt)
    emit = torch.where(flush, nxt + torch.div(now - nxt, hop,
                                              rounding_mode="floor") * hop,
                       nxt)[:, None]
    c_ts, c_gs = _cat(b_ts, g.ts), _cat(b_gs, g.gs)
    c_cols = [_cat(b, a) for b, a in zip(b_cols, g.cols)]
    live = _cat(alive, g.valid)
    in_cur = live & (c_ts >= emit - win) & (c_ts < emit)
    pts = emit - hop
    in_prev = live & (c_ts >= pts - win) & (c_ts < pts)
    fl = (flush & g.live)[:, None]
    s0 = g.seq0[:, None]
    CB = C + E
    out = g.rows([
        g.part(c_ts, ev.EXPIRED, in_prev & fl,
               s0 + torch.cumsum(in_prev.to(i64), 1) - 1, c_gs, c_cols),
        g.reset(flush & g.live, g.seq0 + CB, now),
        g.part(c_ts, ev.CURRENT, in_cur & fl,
               s0 + CB + torch.cumsum(in_cur.to(i64), 1), c_gs, c_cols)])
    new_next = torch.where(flush, emit[:, 0] + hop, nxt)
    keep = live & torch.where(new_next[:, None] >= 0,
                              c_ts >= (new_next - win - hop)[:, None], True)
    new, missed = _compact(g, [c_ts, c_gs, *c_cols], keep,
                           torch.cumsum(keep.to(i64), 1) - 1)
    _store_block(g, slab, new, keep.sum(1).clamp(max=C))
    g.store(slab.key_state["next"], new_next)
    g.store(slab.seq, torch.where(flush, g.seq0 + 2 * CB + 2, g.seq0))
    wk = torch.where(new_next >= 0, new_next, NO_WAKEUP)
    return out, _wake(_least(g, wk), int(missed[g.live].sum()), g.dev)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

class ExtPlan(ctypes.Structure):
    """Mirrors `struct ExtPlan` in csrc/keyed_ext.cu."""
    _fields_ = (
        [(n, _L) for n in ("Kb", "E", "K", "C", "now", "t", "length", "win",
                           "hop", "cap", "dead", "ws_words")] +
        [(n, _I) for n in ("mode", "ncols", "code_len", "ts_pos", "key_pos",
                           "key_type", "desc", "ws_global")] +
        [("col_ty", _I * MAX_COLS), ("col_w", _I * MAX_COLS),
         ("col_def", _L * MAX_COLS), ("code", _I * MAX_CODE),
         ("ts", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("col", _P * MAX_COLS), ("key_idx", _P), ("sel", _P),
         ("s_ts", _P), ("s_gslot", _P), ("s_col", _P * MAX_COLS),
         ("count", _P), ("seq", _P), ("p_ts", _P), ("p_gslot", _P),
         ("p_col", _P * MAX_COLS), ("p_count", _P), ("kstate", _P),
         ("arr", _P), ("apos", _P), ("n_arr", _P), ("timer", _P),
         ("ocnt", _P), ("sums", _P), ("ws", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS), ("wake", _P),
         ("kmask", _P), ("hot", _P), ("mwords", _L), ("hot_grid", _L),
         ("in_sets", InSet * MAX_IN)])


def _check(x, name, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"keyed_ext: {name} must be a contiguous {list(shape)} {dtype} "
            f"tensor on {dev} (got {list(x.shape)} {x.dtype} on {x.device})")


def workspace_words(mode: int, C: int, E: int) -> int:
    """The int64 words of a K20 / K21 / K23 key row's workspace: the
    ranking keys, ranks, maps and the [C] staging array (none for the
    batch family)."""
    if mode in (MODE_XBATCH, MODE_CHUNK, MODE_CRON):
        return 1
    return 6 * (C + E) + 6 + C


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """K22's host-side choices for a step of capacity C and E events a
    key row: `block` whether block mode can run (a row's candidates
    C + E may pass SORT_LIMIT; each row then takes warp or block mode on
    the device by its own count), `hot_grid` its blocks, `ws_words` the
    int64 keys of each block's workspace slice, `mwords` the kept-mask
    words of a key row."""

    block: bool
    hot_grid: int
    ws_words: int
    mwords: int


def sort_plan(C: int, E: int, Kb: int) -> SortPlan:
    block = C + E > SORT_LIMIT
    grid = min(max(Kb, 1), SORT_HOT_GRID) if block else 0
    return SortPlan(block, grid, C + E if block else 0,
                    (C + E + 31) // 32)


def prepare(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
            sel, now: int, prm: ExtParams):
    """Check the inputs and fill a plan with the batch, the slab and the
    scratch; returns (plan, the tensors the launches read, which must stay
    referenced until both are queued: "sums" ends with the total, "wake"
    is [least wake, rows missed])."""
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    dev = slab.ts.device
    B = ts.shape[0]
    Kb, E = sel.shape
    K, C = slab.K, slab.C
    if len(slab.types) > MAX_COLS or len(cols) != len(slab.types):
        raise ValueError("keyed_ext: column count")
    if len(spec.bytecode) > MAX_CODE:
        raise ValueError("keyed_ext: filter bytecode too long")
    _check(ts, "ts", torch.int64, (B,), dev)
    _check(kind, "kind", torch.int32, (B,), dev)
    _check(valid, "valid", torch.bool, (B,), dev)
    _check(gslot, "gslot", torch.int32, (B,), dev)
    _check(key_idx, "key_idx", torch.int32, (Kb,), dev)
    _check(sel, "sel", torch.int32, (Kb, E), dev)
    pl = ExtPlan()
    pl.Kb, pl.E, pl.K, pl.C = Kb, E, K, C
    pl.now, pl.t, pl.length = int(now), int(prm.t), int(prm.length)
    pl.win, pl.hop, pl.cap = int(prm.win), int(prm.hop), 0
    pl.mode, pl.ncols = slab.mode, len(cols)
    pl.ts_pos, pl.key_pos, pl.desc = prm.ts_pos, prm.key_pos, int(prm.desc)
    if slab.mode == MODE_SORT:
        kdt = slab.cols[prm.key_pos].dtype
        pl.key_type = key_type(kdt)
        pl.dead = DEAD_FLOAT if kdt.is_floating_point else DEAD_INT
    pl.code_len = len(spec.bytecode)
    for j, w in enumerate(spec.bytecode):
        pl.code[j] = w
    keep = []
    two = slab.p_ts is not None
    for j, (c, tp) in enumerate(zip(cols, slab.types)):
        d = slab_dtype(tp)
        if c.dtype == torch.bool:
            c = c.to(torch.int32)
            keep.append(c)
        _check(c, f"column {j}", d, (B,), dev)
        _check(slab.cols[j], f"slab column {j}", d, (K, C), dev)
        pl.col_ty[j] = type_code(tp)
        pl.col_w[j] = torch.empty((), dtype=d).element_size()
        pl.col_def[j] = _nvcc.slot_bits(ev.default_value(tp), d)
        pl.col[j], pl.s_col[j] = c.data_ptr(), slab.cols[j].data_ptr()
        if two:
            _check(slab.p_cols[j], f"slab p_column {j}", d, (K, C), dev)
            pl.p_col[j] = slab.p_cols[j].data_ptr()
    _check(slab.ts, "slab ts", torch.int64, (K, C), dev)
    _check(slab.gslot, "slab gslot", torch.int32, (K, C), dev)
    _check(slab.count, "count", torch.int32, (K,), dev)
    _check(slab.seq, "seq", torch.int64, (K,), dev)
    pl.ts, pl.kind, pl.valid, pl.gslot = (ts.data_ptr(), kind.data_ptr(),
                                          valid.data_ptr(), gslot.data_ptr())
    pl.key_idx, pl.sel = key_idx.data_ptr(), sel.data_ptr()
    pl.s_ts, pl.s_gslot = slab.ts.data_ptr(), slab.gslot.data_ptr()
    pl.count, pl.seq = slab.count.data_ptr(), slab.seq.data_ptr()
    if two:
        _check(slab.p_ts, "slab p_ts", torch.int64, (K, C), dev)
        _check(slab.p_gslot, "slab p_gslot", torch.int32, (K, C), dev)
        _check(slab.p_count, "p_count", torch.int32, (K,), dev)
        pl.p_ts, pl.p_gslot = slab.p_ts.data_ptr(), slab.p_gslot.data_ptr()
        pl.p_count = slab.p_count.data_ptr()
    for n, x in slab.key_state.items():
        _check(x, n, torch.int64, (K,), dev)
        pl.kstate = x.data_ptr()

    def e(n, d=torch.int32):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    arr, apos = e(Kb * E), e(Kb * E)
    n_arr, timer, ocnt = e(Kb), e(Kb), e(Kb, torch.int64)
    sums = torch.zeros((Kb + 1023) // 1024 + 1, dtype=torch.int64,
                       device=dev)
    wake = torch.empty(2, dtype=torch.int64, device=dev)
    ws = kmask = hot = None
    if slab.mode == MODE_SORT:
        sp = sort_plan(C, E, Kb)
        kmask = e(Kb * sp.mwords)
        pl.kmask, pl.mwords = kmask.data_ptr(), sp.mwords
        if sp.block:
            hot = e(Kb + 1)
            ws = e(sp.hot_grid * sp.ws_words, torch.int64)
            pl.hot, pl.hot_grid, pl.ws = hot.data_ptr(), sp.hot_grid, \
                ws.data_ptr()
            pl.ws_words = sp.ws_words
    else:
        words = workspace_words(slab.mode, C, E)
        pl.ws_words = words
        if words * 8 > SMEM_MAX:
            # a key row's workspace past the shared memory: a global slice
            # for each of at most 1,024 blocks
            pl.ws_global = 1
            ws = e(min(max(Kb, 1), 1024) * words, torch.int64)
            pl.ws = ws.data_ptr()
    pl.arr, pl.apos, pl.n_arr, pl.timer = (arr.data_ptr(), apos.data_ptr(),
                                           n_arr.data_ptr(), timer.data_ptr())
    pl.ocnt, pl.sums, pl.wake = ocnt.data_ptr(), sums.data_ptr(), \
        wake.data_ptr()
    bufs = {"cols": keep, "sums": sums, "wake": wake,
            "scratch": (arr, apos, n_arr, timer, ocnt, ws, kmask, hot),
            "inputs": (ts, kind, valid, gslot, key_idx, sel),
            "sets": fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)}
    return pl, bufs


def _call(pl: ExtPlan, what: str, dev) -> None:
    fam = FAMILY[pl.mode]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("keyed_ext", f"siddhi_{fam}_{what}",
                      "siddhi_keyed_ext_plan_size", pl, stream)


def count(pl: ExtPlan, dev) -> None:
    """The first launch: each key row's kept arrivals and output rows, and
    their scan; the total lands in sums[-1]."""
    _call(pl, "count", dev)


def write(pl: ExtPlan, dev) -> None:
    """The second launch: each key's rows at its offset, its slab row
    moved in place, the least wake."""
    _call(pl, "write", dev)


def alloc_out(pl: ExtPlan, types, n: int, dev) -> Rows:
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
           sel, now: int, prm: ExtParams, n_out: Optional[int] = None,
           tick: bool = False):
    """Launch the step on the current stream: the count launch, one fetch
    of the total (it sizes the output), the write launch.  `n_out`, when
    the caller knows the total, skips the fetch (CUDA-graph timing)."""
    global launches, tick_launches
    dev = slab.ts.device
    pl, bufs = prepare(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                       sel, now, prm)
    count(pl, dev)
    n = int(bufs["sums"][-1]) if n_out is None else n_out
    out = alloc_out(pl, slab.types, n, dev)
    write(pl, dev)
    record_key_offsets(bufs["scratch"][4], sel.shape[0], n)
    launches += 1
    mode_launches[slab.mode] += 1
    tick_launches += int(tick)
    wake = bufs["wake"]
    del bufs
    return finish(out, slab.types, n), wake
