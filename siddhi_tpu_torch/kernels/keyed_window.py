"""Keyed window slab, wrapper and plain version of the `keyed_window` CUDA
kernel (K11).

The kernel (`siddhi_tpu_torch/csrc/keyed_window.cu`) replaces the window
half of the JAX package's keyed step `kstep`
(`siddhi_tpu/core/planner.py:539-584`): the pre-window filters, the
gather of each key's events to [Kb, E] by `sel_idx`, `window.process`
under `vmap` over a [K, ...] slab (`LengthWindow`, `TimeWindow`,
`LengthBatchWindow`, `siddhi_tpu/core/window.py:249`, `:346`, `:447`),
the scatter back that drops padding keys (`key_idx == K`), the flattening
of the [Kb, E_out] rows and the least wake over the keys.  Its
observable rows are the reference's valid rows, in the reference's
order: key-major (the order of `key_idx`), and within a key the order of
that key's own window step (each key numbers its rows from its own seq
counter):
  * `length(n)`: arrival k of a key evicts the key's oldest row when the
    window is full; EXPIRED k (seq0 + 2k, the original ts) comes just
    before CURRENT k (seq0 + 2k + 1); the counter advances by 2E';
  * `time(t)`: the key's rows with ts + t <= now come out EXPIRED with
    ts = ts + t, its arrivals CURRENT, in a stable order by
    (ts + t)*2 for the expiring rows (in buffer order) and ts*2 + 1 for
    the arrivals (in batch order), numbered seq0 + rank; the arrivals
    enter the buffer in that order and the oldest rows beyond the key's
    capacity C drop unemitted, as the reference drops them; the counter
    advances by C + E (E the batch's per-key width) when anything was
    emitted; the wake is the least ts + t alive after the step;
  * `lengthBatch(n)`: each completed batch f of the key emits the previous
    batch EXPIRED, a RESET row (ts = now, no group slot, default columns)
    and the batch CURRENT, at seq0 + f(2n+2) + [0, n), + n and
    + n + 1 + [0, n); the counter advances by (2n+2) per flush;
  * `session(gap)` (`SessionWindow.process`,
    `siddhi_tpu/core/window_ext.py:668`, with `t` the gap): a key whose
    last arrival is at least `gap` before `now` (decided before the
    step's arrivals) expires its session: every row EXPIRED with its own
    ts, in a stable ts order (late joins first), at seq0 + rank; while a
    session lives, an arrival older than start - gap is dropped; the
    others come out CURRENT at seq0 + expired + k and join the session
    (rows beyond C are counted in the wake's second word, on which the
    runtime raises; the reference drops them silently).  The key's
    `start` is its session's least arrival ts, `last` its latest (at
    least 0); the wake is last + gap; the counter advances by the rows
    emitted.  A session without a key (`session(gap)` at the top level)
    is this mode on a slab of one key.
  * `session(gap, key, allowed.latency)` (`SessionLatencyWindow.process`,
    `siddhi_tpu/core/window_ext.py:850`, `t` the gap, `lat` the latency):
    each key keeps a current session and one previous session, which
    lingers until its `alive` = end + gap + latency.  At the step's start
    a previous session whose alive time has come expires, then a current
    session whose gap has passed becomes the previous one (an older
    previous one expiring first).  Then each arrival in turn: into the
    current session if it is in [start, last + gap] (or there is none),
    or if it is late by at most the gap (extending the start back); a new
    session (the current one rotating to previous, an older previous one
    expiring) if it lies past last + gap; into the previous session if it
    is older than start - gap but not older than the previous start -
    gap; otherwise it is dropped (not emitted, not kept).  When a late
    arrival joins the current session, or pushes the previous session's
    end forward, and the previous end + gap reaches the current start -
    gap, the previous session merges into the current one (its rows after
    the current rows).  Every expiring session comes out EXPIRED in a
    stable ts order, numbered on from the key's counter as it expires;
    after them the kept arrivals come out CURRENT in batch order.  The
    key's `start` / `last` are the current session's, `p_start` /
    `p_last` / `p_alive` the previous one's (-1 for none); the wake is
    min(last + gap, p_alive).  Rows beyond C (of an append or a merge)
    are counted in the wake's second word; the reference drops them.
E' is the number of the key's events that are valid, CURRENT and pass
the filters.  Only valid rows come out: the output is exactly the
emitted rows, so it needs no valid mask.

Slab (`KeyedSlab`): per column a [K, C] tensor (bool columns as int32,
the bytecode's value slots), per key i32 `head` and `count` and i64
`seq`.  `length` and `time` keep each key's rows as a ring in arrival
order: logical row i at physical (head + i) mod C, `count` rows alive.
`lengthBatch` and `timeBatch` keep the pending batch at [0, count) and
the previous batch in the `p_*` columns at [0, p_count); `session` keeps
the session at [0, count), the latency form its current session there and
its previous one in the `p_*` columns at [0, p_count), each in the
reference's slab order (appends and merged rows at the tail).  A mode's
further per-key state (`KEY_STATE`, held in `key_state`): `timeBatch`'s
i64 `start` (-1 until the key's first arrival), `session`'s i64 `start`
and `last` (-1 while the key has no session; the latency form's also
`p_start`, `p_last` and `p_alive`, -1 while it has no previous session),
and the time window's i32
`ordered`, 1 where the key's alive rows are in timestamp order along the
ring (its expiring rows are then a prefix, which lets the kernel skip the
survivors when no arrival is older than the last of them).  A time
window's rows store no expire_ts: it is always ts + t.  Only alive rows
are defined.  The slabs of the keyed kernels K20-K23 (`kernels/keyed_ext.py`,
MODE_EXT to MODE_HOP) are KeyedSlabs too, each key's rows a compact
prefix (head 0): externalTimeBatch and cron keep their pending and
previous blocks as lengthBatch does, externalTimeBatch its `start` (the
window's start parameter for a fresh key, else -1; `key_init`) and
hopping its `next` boundary (-1 unset) in `key_state`; `grow` widens a
`batch()` slab to the widest key row of a step.  So are the slabs of
K24-K26: keyed frequent (MODE_FREQ) keeps its n counters in place, their
counts in `f_counts` [K, n] (0: free), key words in `f_keys` [K, n, nk]
and stored events in the main block; `expression` (MODE_EXPR) its rows
by age as a compact prefix; `expressionBatch` (MODE_EXPRB) its pending
run there and its previous batch in the `p_*` block of C + 1 rows.

`keyed_window_step` is what the keyed planner calls: CPU tensors run
`plain`, CUDA tensors launch the kernel; both return the rows and i64[2]
[least wake, missed].  `launches` / `plain_calls`
count them (one per step), `mode_launches` the launches by mode and
`tick_launches` those of timer ticks; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Sequence

import torch

from ..core import event as ev
from ..core.window import BIG_SEQ, NO_WAKEUP, Rows
from . import _nvcc
from .filter_bytecode import type_code
from .in_probe import MAX_IN, InSet, fill_sets

launches = 0
plain_calls = 0
mode_launches = [0] * 6
tick_launches = 0

(MODE_LENGTH, MODE_TIME, MODE_BATCH, MODE_TBATCH, MODE_SESSION,
 MODE_LATENCY) = range(6)
# the modes of the keyed kernels K20-K23 (`kernels/keyed_ext.py`), whose
# slabs are KeyedSlabs too: externalTime, timeLength, delay (K20),
# externalTimeBatch, batch, cron (K21), sort (K22), hopping (K23)
(MODE_EXT, MODE_TLEN, MODE_DELAY, MODE_XBATCH, MODE_CHUNK, MODE_CRON,
 MODE_SORT, MODE_HOP) = range(6, 14)
# keyed frequent / lossyFrequent (K24, `kernels/keyed_freq.py`) and the
# expression windows (K25 / K26, `kernels/expr_window.py`)
MODE_FREQ, MODE_EXPR, MODE_EXPRB = range(14, 17)
_TWO_BLOCKS = (MODE_BATCH, MODE_TBATCH, MODE_LATENCY, MODE_XBATCH,
               MODE_CRON, MODE_EXPRB)
# the per-key state a mode keeps beside head / count / seq (and p_count):
# name -> (dtype, the value of a key with no rows)
KEY_STATE = {MODE_TIME: {"ordered": (torch.int32, 1)},
             MODE_TBATCH: {"start": (torch.int64, -1)},
             MODE_SESSION: {"start": (torch.int64, -1),
                            "last": (torch.int64, -1)},
             MODE_LATENCY: {n: (torch.int64, -1) for n in (
                 "start", "last", "p_start", "p_last", "p_alive")},
             MODE_XBATCH: {"start": (torch.int64, -1)},
             MODE_HOP: {"next": (torch.int64, -1)}}
MAX_COLS, MAX_CODE, BLOCK = 16, 256, 128
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls, tick_launches
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0] * 6
    tick_launches = 0


def slab_dtype(attr_type: str) -> torch.dtype:
    """A column's dtype in the slab and inside the kernel."""
    d = ev.dtype_of(attr_type)
    return torch.int32 if d == torch.bool else d


class KeyedSlab:
    """Every key's window state (see the module docstring)."""

    def __init__(self, mode, types, ts, gslot, cols, head, count, seq,
                 p_ts=None, p_gslot=None, p_cols=None, p_count=None,
                 key_state=None, key_init=None, f_counts=None, f_keys=None):
        self.mode, self.types = mode, list(types)
        # keyed frequent: each key's n counters ([K, n]) and their key
        # words ([K, n, nk]); the stored events are the main block
        self.f_counts, self.f_keys = f_counts, f_keys
        self.ts, self.gslot, self.cols = ts, gslot, tuple(cols)
        self.head, self.count, self.seq = head, count, seq
        self.p_ts, self.p_gslot = p_ts, p_gslot
        self.p_cols = tuple(p_cols) if p_cols is not None else None
        self.p_count = p_count
        # the mode's KEY_STATE tensors, [K] each, and the value each takes
        # for a key with no rows where the window's parameters set it (an
        # externalTimeBatch's start)
        self.key_state = dict(key_state or {})
        self.key_init = dict(key_init or {})

    def init_value(self, name: str) -> int:
        return self.key_init.get(name, KEY_STATE[self.mode][name][1])

    @property
    def K(self) -> int:
        return self.ts.shape[0]

    @property
    def C(self) -> int:
        return self.ts.shape[1]

    @classmethod
    def empty(cls, mode: int, types: Sequence[str], K: int, C: int,
              device, key_init=None, nkeys: int = 0) -> "KeyedSlab":
        """A slab of K empty keys of C rows (for keyed frequent, C is its
        n counters of `nkeys` key words each)."""
        def z(d, shape=(K, C)):
            return torch.zeros(shape, dtype=d, device=device)

        def block(w=C):
            return (z(torch.int64, (K, w)), z(torch.int32, (K, w)),
                    tuple(z(slab_dtype(t), (K, w)) for t in types))
        ts, gslot, cols = block()
        extra = {}
        if mode in _TWO_BLOCKS:
            # an expressionBatch's previous batch holds a full run and its
            # triggering event: C + 1 rows
            p_ts, p_gslot, p_cols = block(C + 1 if mode == MODE_EXPRB
                                          else C)
            extra = dict(p_ts=p_ts, p_gslot=p_gslot, p_cols=p_cols,
                         p_count=z(torch.int32, (K,)))
        if mode == MODE_FREQ:
            extra = dict(f_counts=z(torch.int64),
                         f_keys=z(torch.int64, (K, C, nkeys)))
        key_init = dict(key_init or {})
        key_state = {n: torch.full((K,), key_init.get(n, v), dtype=d,
                                   device=device)
                     for n, (d, v) in KEY_STATE.get(mode, {}).items()}
        return cls(mode, types, ts, gslot, cols, z(torch.int32, (K,)),
                   z(torch.int32, (K,)), z(torch.int64, (K,)),
                   key_state=key_state, key_init=key_init, **extra)

    def tensors(self):
        out = [self.ts, self.gslot, *self.cols, self.head, self.count,
               self.seq]
        if self.mode in _TWO_BLOCKS:
            out += [self.p_ts, self.p_gslot, *self.p_cols, self.p_count]
        if self.mode == MODE_FREQ:
            out += [self.f_counts, self.f_keys]
        return out + list(self.key_state.values())

    def map(self, fn) -> "KeyedSlab":
        """A slab of `fn` applied to each of this slab's tensors."""
        def c(x):
            return None if x is None else fn(x)
        return KeyedSlab(
            self.mode, self.types, fn(self.ts), fn(self.gslot),
            [fn(x) for x in self.cols], fn(self.head), fn(self.count),
            fn(self.seq), c(self.p_ts), c(self.p_gslot),
            None if self.p_cols is None else [fn(x) for x in self.p_cols],
            c(self.p_count), {n: fn(x) for n, x in self.key_state.items()},
            self.key_init, c(self.f_counts), c(self.f_keys))

    def clone(self) -> "KeyedSlab":
        return self.map(lambda x: x.clone())

    def take_rows(self, idx, device) -> "KeyedSlab":
        """A slab of the key rows `idx`, on `device` (a shard's block)."""
        return self.map(lambda x: x[idx].to(device))

    def reset_keys(self, idx) -> None:
        """Empty the keys at `idx` (a purged partition key's slot)."""
        for x in (self.head, self.count, self.seq, self.p_count,
                  self.f_counts):
            if x is not None:
                x[idx] = 0
        for n in KEY_STATE.get(self.mode, {}):
            self.key_state[n][idx] = self.init_value(n)

    def grow(self, C: int) -> None:
        """Widen every key's blocks to C rows, their rows kept (`batch()`
        grows to the largest chunk a key receives)."""
        def wide(x):
            y = torch.zeros((self.K, C), dtype=x.dtype, device=x.device)
            y[:, :x.shape[1]] = x
            return y
        self.ts, self.gslot = wide(self.ts), wide(self.gslot)
        self.cols = tuple(wide(x) for x in self.cols)
        if self.p_ts is not None:
            self.p_ts, self.p_gslot = wide(self.p_ts), wide(self.p_gslot)
            self.p_cols = tuple(wide(x) for x in self.p_cols)

    def copy_from(self, other: "KeyedSlab") -> None:
        """Take `other`'s contents in place."""
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)

    def logical(self):
        """Every key's alive rows in window order, for comparisons: a dict
        of [K, C] tensors (positions past a key's count zeroed) and the
        per-key counters."""
        K, C = self.K, self.C
        ar = torch.arange(C, device=self.ts.device)
        if self.mode in _TWO_BLOCKS:
            pos = ar.expand(K, C)
        else:
            pos = torch.remainder(self.head.long()[:, None] + ar, C)
        alive = ar[None, :] < self.count.long()[:, None]
        if self.mode == MODE_FREQ:
            # the counters in use, in place; their keys and stored events
            alive = self.f_counts > 0

        def view(x):
            return torch.where(alive, torch.gather(x, 1, pos),
                               torch.zeros_like(x))
        out = {"ts": view(self.ts), "gslot": view(self.gslot),
               "count": self.count, "seq": self.seq}
        for j, c in enumerate(self.cols):
            out[f"col{j}"] = view(c)
        out.update(self.key_state)
        if self.mode == MODE_FREQ:
            out["f_counts"] = self.f_counts
            out["f_keys"] = torch.where(alive[:, :, None], self.f_keys,
                                        torch.zeros_like(self.f_keys))
        if self.mode in _TWO_BLOCKS:
            ar = torch.arange(self.p_ts.shape[1], device=self.ts.device)
            p_alive = ar[None, :] < self.p_count.long()[:, None]

            def pview(x):
                return torch.where(p_alive, x, torch.zeros_like(x))
            out.update({"p_ts": pview(self.p_ts),
                        "p_gslot": pview(self.p_gslot),
                        "p_count": self.p_count})
            for j, c in enumerate(self.p_cols):
                out[f"p_col{j}"] = pview(c)
        return out


def keyed_window_step(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols,
                      key_idx, sel, now: int, t: int = 0,
                      tick: bool = False, lat: int = 0):
    """One keyed step.  `ts`, `kind`, `valid`, `gslot`, `cols` are the flat
    batch; `key_idx` [Kb] the window slot of each key row (K for a padding
    row), `sel` [Kb, E] each key's batch rows (-1 for none); `spec` the
    query's `FilterSpec`; `t` the time window's length (the session gap);
    `tick` marks a timer tick over every key; `lat` the session's allowed
    latency.  Moves the slab in place; returns (Rows of exactly the
    emitted rows, i64[2] [least wake, rows missed])."""
    if ts.is_cuda:
        return launch(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                      sel, now, t, tick=tick, lat=lat)
    return plain(slab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
                 now, t, lat)


# ---------------------------------------------------------------------------
# the plain version: the reference's vmap step written out over [Kb, ...]
# ---------------------------------------------------------------------------

def _keep(spec, ts, kind, valid, cols, now):
    keep = torch.logical_and(valid, kind == ev.CURRENT)
    env = spec.env(cols, ts, now, kind)
    for c in spec.compiled:
        keep = torch.logical_and(keep, c.fn(env))
    return keep


_key_counts = threading.local()


@contextlib.contextmanager
def recording_key_counts():
    """Inside the block, every keyed window step of this thread (K11,
    K20-K26 and their plain versions) appends its emitted rows per key
    row ([Kb] int64, on the step's device) to the yielded list: the
    sharded keyed step places each shard's key-major rows in the merged
    output by them (`kernels/shard_route.py` `place`)."""
    prev = getattr(_key_counts, "out", None)
    _key_counts.out = got = []
    try:
        yield got
    finally:
        _key_counts.out = prev


def recording_counts() -> bool:
    return getattr(_key_counts, "out", None) is not None


def record_key_counts(counts: torch.Tensor) -> None:
    if recording_counts():
        _key_counts.out.append(counts)


def record_key_offsets(offsets: torch.Tensor, Kb: int, n: int) -> None:
    """`record_key_counts` from a launch's exclusive row offsets [Kb] and
    its total `n`."""
    if recording_counts():
        off = offsets[:Kb]
        record_key_counts(torch.diff(off, append=torch.full(
            (1,), n, dtype=off.dtype, device=off.device)))


def _rows(parts, Kb, dev, types):
    """Concatenate per-key row blocks [(ts, kind, valid, seq, gslot,
    cols)] along dim 1, order each key's rows by (valid first, seq) and
    return the valid ones, key-major."""
    cat = [torch.cat([p[i] for p in parts], 1) for i in range(5)]
    ccols = [torch.cat([p[5][j] for p in parts], 1)
             for j in range(len(types))]
    ts, kind, valid, seq, gs = cat
    key = torch.where(valid, seq, torch.full_like(seq, BIG_SEQ))
    order = torch.argsort(key, dim=1, stable=True)
    take = torch.gather(valid, 1, order)
    if recording_counts():
        record_key_counts(take.sum(1))
    take = take.reshape(-1)

    def g(x):
        return torch.gather(x, 1, order).reshape(-1)[take]
    n = int(take.sum())
    out_cols = tuple(g(c) != 0 if ev.dtype_of(t) == torch.bool else g(c)
                     for c, t in zip(ccols, types))
    return Rows(ts=g(ts), kind=g(kind),
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=g(seq), gslot=g(gs), cols=out_cols)


def plain(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx, sel,
          now: int, t: int = 0, lat: int = 0):
    """The plain PyTorch version (the kernel's reference): batched ops
    over the gathered [Kb, ...] state, step for step as the reference's
    `vmap` over `window.process`, then the scatter back."""
    global plain_calls
    plain_calls += 1
    dev = slab.ts.device
    K, C = slab.K, slab.C
    Kb, E = sel.shape
    types = slab.types
    i64 = torch.int64
    cols32 = [c.to(torch.int32) if c.dtype == torch.bool else c
              for c in cols]
    keep = _keep(spec, ts, kind, valid, cols, now)
    live = key_idx.long() < K
    kidx = key_idx.long().clamp(0, K - 1)
    sidx = sel.long().clamp(min=0)
    evm = (sel >= 0) & keep[sidx] & live[:, None]
    # each key's kept events compacted to the front, in batch order
    order = torch.argsort(torch.logical_not(evm).to(torch.int8), dim=1,
                          stable=True)
    src = torch.gather(sidx, 1, order)
    ncur = evm.sum(1)
    kk = torch.arange(E, device=dev)[None, :]
    a_valid = kk < ncur[:, None]
    a_ts, a_gs = ts[src], gslot[src]
    a_cols = [c[src] for c in cols32]
    seq0 = slab.seq[kidx]
    cnt = slab.count[kidx].long()
    ar = torch.arange(C, device=dev)[None, :]
    rows2 = kidx[:, None]

    def full(shape, v, d):
        return torch.full(shape, v, dtype=d, device=dev)

    if slab.mode in (MODE_LENGTH, MODE_TIME):
        head = slab.head[kidx].long()
        lpos = torch.remainder(head[:, None] + ar, C)
        b_ts = slab.ts[rows2, lpos]
        b_gs = slab.gslot[rows2, lpos]
        b_cols = [c[rows2, lpos] for c in slab.cols]

    if slab.mode == MODE_LENGTH:
        v = cnt[:, None] + kk - C                  # the entry arrival k evicts
        has_ev = a_valid & (v >= 0)
        old = v < cnt[:, None]
        vo = v.clamp(0, C - 1)
        va = (v - cnt[:, None]).clamp(0, E - 1)

        def evicted(b, a):
            return torch.where(old, torch.gather(b, 1, vo),
                               torch.gather(a, 1, va))
        exp = (evicted(b_ts, a_ts), full((Kb, E), ev.EXPIRED, torch.int32),
               has_ev, seq0[:, None] + 2 * kk, evicted(b_gs, a_gs),
               [evicted(b, a) for b, a in zip(b_cols, a_cols)])
        cur = (a_ts, full((Kb, E), ev.CURRENT, torch.int32), a_valid,
               seq0[:, None] + 2 * kk + 1, a_gs, a_cols)
        # EXPIRED k then CURRENT k: interleaved, already in seq order
        parts = [tuple(torch.stack([x, y], 2).reshape(Kb, 2 * E)
                       for x, y in zip(exp[:5], cur[:5])) +
                 ([torch.stack([x, y], 2).reshape(Kb, 2 * E)
                   for x, y in zip(exp[5], cur[5])],)]
        out = _rows(parts, Kb, dev, types)
        total = cnt + ncur
        start = (total - C).clamp(min=0)
        w = a_valid & (kk >= ncur[:, None] - C)    # the arrivals that stay
        dst = torch.remainder(head[:, None] + cnt[:, None] + kk, C)
        r, d = rows2.expand(Kb, E)[w], dst[w]
        slab.ts[r, d] = a_ts[w]
        slab.gslot[r, d] = a_gs[w]
        for sc, ac in zip(slab.cols, a_cols):
            sc[r, d] = ac[w]
        k_live = kidx[live]
        slab.head[k_live] = torch.remainder(head + start, C)[live].to(
            torch.int32)
        slab.count[k_live] = torch.minimum(total, torch.full_like(
            total, C))[live].to(torch.int32)
        slab.seq[k_live] = (seq0 + 2 * ncur)[live]
        return out, _wake(NO_WAKEUP, 0, dev)

    if slab.mode == MODE_TIME:
        alive = (ar < cnt[:, None]) & live[:, None]
        e_old = b_ts + t
        due = alive & (e_old <= now)
        big = full((1, 1), BIG_SEQ, i64)
        keys = torch.cat([torch.where(due, 2 * e_old, big),
                          torch.where(a_valid, 2 * a_ts + 1, big)], 1)
        m = torch.argsort(keys, dim=1, stable=True)
        rank = torch.empty_like(m)
        rank.scatter_(1, m, torch.arange(C + E, device=dev).expand(Kb, -1)
                      .contiguous())
        parts = [(e_old, full((Kb, C), ev.EXPIRED, torch.int32), due,
                  seq0[:, None] + rank[:, :C], b_gs, b_cols),
                 (a_ts, full((Kb, E), ev.CURRENT, torch.int32), a_valid,
                  seq0[:, None] + rank[:, C:], a_gs, a_cols)]
        out = _rows(parts, Kb, dev, types)
        # survivors keep their order, then the arrivals in emission order;
        # the oldest beyond C drop
        surv = alive & torch.logical_not(due)
        s_order = torch.argsort(torch.logical_not(surv).to(torch.int8),
                                dim=1, stable=True)
        nsurv = surv.sum(1)
        a_order = torch.argsort(keys[:, C:], dim=1, stable=True)
        total = nsurv + ncur
        drop = (total - C).clamp(min=0)
        ws = (ar < nsurv[:, None]) & (ar >= drop[:, None])
        ds = torch.remainder(head[:, None] + ar, C)
        wa = a_valid & (nsurv[:, None] + kk >= drop[:, None])
        da = torch.remainder(head[:, None] + nsurv[:, None] + kk, C)

        def put(dst_t, b, a):
            sb = torch.gather(b, 1, s_order)
            sa = torch.gather(a, 1, a_order)
            dst_t[rows2.expand(Kb, C)[ws], ds[ws]] = sb[ws]
            dst_t[rows2.expand(Kb, E)[wa], da[wa]] = sa[wa]
        new_ts = torch.cat([torch.where(ws, torch.gather(b_ts, 1, s_order),
                                        big),
                            torch.where(wa, torch.gather(a_ts, 1, a_order),
                                        big)], 1)
        put(slab.ts, b_ts, a_ts)
        put(slab.gslot, b_gs, a_gs)
        for sc, b, a in zip(slab.cols, b_cols, a_cols):
            put(sc, b, a)
        any_em = due.any(1) | (ncur > 0)
        k_live = kidx[live]
        slab.head[k_live] = torch.remainder(head + drop, C)[live].to(
            torch.int32)
        slab.count[k_live] = torch.minimum(total, torch.full_like(
            total, C))[live].to(torch.int32)
        slab.seq[k_live] = torch.where(any_em, seq0 + C + E, seq0)[live]
        # in order: each alive row no older than the one before it
        cnt2 = slab.count[kidx].long()
        pos2 = torch.remainder(slab.head[kidx].long()[:, None] + ar, C)
        r_ts = slab.ts[rows2, pos2]
        back = (r_ts[:, 1:] < r_ts[:, :-1]) & (ar[:, 1:] < cnt2[:, None])
        slab.key_state["ordered"][k_live] = torch.logical_not(back.any(1))[live].to(
            torch.int32)
        wk = new_ts.min(1).values + t
        wk = torch.where(new_ts.min(1).values < BIG_SEQ, wk,
                         torch.full_like(wk, NO_WAKEUP))
        wk = wk[live]
        wake = int(wk.min()) if wk.numel() else NO_WAKEUP
        return out, _wake(min(wake, NO_WAKEUP), 0, dev)

    if slab.mode == MODE_TBATCH:
        return _plain_tbatch(slab, now, t, Kb, E, dev, kidx, live, a_ts,
                             a_gs, a_cols, a_valid, ncur, seq0, cnt)
    if slab.mode == MODE_SESSION:
        return _plain_session(slab, now, t, Kb, dev, kidx, live, a_ts,
                              a_gs, a_cols, a_valid, seq0, cnt)
    if slab.mode == MODE_LATENCY:
        return _plain_latency(slab, now, t, lat, E, dev, kidx, live, a_ts,
                              a_gs, a_cols, a_valid, seq0, cnt)

    # ---- lengthBatch -------------------------------------------------------
    n = C
    fill0 = cnt
    pc = slab.p_count[kidx].long()
    g = fill0[:, None] + kk
    bidx = torch.div(g, n, rounding_mode="floor")
    pos = torch.remainder(g, n)
    nflush = torch.div(fill0 + ncur, n, rounding_mode="floor")
    nflush = torch.where(live, nflush, torch.zeros_like(nflush))
    span = 2 * n + 2
    p_ts, p_gs = slab.ts[kidx], slab.gslot[kidx]
    p_cols = [c[kidx] for c in slab.cols]
    q_ts, q_gs = slab.p_ts[kidx], slab.p_gslot[kidx]
    q_cols = [c[kidx] for c in slab.p_cols]
    p_alive = (ar < fill0[:, None]) & live[:, None]
    q_alive = (ar < pc[:, None]) & live[:, None]
    nf = nflush[:, None]
    s0 = seq0[:, None]
    F = E // n + 1
    f = torch.arange(F, device=dev)[None, :]
    cur_k = full((Kb, n), ev.CURRENT, torch.int32)
    exp_k = full((Kb, n), ev.EXPIRED, torch.int32)
    parts = [
        (p_ts, cur_k, p_alive & (nf > 0), s0 + n + 1 + ar, p_gs, p_cols),
        (a_ts, full((Kb, E), ev.CURRENT, torch.int32), a_valid & (bidx < nf),
         s0 + bidx * span + n + 1 + pos, a_gs, a_cols),
        (q_ts, exp_k, q_alive & (nf > 0), s0 + ar, q_gs, q_cols),
        (p_ts, exp_k, p_alive & (nf > 1), s0 + span + ar, p_gs, p_cols),
        (a_ts, full((Kb, E), ev.EXPIRED, torch.int32),
         a_valid & (bidx + 1 < nf), s0 + (bidx + 1) * span + pos, a_gs,
         a_cols),
        (full((Kb, F), now, i64), full((Kb, F), ev.RESET, torch.int32),
         (f < nf) & live[:, None], s0 + f * span + n,
         full((Kb, F), -1, torch.int32),
         [full((Kb, F), ev.default_value(tp), slab_dtype(tp))
          for tp in types])]
    out = _rows(parts, Kb, dev, types)
    # prev' = batch nflush - 1 (read before the pending batch moves)
    wq_p = p_alive & (nf == 1)
    wq_a = a_valid & (bidx == nf - 1)
    wp = a_valid & (bidx == nf)

    def put(dst_t, mask, vals, at):
        dst_t[rows2.expand_as(mask)[mask], at.expand_as(mask)[mask]] = \
            vals[mask]
    arb = ar.expand(Kb, n)
    put(slab.p_ts, wq_p, p_ts, arb)
    put(slab.p_gslot, wq_p, p_gs, arb)
    for sc, x in zip(slab.p_cols, p_cols):
        put(sc, wq_p, x, arb)
    put(slab.p_ts, wq_a, a_ts, pos)
    put(slab.p_gslot, wq_a, a_gs, pos)
    for sc, x in zip(slab.p_cols, a_cols):
        put(sc, wq_a, x, pos)
    put(slab.ts, wp, a_ts, pos)
    put(slab.gslot, wp, a_gs, pos)
    for sc, x in zip(slab.cols, a_cols):
        put(sc, wp, x, pos)
    k_live = kidx[live]
    slab.count[k_live] = (fill0 + ncur - nflush * n)[live].to(torch.int32)
    slab.p_count[k_live] = torch.where(nflush > 0, torch.full_like(pc, n),
                                       pc)[live].to(torch.int32)
    slab.seq[k_live] = (seq0 + nflush * span)[live]
    return out, _wake(NO_WAKEUP, 0, dev)


def _wake(w: int, missed, dev):
    return torch.tensor([w, int(missed)], dtype=torch.int64, device=dev)


def no_wake(dev):
    """[NO_WAKEUP, 0] made on the device (no host copy, so a CUDA graph
    can capture it)."""
    w = torch.zeros(2, dtype=torch.int64, device=dev)
    w[:1].fill_(NO_WAKEUP)
    return w


def _plain_tbatch(slab, now, t, Kb, E, dev, kidx, live, a_ts, a_gs, a_cols,
                  a_valid, ncur, seq0, cnt):
    """timeBatch's plain step over the gathered [Kb, ...] state, as the
    reference's `TimeBatchWindow.process` under `vmap`."""
    C, types, i64 = slab.C, slab.types, torch.int64
    ar = torch.arange(C, device=dev)[None, :]
    rows2 = kidx[:, None]

    def full(shape, v, d):
        return torch.full(shape, v, dtype=d, device=dev)
    start0 = slab.key_state["start"][kidx]
    first = torch.where(a_valid, a_ts, full(a_ts.shape, BIG_SEQ, i64)) \
        .min(1).values
    started, anyc = start0 >= 0, ncur > 0
    start = torch.where(started, start0, first)
    el = torch.where(started | anyc, now - start, 0).clamp(min=0)
    nflush = torch.where(live, torch.div(el, t, rounding_mode="floor"), 0)
    flush = nflush > 0
    boundary = start + torch.where(flush, nflush, 1) * t
    to_pend = a_valid & (a_ts < boundary[:, None])
    to_next = a_valid & ~to_pend
    r_pend = torch.cumsum(to_pend.to(i64), 1) - 1
    r_next = torch.cumsum(to_next.to(i64), 1) - 1
    n_in, n_next = to_pend.sum(1), to_next.sum(1)
    pc = slab.p_count[kidx].long()
    p_ts, p_gs = slab.ts[kidx], slab.gslot[kidx]
    p_cols = [c[kidx] for c in slab.cols]
    q_ts, q_gs = slab.p_ts[kidx], slab.p_gslot[kidx]
    q_cols = [c[kidx] for c in slab.p_cols]
    fl = (flush & live)[:, None]
    p_alive, q_alive = ar < cnt[:, None], ar < pc[:, None]
    s0 = seq0[:, None]
    pos_in = cnt[:, None] + r_pend
    parts = [
        (q_ts, full((Kb, C), ev.EXPIRED, torch.int32), q_alive & fl,
         s0 + ar, q_gs, q_cols),
        (full((Kb, 1), now, i64), full((Kb, 1), ev.RESET, torch.int32), fl,
         s0 + C, full((Kb, 1), -1, torch.int32),
         [full((Kb, 1), ev.default_value(tp), slab_dtype(tp))
          for tp in types]),
        (p_ts, full((Kb, C), ev.CURRENT, torch.int32), p_alive & fl,
         s0 + C + 1 + ar, p_gs, p_cols),
        (a_ts, full(a_ts.shape, ev.CURRENT, torch.int32), to_pend & fl,
         s0 + C + 1 + pos_in, a_gs, a_cols)]
    out = _rows(parts, Kb, dev, types)

    def put(dst_t, mask, vals, at):
        dst_t[rows2.expand_as(mask)[mask], at.expand_as(mask)[mask]] = \
            vals[mask]
    # a flush: the pending rows and the arrivals before the boundary become
    # the previous slice, the arrivals past it the pending one; otherwise
    # the arrivals before the boundary join the pending slice
    arb = ar.expand(Kb, C)
    wq_p, wq_a = p_alive & fl, to_pend & fl & (pos_in < C)
    wp_n = to_next & fl & (r_next < C)
    wp_i = to_pend & ~fl & live[:, None] & (pos_in < C)
    for dst, src_p, src_a, tgt_p, tgt_n in (
            (slab.p_ts, p_ts, a_ts, slab.ts, a_ts),
            (slab.p_gslot, p_gs, a_gs, slab.gslot, a_gs),
            *zip(slab.p_cols, p_cols, a_cols, slab.cols, a_cols)):
        put(dst, wq_p, src_p, arb)
        put(dst, wq_a, src_a, pos_in)
        put(tgt_p, wp_n, tgt_n, r_next)
        put(tgt_p, wp_i, tgt_n, pos_in)
    k_live = kidx[live]
    fill = cnt + n_in
    over = (fill - C).clamp(min=0)
    missed = torch.where(flush, over + (n_next - C).clamp(min=0), over)
    slab.count[k_live] = torch.where(flush, n_next.clamp(max=C),
                                     fill.clamp(max=C))[live].to(torch.int32)
    slab.p_count[k_live] = torch.where(flush, fill.clamp(max=C),
                                       pc)[live].to(torch.int32)
    nstart = torch.where(started | anyc,
                         torch.where(flush, start + nflush * t, start), -1)
    slab.key_state["start"][k_live] = nstart[live]
    slab.seq[k_live] = torch.where(flush, seq0 + 2 * C + E + 2,
                                   seq0)[live]
    wk = torch.where(nstart >= 0, nstart + t, NO_WAKEUP)[live]
    wake = int(wk.min()) if wk.numel() else NO_WAKEUP
    return out, _wake(wake, int(missed[live].sum()), dev)


def _plain_session(slab, now, gap, Kb, dev, kidx, live, a_ts, a_gs, a_cols,
                   a_valid, seq0, cnt):
    """session's plain step over the gathered [Kb, ...] state, as the
    reference's `SessionWindow.process` under `vmap`."""
    C, types, i64 = slab.C, slab.types, torch.int64
    big = torch.iinfo(i64).max
    ar = torch.arange(C, device=dev)[None, :]
    rows2 = kidx[:, None]
    start0 = slab.key_state["start"][kidx]
    last0 = slab.key_state["last"][kidx]
    expire = (last0 >= 0) & (last0 + gap <= now)
    alive_s = (last0 >= 0) & ~expire
    # too late: older than the live session's start - gap
    keep = a_valid & ~(alive_s[:, None] & (a_ts < (start0 - gap)[:, None]))
    k = torch.cumsum(keep.to(i64), 1) - 1
    ncur = keep.sum(1)
    b_ts, b_gs = slab.ts[kidx], slab.gslot[kidx]
    b_cols = [c[kidx] for c in slab.cols]
    b_alive = ar < cnt[:, None]
    order = torch.argsort(torch.where(b_alive, b_ts, torch.full_like(b_ts,
                                                                    big)),
                          dim=1, stable=True)
    ts_rank = torch.empty_like(order)
    ts_rank.scatter_(1, order, torch.arange(C, device=dev).expand(Kb, -1)
                     .contiguous())
    nexp = torch.where(expire, cnt, 0)
    s0 = seq0[:, None]
    parts = [(b_ts, torch.full((Kb, C), ev.EXPIRED, dtype=torch.int32,
                               device=dev),
              b_alive & (expire & live)[:, None], s0 + ts_rank, b_gs,
              b_cols),
             (a_ts, torch.full(a_ts.shape, ev.CURRENT, dtype=torch.int32,
                               device=dev),
              keep & live[:, None], s0 + nexp[:, None] + k, a_gs, a_cols)]
    out = _rows(parts, Kb, dev, types)
    fill0 = torch.where(expire, 0, cnt)
    pos = fill0[:, None] + k
    w = keep & live[:, None] & (pos < C)
    r, d = rows2.expand_as(w)[w], pos[w]
    slab.ts[r, d] = a_ts[w]
    slab.gslot[r, d] = a_gs[w]
    for sc, ac in zip(slab.cols, a_cols):
        sc[r, d] = ac[w]
    anyc = ncur > 0
    last_arr = torch.where(keep, a_ts, torch.full_like(a_ts, -1)).max(1) \
        .values
    min_arr = torch.where(keep, a_ts, torch.full_like(a_ts, big)).min(1) \
        .values
    nlast = torch.where(anyc, last_arr.clamp(min=0),
                        torch.where(expire, -1, last0))
    fresh = expire | (last0 < 0)
    nstart = torch.where(anyc, torch.where(fresh, min_arr,
                                           torch.minimum(start0, min_arr)),
                         torch.where(expire, -1, start0))
    k_live = kidx[live]
    total = fill0 + ncur
    slab.count[k_live] = total.clamp(max=C)[live].to(torch.int32)
    slab.seq[k_live] = (seq0 + nexp + ncur)[live]
    slab.key_state["start"][k_live] = nstart[live]
    slab.key_state["last"][k_live] = nlast[live]
    missed = int((total - C).clamp(min=0)[live].sum())
    wk = torch.where(nlast >= 0, nlast + gap, NO_WAKEUP)[live]
    wake = int(wk.min()) if wk.numel() else NO_WAKEUP
    return out, _wake(wake, missed, dev)


def _plain_latency(slab, now, gap, lat, E, dev, kidx, live, a_ts, a_gs,
                   a_cols, a_valid, seq0, cnt):
    """session(gap, key, allowed.latency)'s plain step over the gathered
    [Kb, ...] state, as the reference's `SessionLatencyWindow.process`
    under `vmap`: its batch-start timeouts, then its scan over each key's
    arrivals, a column of the [Kb, E] arrivals at a time."""
    C, types, i64 = slab.C, slab.types, torch.int64
    Kb = kidx.shape[0]
    big = torch.iinfo(i64).max
    ar = torch.arange(C, device=dev)[None, :]
    rk = torch.arange(Kb, device=dev)
    ks = slab.key_state
    cur = [slab.ts[kidx], slab.gslot[kidx], *(c[kidx] for c in slab.cols)]
    prev = [slab.p_ts[kidx], slab.p_gslot[kidx],
            *(c[kidx] for c in slab.p_cols)]
    cc, pc = cnt.clone(), slab.p_count[kidx].long()
    cs, cl = ks["start"][kidx], ks["last"][kidx]
    ps, pl, pa = ks["p_start"][kidx], ks["p_last"][kidx], ks["p_alive"][kidx]
    seq = seq0.clone()
    missed = torch.zeros(Kb, dtype=i64, device=dev)
    parts = []
    neg = torch.full_like(cs, -1)

    def emit(do):
        """The previous sessions of the keys `do` come out EXPIRED, in a
        stable ts order, numbered on from each key's counter."""
        nonlocal seq
        if not bool((do & live).any()):
            return
        alive = (ar < pc[:, None]) & (do & live)[:, None]
        order = torch.argsort(torch.where(alive, prev[0], big), dim=1,
                              stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, ar.expand(Kb, C).contiguous())
        parts.append((prev[0].clone(), torch.full((Kb, C), ev.EXPIRED,
                                                  dtype=torch.int32,
                                                  device=dev),
                      alive, seq[:, None] + rank, prev[1].clone(),
                      [x.clone() for x in prev[2:]]))
        seq = torch.where(do, seq + pc, seq)

    def rotate(do):
        """The current sessions of the keys `do` become their previous
        ones (the slab copied as it lies)."""
        nonlocal pc, ps, pl, pa, cc
        for j in range(len(cur)):
            prev[j] = torch.where(do[:, None], cur[j], prev[j])
        pc = torch.where(do, cc, pc)
        ps, pl = torch.where(do, cs, ps), torch.where(do, cl, pl)
        pa = torch.where(do, cl + gap + lat, pa)
        cc = torch.where(do, 0, cc)

    def append(blk, n, do, vals):
        """Each key `do` appends its event at its block's count (beyond C:
        missed)."""
        nonlocal missed
        w = do & (n < C)
        r = rk[w]
        for j, v in enumerate(vals):
            blk[j][r, n[w]] = v[w]
        missed = missed + (do & (n >= C)).to(i64)
        return n + w.to(i64)

    prev_has, cur_has = pl >= 0, cl >= 0
    pto = prev_has & (pa <= now)
    emit(pto)
    pc = torch.where(pto, 0, pc)
    ps, pl, pa = (torch.where(pto, neg, x) for x in (ps, pl, pa))
    prev_has = prev_has & ~pto
    cto = cur_has & (cl + gap <= now)
    emit(cto & prev_has)
    rotate(cto)
    cs, cl = torch.where(cto, neg, cs), torch.where(cto, neg, cl)
    kept = torch.zeros_like(a_valid)
    for e in range(E):
        t = a_ts[:, e]
        lv = a_valid[:, e] & live
        cur_has, prev_has = cl >= 0, pl >= 0
        cend = cl + gap
        in_cur = cur_has & (t >= cs) & (t <= cend)
        new_sess = cur_has & (t >= cs) & (t > cend)
        late_cur = cur_has & (t < cs) & (t >= cs - gap)
        late_prev = cur_has & (t < cs - gap) & prev_has & (t >= ps - gap)
        fresh = ~cur_has
        k = lv & (fresh | in_cur | new_sess | late_cur | late_prev)
        do_rot = lv & new_sess
        emit(do_rot & prev_has)
        rotate(do_rot)
        prev_has = prev_has | do_rot
        to_prev = lv & late_prev
        to_cur = k & ~late_prev
        vals = [t, a_gs[:, e], *(c[:, e] for c in a_cols)]
        cc = append(cur, cc, to_cur, vals)
        pc = append(prev, pc, to_prev, vals)
        cs = torch.where(to_cur, torch.where(fresh | do_rot, t,
                                             torch.minimum(cs, t)), cs)
        cl = torch.where(to_cur, torch.maximum(cl, t), cl)
        ps = torch.where(to_prev & (t < ps), t, ps)
        p_fwd = to_prev & (t > pl)
        pl = torch.where(p_fwd, t, pl)
        pa = torch.where(p_fwd, t + gap + lat, pa)
        can = prev_has & (cl >= 0) & (pl + gap >= cs - gap)
        merge = ((lv & late_cur) | p_fwd) & can
        # the previous rows after the current ones; beyond C: missed
        m = merge[:, None] & (ar < pc[:, None])
        dst = cc[:, None] + ar
        w = m & (dst < C)
        rr, ii = torch.nonzero(w, as_tuple=True)
        for j in range(len(cur)):
            cur[j][rr, dst[rr, ii]] = prev[j][rr, ii]
        missed = missed + (m & (dst >= C)).sum(1)
        cc = torch.where(merge, torch.clamp(cc + pc, max=C), cc)
        pc = torch.where(merge, 0, pc)
        cs = torch.where(merge, torch.minimum(cs, ps), cs)
        cl = torch.where(merge, torch.maximum(cl, pl), cl)
        ps, pl, pa = (torch.where(merge, neg, x) for x in (ps, pl, pa))
        kept[:, e] = k
    kr = torch.cumsum(kept.to(i64), 1) - 1
    parts.append((a_ts, torch.full(a_ts.shape, ev.CURRENT, dtype=torch.int32,
                                   device=dev), kept, seq[:, None] + kr, a_gs,
                  a_cols))
    seq = seq + kept.sum(1)
    out = _rows(parts, Kb, dev, types)
    k_live = kidx[live]
    for dst, src in zip([slab.ts, slab.gslot, *slab.cols], cur):
        dst[k_live] = src[live]
    for dst, src in zip([slab.p_ts, slab.p_gslot, *slab.p_cols], prev):
        dst[k_live] = src[live]
    slab.count[k_live] = cc[live].to(torch.int32)
    slab.p_count[k_live] = pc[live].to(torch.int32)
    slab.seq[k_live] = seq[live]
    for n, x in (("start", cs), ("last", cl), ("p_start", ps),
                 ("p_last", pl), ("p_alive", pa)):
        ks[n][k_live] = x[live]
    wk = torch.minimum(torch.where(cl >= 0, cl + gap, NO_WAKEUP),
                       torch.where(pl >= 0, pa, NO_WAKEUP))[live]
    wake = int(wk.min()) if wk.numel() else NO_WAKEUP
    return out, _wake(wake, int(missed[live].sum()), dev)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class KeyedPlan(ctypes.Structure):
    """Mirrors `struct KeyedPlan` in csrc/keyed_window.cu."""
    _fields_ = (
        [(n, _L) for n in ("Kb", "E", "K", "C", "now", "t", "lat", "cap")] +
        [("mode", _I), ("ncols", _I), ("code_len", _I), ("pad", _I),
         ("col_ty", _I * MAX_COLS), ("col_w", _I * MAX_COLS),
         ("col_def", _L * MAX_COLS), ("code", _I * MAX_CODE),
         ("ts", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("col", _P * MAX_COLS), ("key_idx", _P), ("sel", _P),
         ("s_ts", _P), ("s_gslot", _P), ("s_col", _P * MAX_COLS),
         ("head", _P), ("count", _P), ("seq", _P),
         ("p_ts", _P), ("p_gslot", _P), ("p_col", _P * MAX_COLS),
         ("p_count", _P), ("start", _P), ("ordered", _P), ("last", _P),
         ("p_start", _P), ("p_last", _P), ("p_alive", _P),
         ("late", _P), ("n_late", _P),
         ("seg", _P), ("n_seg", _P), ("x_ts", _P), ("x_gslot", _P),
         ("x_col", _P * MAX_COLS),
         ("arr", _P), ("n_arr", _P), ("ocnt", _P), ("block_sums", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_seq", _P),
         ("out_gslot", _P), ("out_col", _P * MAX_COLS), ("wake", _P),
         ("in_sets", InSet * MAX_IN)])


def _check(x, name, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"keyed_window: {name} must be a contiguous {list(shape)} "
            f"{dtype} tensor on {dev} (got {list(x.shape)} {x.dtype} on "
            f"{x.device})")


def prepare(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
            sel, now: int, t: int = 0, lat: int = 0):
    """Check the inputs and fill a plan with the batch, the slab and the
    scratch; returns (plan, a dict of the tensors the launches read,
    which must stay referenced until both are queued: "sums" ends with
    the total, "wake" is [least wake, rows missed])."""
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    dev = slab.ts.device
    B = ts.shape[0]
    Kb, E = sel.shape
    K, C = slab.K, slab.C
    if len(slab.types) > MAX_COLS or len(cols) != len(slab.types):
        raise ValueError("keyed_window: column count")
    _check(ts, "ts", torch.int64, (B,), dev)
    _check(kind, "kind", torch.int32, (B,), dev)
    _check(valid, "valid", torch.bool, (B,), dev)
    _check(gslot, "gslot", torch.int32, (B,), dev)
    _check(key_idx, "key_idx", torch.int32, (Kb,), dev)
    _check(sel, "sel", torch.int32, (Kb, E), dev)
    pl = KeyedPlan()
    pl.Kb, pl.E, pl.K, pl.C = Kb, E, K, C
    pl.now, pl.t, pl.lat, pl.cap = int(now), int(t), int(lat), 0
    pl.mode, pl.ncols = slab.mode, len(cols)
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
        sc = slab.cols[j]
        _check(sc, f"slab column {j}", d, (K, C), dev)
        pl.col_ty[j] = type_code(tp)
        pl.col_w[j] = torch.empty((), dtype=d).element_size()
        pl.col_def[j] = _nvcc.slot_bits(ev.default_value(tp), d)
        pl.col[j], pl.s_col[j] = c.data_ptr(), sc.data_ptr()
        if slab.mode in _TWO_BLOCKS:
            pl.p_col[j] = slab.p_cols[j].data_ptr()
    _check(slab.ts, "slab ts", torch.int64, (K, C), dev)
    _check(slab.gslot, "slab gslot", torch.int32, (K, C), dev)
    for x, name, d in ((slab.head, "head", torch.int32),
                       (slab.count, "count", torch.int32),
                       (slab.seq, "seq", torch.int64)):
        _check(x, name, d, (K,), dev)
    pl.ts, pl.kind, pl.valid, pl.gslot = (ts.data_ptr(), kind.data_ptr(),
                                          valid.data_ptr(), gslot.data_ptr())
    pl.key_idx, pl.sel = key_idx.data_ptr(), sel.data_ptr()
    pl.s_ts, pl.s_gslot = slab.ts.data_ptr(), slab.gslot.data_ptr()
    pl.head, pl.count, pl.seq = (slab.head.data_ptr(),
                                 slab.count.data_ptr(), slab.seq.data_ptr())
    if slab.mode in _TWO_BLOCKS:
        pl.p_ts, pl.p_gslot = slab.p_ts.data_ptr(), slab.p_gslot.data_ptr()
        pl.p_count = slab.p_count.data_ptr()
    for n, x in slab.key_state.items():
        _check(x, n, KEY_STATE[slab.mode][n][0], (K,), dev)
        setattr(pl, n, x.data_ptr())
    nb = max(1, (Kb + BLOCK - 1) // BLOCK)
    arr = torch.empty(max(Kb * E, 1), dtype=torch.int32, device=dev)
    n_arr = torch.empty(max(Kb, 1), dtype=torch.int32, device=dev)
    ocnt = torch.empty(max(Kb, 1), dtype=torch.int64, device=dev)
    block_sums = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    wake = torch.empty(2, dtype=torch.int64, device=dev)
    pl.arr, pl.n_arr, pl.ocnt = arr.data_ptr(), n_arr.data_ptr(), \
        ocnt.data_ptr()
    pl.block_sums, pl.wake = block_sums.data_ptr(), wake.data_ptr()
    scratch = (arr, n_arr, ocnt)
    if slab.mode == MODE_SESSION:
        # the key rows whose expiring session is out of ts order
        late = torch.empty(max(Kb, 1), dtype=torch.int32, device=dev)
        n_late = torch.empty(1, dtype=torch.int32, device=dev)
        pl.late, pl.n_late = late.data_ptr(), n_late.data_ptr()
        scratch += (late, n_late)
    if slab.mode == MODE_LATENCY:
        # the count of the sessions written out of ts order (kw_write lists
        # them, the rank launch writes them)
        n_seg = torch.empty(1, dtype=torch.int32, device=dev)
        pl.n_seg = n_seg.data_ptr()
        scratch += (n_seg,)
    bufs = {"cols": keep, "sums": block_sums, "wake": wake,
            "scratch": scratch,
            "inputs": (ts, kind, valid, gslot, key_idx, sel),
            "sets": fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)}
    return pl, bufs


def count(pl: KeyedPlan, dev) -> None:
    """The first launch: each key's kept arrivals and output rows, their
    scan; the total lands in block_sums[nb]."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("keyed_window", "siddhi_keyed_count",
                      "siddhi_keyed_plan_size", pl, stream)


def alloc_out(pl: KeyedPlan, types, n: int, dev, bufs=None) -> Rows:
    """Output rows for `n` emitted rows, their pointers set in `pl`; in
    latency mode also the scratch rows and the list of the sessions
    written out of ts order (kept in `bufs`)."""
    def e(d, m=n):
        return torch.empty(max(m, 1), dtype=d, device=dev)
    out = Rows(ts=e(torch.int64), kind=e(torch.int32), valid=None,
               seq=e(torch.int64), gslot=e(torch.int32),
               cols=tuple(e(slab_dtype(tp)) for tp in types))
    pl.cap = n
    pl.out_ts, pl.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    pl.out_seq, pl.out_gslot = out.seq.data_ptr(), out.gslot.data_ptr()
    for j, c in enumerate(out.cols):
        pl.out_col[j] = c.data_ptr()
    if pl.mode == MODE_LATENCY:
        # a listed session has at least 2 rows: n // 2 (offset, rows, seq)
        x = (e(torch.int64), e(torch.int32),
             tuple(e(slab_dtype(tp)) for tp in types),
             e(torch.int64, 3 * (n // 2 + 1)))
        pl.x_ts, pl.x_gslot, pl.seg = x[0].data_ptr(), x[1].data_ptr(), \
            x[3].data_ptr()
        for j, c in enumerate(x[2]):
            pl.x_col[j] = c.data_ptr()
        bufs["latency"] = x
    return out


def write(pl: KeyedPlan, dev) -> None:
    """The second launch: rows written at their keys' offsets (in session
    mode a rank launch first writes the sessions out of ts order; in
    latency mode one writes them after), the slab moved in place, the
    least wake."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("keyed_window", "siddhi_keyed_write",
                      "siddhi_keyed_plan_size", pl, stream)


def finish(out: Rows, types, n: int) -> Rows:
    dev = out.ts.device
    return Rows(ts=out.ts[:n], kind=out.kind[:n],
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                seq=out.seq[:n], gslot=out.gslot[:n],
                cols=tuple(c[:n] != 0 if ev.dtype_of(tp) == torch.bool
                           else c[:n] for c, tp in zip(out.cols, types)))


def launch(slab: KeyedSlab, spec, ts, kind, valid, gslot, cols, key_idx,
           sel, now: int, t: int = 0, n_out: Optional[int] = None,
           tick: bool = False, lat: int = 0):
    """Launch the step on the current stream: the count launch, one fetch
    of the total (it sizes the output), the write launch.  `n_out`, when
    the caller knows the total, skips the fetch (CUDA-graph timing)."""
    global launches, tick_launches
    dev = slab.ts.device
    pl, bufs = prepare(slab, spec, ts, kind, valid, gslot, cols, key_idx,
                       sel, now, t, lat)
    count(pl, dev)
    n = int(bufs["sums"][-1]) if n_out is None else n_out
    out = alloc_out(pl, slab.types, n, dev, bufs)
    write(pl, dev)
    if recording_counts():
        # K11's ocnt keeps each key row's row count (the write launch
        # rescans it for the offsets)
        record_key_counts(bufs["scratch"][2][:sel.shape[0]].clone())
    launches += 1
    mode_launches[slab.mode] += 1
    tick_launches += int(tick)
    wake = bufs["wake"]
    del bufs
    return finish(out, slab.types, n), wake
