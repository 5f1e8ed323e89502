"""Carry query state across from the JAX package.

Pattern queries: the JAX runtime's `PatternQueryRuntime.state` is
`((b32, b64, scalars), sel_state)`.  Its blobs are [W, K] with the key axis
minor, and the port's `StatePacker` lays its rows out identically, so the
state converts leaf for leaf.  That holds for every pattern plan: absent
atoms hold no capture rows in either package, and a block-NFA state
(non-partitioned simple chains, K = 1) carries its stale capture-ts rows
and zeroed count / lmask rows across as they are.

Single-stream queries: the JAX runtime's `QueryRuntime.state` is
`(window_state, selector_state)`.  The selector's state is one [K] array
per accumulator column, in the same order in both packages.  The window
state converts per window kind:
  * none: the seq counter;
  * `time`: (Buffer, seq), the buffer compacted in add_seq order, becomes
    the port's ring (`kernels/time_window.py` TimeRing) with the alive rows
    at [0, L); `ring_to_jax` goes back;
  * `lengthBatch`: (pending Buffer, previous Buffer, seq), each a compact
    prefix, becomes the port's BatchState.
  * `externalTime` / `timeLength` / `delay`: (Buffer, seq) becomes the
    port's `ExtState` (`kernels/ext_window.py`): the alive rows in the
    port's order (event time then position; add_seq; position) with their
    key (event time = expire_ts - t; expire_ts; the release time);
  * `externalTimeBatch`: (pending, previous, start, seq) as timeBatch;
  * `sort`: (Buffer, seq) becomes the port's `SortState`;
  * `session(gap)`: (Buffer, start, last, seq) becomes a one-key
    `KeyedSlab` in K11's session mode;
  * `batch`: (previous Buffer, seq) and `cron`: (pending, previous, seq)
    become the port's `TimeBatchState` as timeBatch's do;
  * `hopping`: (Buffer, next, seq) becomes the port's `HopState`;
  * `frequent` / `lossyFrequent`: (counts, keys, stored Buffer, seq)
    becomes the port's `FreqState`;
  * `session(gap, key, allowed.latency)` (keyed): per key the current and
    previous slabs (ts, alive, gslot, columns), their starts and lasts,
    the previous one's alive time and the seq, become a `KeyedSlab` in
    K11's latency mode (`latency_slab_from_jax`).
Both packages can then continue from the same mid-stream state.
`pair_allocators_from_jax` copies a distinctCount query's pair-slot
allocators (and its group-slot allocator) across.

Keyed windows (windows inside a partition): the JAX state is the
`vmap`-stacked per-key state, Buffers of [K, C] leaves (each key's alive
rows a compact prefix in add_seq order) and seq[K];
`keyed_slab_from_jax` makes the port's `KeyedSlab` (every key's ring at
head 0), `keyed_slab_to_jax` goes back (add_seq numbered below each key's
counter, in window order) and `keyed_slab_logical` reads either package's
keyed state as the same numpy view of every key's alive rows and
counters.  The keyed forms of K20-K23's windows carry across the same
way: externalTime, delay, sort (Buffer, seq), batch (previous Buffer,
seq) and hopping (Buffer, next, seq) as one block, externalTimeBatch
(pending, previous, start, seq) and cron (pending, previous, seq) as two;
a timeLength key's rows are put in add_seq order (the order its next
step reads them in), its buffer keeps them in position order.

Named windows: `named_window_from_jax` carries a JAX
`NamedWindowRuntime`'s window state through the same per-kind converters
(`window_state_from_jax`; a `length` window's compacted buffer becomes the
port's `LengthRing`).  Aggregations: `aggregation_from_jax` carries each
duration's allocator (mapping, free order and counters, so both list their
buckets in one order) and slab into the port's `AggregationRuntime`.

Tables: `table_from_jax` carries a JAX `TableRuntime`'s columns, ts,
valid, append pointer, free rows, primary-key allocator and @Index lane
tables into the port's table of the same definition; `table_to_numpy`
reads either package's table back out as numpy, so the tests can compare
the two after each op.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .core import event as ev


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(x, copy=True)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def _dev(device) -> torch.device:
    return torch.device(device) if device is not None \
        else torch.device("cpu")


def selector_state_from_jax(sel_state: Sequence, device=None) -> tuple:
    """The selector's per-slot accumulator columns, leaf for leaf."""
    return tuple(_t(s, _dev(device)) for s in sel_state)


def state_from_jax(b32, b64, scalars: Sequence, sel_state=(),
                   device=None) -> Tuple[tuple, tuple]:
    """numpy (or array-like) blobs of the JAX runtime -> the port's
    ((b32, b64, scalars), sel_state) on `device`."""
    device = _dev(device)
    t32 = _t(b32, device, torch.int32)
    t64 = _t(b64, device, torch.int64)
    scal = tuple(_t(s, device) for s in scalars)
    return (t32, t64, scal), selector_state_from_jax(sel_state, device)


def time_ring_from_jax(buf, seq, schema: ev.Schema, device=None):
    """A JAX TimeWindow state (Buffer, seq) -> the port's TimeRing of the
    same capacity, with the host facts the ring's rows imply."""
    from .kernels.time_window import RingFacts, TimeRing
    device = _dev(device)
    alive = np.asarray(buf.alive)
    L = int(alive.sum())
    if not alive[:L].all():
        raise ValueError("the JAX buffer is not a compact prefix")
    C = alive.shape[0]
    ring = TimeRing.empty(schema, C, device)
    for dst, src in ((ring.ts, buf.ts), (ring.add_seq, buf.add_seq),
                     (ring.expire_ts, buf.expire_ts),
                     (ring.gslot, buf.gslot), *zip(ring.cols, buf.cols)):
        dst.copy_(_t(src, device, dst.dtype))
    ring.meta.copy_(torch.tensor([0, L, int(seq), 0], dtype=torch.int64))
    exp = np.asarray(buf.expire_ts)[:L]
    f = RingFacts(C)
    if L:
        f.hmax = int(exp.max())
        f.sorted = bool(np.all(exp[1:] >= exp[:-1]))
        if not f.sorted:
            f.dis_until = f.hmax
        f.entries = [[int(exp.min()), f.hmax, L]]
    ring.facts = f
    return ring


def ring_to_jax(ring) -> Tuple["Buffer", int]:
    """The port's TimeRing -> the JAX TimeWindow layout: a Buffer of numpy
    columns (alive rows first, in add_seq order) and the seq counter."""
    from .core.window import BIG_SEQ, Buffer
    head, tail, seq, pos = ring.live()
    C, L = ring.C, tail - head
    p = pos.cpu().numpy()

    def col(x, fill):
        a = np.full(C, fill, dtype=x.cpu().numpy().dtype)
        a[:L] = x.cpu().numpy()[p]
        return a
    return Buffer(ts=col(ring.ts, 0), add_seq=col(ring.add_seq, BIG_SEQ),
                  expire_seq=np.full(C, BIG_SEQ, np.int64),
                  expire_ts=col(ring.expire_ts, BIG_SEQ),
                  alive=np.arange(C) < L, gslot=col(ring.gslot, -1),
                  cols=tuple(col(c, 0) for c in ring.cols)), seq


def length_ring_from_jax(buf, seq, schema: ev.Schema, device=None):
    """A JAX LengthWindow state (Buffer, the oldest alive row first, and
    seq = twice the arrivals so far) -> the port's LengthRing: the alive
    rows at logical positions [seq / 2 - L, seq / 2)."""
    from .kernels.length_window import LengthRing
    device = _dev(device)
    alive = np.asarray(buf.alive)
    L = int(alive.sum())
    if not alive[:L].all():
        raise ValueError("the JAX buffer is not a compact prefix")
    C = alive.shape[0]
    tail = int(seq) // 2
    head = tail - L
    pos = torch.from_numpy((head + np.arange(L)) % C).to(device)
    ring = LengthRing.empty(schema, C, device)
    for dst, src in ((ring.ts, buf.ts), (ring.gslot, buf.gslot),
                     *zip(ring.cols, buf.cols)):
        dst[pos] = _t(np.asarray(src)[:L], device, dst.dtype)
    ring.meta.copy_(torch.tensor([head, tail, int(seq), 0],
                                 dtype=torch.int64))
    return ring


def batch_state_from_jax(pend, prev, seq, schema: ev.Schema, n: int,
                         device=None):
    """A JAX LengthBatchWindow state (pending Buffer, previous Buffer,
    seq) -> the port's BatchState."""
    from .kernels.length_batch import BatchState
    device = _dev(device)
    st = BatchState.empty(schema, n, device)
    for (ts, gs, cols), buf in (((st.p_ts, st.p_gslot, st.p_cols), pend),
                                ((st.q_ts, st.q_gslot, st.q_cols), prev)):
        for dst, src in ((ts, buf.ts), (gs, buf.gslot),
                         *zip(cols, buf.cols)):
            dst.copy_(_t(src, device, dst.dtype))
    st.meta.copy_(torch.tensor(
        [int(np.asarray(pend.alive).sum()), int(np.asarray(prev.alive).sum()),
         int(seq)], dtype=torch.int64))
    return st


def time_batch_state_from_jax(pend, prev, start, seq, schema: ev.Schema,
                              C: int, device=None):
    """A JAX TimeBatchWindow state (pending Buffer, previous Buffer, slice
    start, seq) -> the port's TimeBatchState, its host mirror exact."""
    from .kernels.time_batch import TimeBatchState
    device = _dev(device)
    st = TimeBatchState.empty(schema, C, device)
    fills = []
    for b, buf in enumerate((pend, prev)):
        alive = np.asarray(buf.alive)
        n = int(alive.sum())
        if not alive[:n].all():
            raise ValueError("a timeBatch buffer is not compact")
        fills.append(n)
        for dst, src in ((st.b_ts[b], buf.ts), (st.b_gslot[b], buf.gslot),
                         *zip(st.b_cols[b], buf.cols)):
            dst.copy_(_t(src, device, dst.dtype))
    st.meta.copy_(torch.tensor([int(start), int(seq), fills[0], fills[1],
                                0, 0], dtype=torch.int64))
    st.h_start, st.h_pend, st.h_prev = int(start), fills[0], fills[1]
    return st


def _keyed_blocks(wslab, mode):
    """The JAX keyed state as ([(Buffer, alive count [K])...], seq [K]):
    one block for `length` / `time`, (pending, previous) for
    `lengthBatch` and `timeBatch` (whose state also holds the slice start
    [K] before the seq)."""
    from .kernels.keyed_window import (_TWO_BLOCKS, MODE_EXPR, MODE_EXPRB,
                                       MODE_TLEN)
    bufs = (wslab[0], wslab[1]) if mode in _TWO_BLOCKS else (wslab[0],)
    out = []
    for b in bufs:
        if mode in (MODE_EXPR, MODE_EXPRB):
            # an expression window's rows by add_seq, the alive ones first
            b = _by_add_seq(b, alive_first=True)
        alive = np.asarray(b.alive)
        n = alive.sum(1)
        if not np.array_equal(alive, np.arange(alive.shape[1])[None, :]
                              < n[:, None]):
            raise ValueError("a key's JAX buffer is not a compact prefix")
        if mode == MODE_TLEN:
            b = _by_add_seq(b)
        out.append((b, n))
    return out, np.asarray(wslab[-1])


def _by_add_seq(b, alive_first=False):
    """A stacked Buffer with each key's rows in add_seq order (the dead
    rows, at BIG_SEQ, after them; with `alive_first` whatever their
    add_seq)."""
    key = np.asarray(b.add_seq)
    if alive_first:
        from .core.window import BIG_SEQ
        key = np.where(np.asarray(b.alive), key, BIG_SEQ)
    order = np.argsort(key, axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(np.asarray(x), order, 1)
    return type(b)(*(tuple(take(c) for c in x) if isinstance(x, tuple)
                     else take(x) for x in b))


def _jax_key_state(wslab, blocks, mode) -> dict:
    """The port slab's mode-specific per-key state (`KEY_STATE`) as the
    JAX keyed state gives it: timeBatch's slice start and session's start
    and last are in the state, the time window's `ordered` is read off
    each key's rows."""
    from .kernels.keyed_window import KEY_STATE, MODE_SESSION
    ses = mode == MODE_SESSION
    derive = {"start": lambda: np.asarray(wslab[1 if ses else 2]),
              "last": lambda: np.asarray(wslab[2]),
              "next": lambda: np.asarray(wslab[1]),
              "ordered": lambda: _ordered(*blocks[0])}
    return {n: derive[n]() for n in KEY_STATE.get(mode, {})}


def keyed_slab_from_jax(wslab, mode: int, types, device=None,
                        key_init=None):
    """A JAX keyed window state -> the port's KeyedSlab (K11's or
    K20-K23's layout); `key_init` the per-key state's initial values
    where the window's parameters set them."""
    from .kernels.keyed_window import _TWO_BLOCKS, MODE_FREQ, KeyedSlab
    device = _dev(device)
    if mode == MODE_FREQ:
        return freq_slab_from_jax(wslab, types, device)
    blocks, seq = _keyed_blocks(wslab, mode)
    K, C = np.asarray(blocks[0][0].ts).shape
    slab = KeyedSlab.empty(mode, types, K, C, device, key_init)
    targets = [(slab.ts, slab.gslot, slab.cols, slab.count)]
    if mode in _TWO_BLOCKS:
        targets.append((slab.p_ts, slab.p_gslot, slab.p_cols,
                        slab.p_count))
    for (ts, gs, cols, cnt), (buf, n) in zip(targets, blocks):
        for dst, src in ((ts, buf.ts), (gs, buf.gslot), (cnt, n),
                         *zip(cols, buf.cols)):
            dst.copy_(_t(src, device, dst.dtype))
    slab.seq.copy_(_t(seq, device, torch.int64))
    for n, x in _jax_key_state(wslab, blocks, mode).items():
        slab.key_state[n].copy_(_t(x, device, slab.key_state[n].dtype))
    return slab


def freq_slab_from_jax(wslab, types, device=None):
    """A JAX keyed FrequentWindow state (counts [K, n], keys [K, n, nk],
    the stored events' Buffer [K, n], seq [K]) -> the port's KeyedSlab in
    MODE_FREQ (K24)."""
    from .kernels.keyed_window import MODE_FREQ, KeyedSlab
    device = _dev(device)
    counts, keys, buf, seq = wslab
    K, n, nk = np.asarray(keys).shape
    slab = KeyedSlab.empty(MODE_FREQ, types, K, n, device, nkeys=nk)
    for dst, src in ((slab.f_counts, counts), (slab.f_keys, keys),
                     (slab.ts, buf.ts), (slab.gslot, buf.gslot),
                     (slab.seq, seq), *zip(slab.cols, buf.cols)):
        dst.copy_(_t(src, device, dst.dtype))
    return slab


def expr_state_from_jax(window, wstate, types, device=None):
    """A JAX top-level ExpressionWindow state (Buffer [C], seq) or
    ExpressionBatchWindow state (pending Buffer [C], previous Buffer
    [C + 1], seq) -> the port's slab of one key (K25 / K26), each buffer's
    alive rows by add_seq."""
    from .kernels.keyed_window import MODE_EXPR, MODE_EXPRB
    mode = MODE_EXPRB if window.name == "expressionBatch" else MODE_EXPR
    return keyed_slab_from_jax(_stack_one(wstate), mode, types, device)


def _ordered(buf, n) -> np.ndarray:
    """Per key: are its alive rows (a prefix, in window order) in
    timestamp order?"""
    ts = np.asarray(buf.ts)
    back = (ts[:, 1:] < ts[:, :-1]) & (np.arange(1, ts.shape[1])[None, :]
                                        < np.asarray(n)[:, None])
    return (~back.any(1)).astype(np.int32)


def keyed_slab_to_jax(slab, t: int = 0):
    """The port's KeyedSlab -> the JAX keyed state of the same window:
    numpy Buffers of [K, C] (each key's alive rows first, in window order;
    a frequent window's counters in place, with their counts and keys)
    and seq[K].  A key's rows get add_seq seq - count .. seq - 1, which
    keeps their order below the key's counter; a time window's expire_ts
    is ts + t."""
    from .core.window import BIG_SEQ, Buffer
    from .kernels.keyed_window import (_TWO_BLOCKS, MODE_FREQ, MODE_TBATCH,
                                       MODE_TIME)
    lg = keyed_slab_logical(slab, slab.mode)
    seq = lg["seq"]
    if slab.mode == MODE_FREQ:
        # (counts, keys, the stored events, seq), as FrequentWindow keeps
        # them: a counter's event in place, alive where its count is
        alive = lg["f_counts"] > 0
        big = np.full(alive.shape, BIG_SEQ, np.int64)
        stored = Buffer(
            ts=lg["ts"], add_seq=big, expire_seq=big, expire_ts=big,
            alive=alive, gslot=lg["gslot"].astype(np.int32),
            cols=tuple(lg[f"col{j}"].astype(ev.np_dtype(tp))
                       for j, tp in enumerate(slab.types)))
        return lg["f_counts"], lg["f_keys"], stored, seq

    def buf(pre, ordered):
        n = lg[pre + "count"]
        C = lg[pre + "ts"].shape[1]      # an expressionBatch's previous
        ar = np.arange(C)[None, :]       # batch holds C + 1 rows
        alive = ar < n[:, None]
        add = np.where(alive & ordered, seq[:, None] - n[:, None] + ar,
                       BIG_SEQ)
        ts = lg[pre + "ts"]
        exp = np.where(alive & (slab.mode == MODE_TIME), ts + t, BIG_SEQ)
        cols = tuple(lg[f"{pre}col{j}"].astype(ev.np_dtype(tp))
                     for j, tp in enumerate(slab.types))
        return Buffer(ts=ts, add_seq=add,
                      expire_seq=np.full((slab.K, C), BIG_SEQ, np.int64),
                      expire_ts=exp, alive=alive,
                      gslot=np.where(alive, lg[pre + "gslot"], -1)
                      .astype(np.int32), cols=cols)
    if slab.mode == MODE_TBATCH:
        return buf("", False), buf("p_", False), lg["start"], seq
    if slab.mode in _TWO_BLOCKS:
        return buf("", False), buf("p_", False), seq
    return buf("", True), seq


def keyed_slab_logical(state, mode: int) -> dict:
    """Every key's alive rows and counters as numpy, from a port KeyedSlab
    or a JAX keyed state: [K, C] arrays, zero past each key's count."""
    from .kernels.keyed_window import MODE_FREQ, KeyedSlab
    if isinstance(state, KeyedSlab):
        return {k: v.cpu().numpy().astype(np.int64) if v.dtype in (
            torch.int32, torch.bool) else v.cpu().numpy()
            for k, v in state.logical().items()}
    if mode == MODE_FREQ:
        # the attribute type of each stored column, by its dtype
        names = {np.dtype(np.int32): "INT", np.dtype(np.int64): "LONG",
                 np.dtype(np.float32): "FLOAT", np.dtype(np.bool_): "BOOL"}
        return keyed_slab_logical(freq_slab_from_jax(
            state, [names[np.asarray(c).dtype] for c in state[2].cols]),
            mode)
    blocks, seq = _keyed_blocks(state, mode)
    out = {"seq": seq.astype(np.int64)}
    out.update({n: x.astype(np.int64) for n, x in
                _jax_key_state(state, blocks, mode).items()})
    for pre, (buf, n) in zip(("", "p_"), blocks):
        C = np.asarray(buf.ts).shape[1]
        alive = np.arange(C)[None, :] < n[:, None]

        def view(x):
            x = np.asarray(x)
            if x.dtype == np.bool_ or x.dtype == np.int32:
                x = x.astype(np.int64)
            return np.where(alive, x, np.zeros_like(x))
        out[pre + "ts"] = view(buf.ts)
        out[pre + "gslot"] = view(buf.gslot)
        out[pre + "count"] = n.astype(np.int64)
        for j, c in enumerate(buf.cols):
            out[f"{pre}col{j}"] = view(c)
    return out


def ext_state_from_jax(window, buf, seq, schema: ev.Schema, device=None):
    """A JAX externalTime / timeLength / delay state (Buffer, seq) -> the
    port's ExtState for the port's window `window`."""
    from .kernels.ext_window import MODE_EXT, MODE_TLEN, ExtState
    from .core.window_ext import (ExternalTimeWindow, TimeLengthWindow)
    device = _dev(device)
    mode = {ExternalTimeWindow: MODE_EXT, TimeLengthWindow: MODE_TLEN}.get(
        type(window), 2)
    alive = np.asarray(buf.alive)
    idx = np.nonzero(alive)[0]
    exp = np.asarray(buf.expire_ts)
    key = exp - window.time_ms if mode == MODE_EXT else exp
    if mode == MODE_EXT:
        idx = idx[np.argsort(key[idx], kind="stable")]
    elif mode == MODE_TLEN:
        idx = idx[np.argsort(np.asarray(buf.add_seq)[idx], kind="stable")]
    st = ExtState.empty(mode, schema, window.capacity, device)
    n = idx.shape[0]
    for dst, src in ((st.ts, buf.ts), (st.key, key), (st.gslot, buf.gslot),
                     *zip(st.cols, buf.cols)):
        dst[:n] = _t(np.asarray(src)[idx], device, dst.dtype)
    st.meta.copy_(torch.tensor([n, int(seq), 0, 0], dtype=torch.int64))
    return st


def sort_state_from_jax(window, buf, seq, schema: ev.Schema, device=None):
    """A JAX SortWindow state (Buffer, seq) -> the port's SortState."""
    from .kernels.sort_window import SortState
    device = _dev(device)
    idx = np.nonzero(np.asarray(buf.alive))[0]
    st = SortState.empty(schema, window.capacity, device)
    n = idx.shape[0]
    for dst, src in ((st.ts, buf.ts), (st.gslot, buf.gslot),
                     *zip(st.cols, buf.cols)):
        dst[:n] = _t(np.asarray(src)[idx], device, dst.dtype)
    st.meta.copy_(torch.tensor([n, int(seq)], dtype=torch.int64))
    return st


def hop_state_from_jax(window, buf, nxt, seq, schema: ev.Schema,
                       device=None):
    """A JAX HoppingWindow state (Buffer, next, seq) -> the port's
    HopState (the alive rows in buffer order)."""
    from .kernels.hop_window import HopState
    device = _dev(device)
    idx = np.nonzero(np.asarray(buf.alive))[0]
    st = HopState.empty(schema, window.capacity, device)
    n = idx.shape[0]
    for dst, src in ((st.b_ts[0], buf.ts), (st.b_gslot[0], buf.gslot),
                     *zip(st.b_cols[0], buf.cols)):
        dst[:n] = _t(np.asarray(src)[idx], device, dst.dtype)
    st.meta.copy_(torch.tensor([n, int(nxt), int(seq), 0, 0],
                               dtype=torch.int64))
    return st


def freq_state_from_jax(window, counts, keys, buf, seq, schema: ev.Schema,
                        device=None):
    """A JAX FrequentWindow state (counts, keys, stored Buffer, seq) ->
    the port's FreqState."""
    from .kernels.frequent import FreqState
    device = _dev(device)
    st = FreqState.empty(schema, window.n, len(window.key_positions),
                         device)
    for dst, src in ((st.counts, counts), (st.keys, keys),
                     (st.ts, buf.ts), (st.gslot, buf.gslot),
                     *zip(st.cols, buf.cols)):
        dst.copy_(_t(src, device, dst.dtype))
    st.meta[0] = int(seq)
    return st


def latency_slab_from_jax(wslab, types, device=None):
    """A JAX keyed SessionLatencyWindow state -> the port's KeyedSlab in
    K11's latency mode: each slab a compact prefix of its key's rows."""
    from .kernels.keyed_window import MODE_LATENCY, KeyedSlab
    device = _dev(device)
    cur, cs, cl, prev, ps, pl, pa, seq = wslab
    K, C = np.asarray(cur[0]).shape
    slab = KeyedSlab.empty(MODE_LATENCY, types, K, C, device)
    for (ts, gs, cols, cnt), (sts, salive, sgs, scols) in (
            ((slab.ts, slab.gslot, slab.cols, slab.count), cur),
            ((slab.p_ts, slab.p_gslot, slab.p_cols, slab.p_count), prev)):
        alive = np.asarray(salive)
        n = alive.sum(1)
        if not np.array_equal(alive, np.arange(C)[None, :] < n[:, None]):
            raise ValueError("a key's JAX session slab is not a compact "
                             "prefix")
        for dst, src in ((ts, sts), (gs, sgs), (cnt, n),
                         *zip(cols, scols)):
            dst.copy_(_t(src, device, dst.dtype))
    slab.seq.copy_(_t(seq, device, torch.int64))
    for n, x in (("start", cs), ("last", cl), ("p_start", ps),
                 ("p_last", pl), ("p_alive", pa)):
        slab.key_state[n].copy_(_t(x, device, torch.int64))
    return slab


def pair_allocators_from_jax(port_planned, jax_planned) -> None:
    """Copy a distinctCount query's pair-slot allocators, and its
    group-slot allocator, from the JAX plan into the port's."""
    for (dst, _), (src, _) in zip(port_planned.pair_allocs,
                                  jax_planned.pair_allocs):
        _copy_allocator(dst, src)
    if port_planned.slot_allocator is not None:
        _copy_allocator(port_planned.slot_allocator,
                        jax_planned.slot_allocator)


def query_state_from_jax(planned, jax_state, device=None):
    """A JAX single-stream QueryRuntime.state (window_state,
    selector_state) -> the port's, for the port's plan of the same
    query."""
    from .core.window_ext import SessionLatencyWindow
    wstate, sel_state = jax_state
    w = planned.window
    device = _dev(device)
    types = planned.in_schema.types
    if planned.keyed_window and isinstance(w, SessionLatencyWindow):
        port_w = latency_slab_from_jax(wstate, types, device)
    elif planned.keyed_window:
        from .core.planner import _keyed_shape
        mode, _, _, key_init = _keyed_shape(w, planned.name)
        port_w = keyed_slab_from_jax(wstate, mode, types, device, key_init)
    else:
        port_w = window_state_from_jax(w, wstate, planned.in_schema, device)
    return port_w, selector_state_from_jax(sel_state, device)


def merged_state_from_jax(jax_group, group, device=None) -> None:
    """Carry a JAX merge group's state (`MergedGroupRuntime`, `siddhi_tpu/
    optimizer/mqo.py`) into the port's group of the same app: a group's
    state is its members' states, each member's view (`member_state`)
    converted as `query_state_from_jax` converts a query's, a shared
    unit's window held once (setting one member's view sets the unit's
    window), and the members' group-slot allocators copied."""
    by_name = {m.name: m for m in jax_group.members}
    for m in group.members:
        jm = by_name[m.name]
        if m.planned.slot_allocator is not None:
            _copy_allocator(m.planned.slot_allocator,
                            jm.planned.slot_allocator)
        group.set_member_state(m, query_state_from_jax(
            m.planned, jax_group.member_state(jm), device))


def window_state_from_jax(w, wstate, schema: ev.Schema, device=None):
    """A JAX top-level window state -> the port's state of the port's
    window `w` (of the same kind and parameters)."""
    from .core.window import LengthBatchWindow, LengthWindow, NoWindow, \
        PassAllWindow, TimeBatchWindow, TimeWindow
    from .core.window_ext import (ChunkBatchWindow, CronWindow,
                                  DelayWindow, ExternalTimeBatchWindow,
                                  ExternalTimeWindow, FrequentWindow,
                                  HoppingWindow, SessionWindow, SortWindow,
                                  TimeLengthWindow)
    from .core.window_expr import ExpressionWindow
    device = _dev(device)
    types = schema.types
    if isinstance(w, ChunkBatchWindow):
        from .core.window import empty_buffer
        return time_batch_state_from_jax(
            empty_buffer(schema, w.capacity), wstate[0], -1,
            np.asarray(wstate[1]), schema, w.capacity, device)
    if isinstance(w, CronWindow):
        return time_batch_state_from_jax(
            wstate[0], wstate[1], -1, np.asarray(wstate[2]), schema,
            w.capacity, device)
    if isinstance(w, HoppingWindow):
        return hop_state_from_jax(w, wstate[0], np.asarray(wstate[1]),
                                  np.asarray(wstate[2]), schema, device)
    if isinstance(w, ExpressionWindow):
        return expr_state_from_jax(w, wstate, types, device)
    if isinstance(w, FrequentWindow):
        return freq_state_from_jax(w, *wstate[:3], np.asarray(wstate[3]),
                                   schema, device)
    if isinstance(w, (NoWindow, PassAllWindow)):
        return torch.tensor([int(np.asarray(wstate))], dtype=torch.int64,
                            device=device)
    if isinstance(w, TimeWindow):
        return time_ring_from_jax(wstate[0], np.asarray(wstate[1]), schema,
                                  device)
    if isinstance(w, LengthWindow):
        return length_ring_from_jax(wstate[0], np.asarray(wstate[1]),
                                    schema, device)
    if isinstance(w, LengthBatchWindow):
        return batch_state_from_jax(wstate[0], wstate[1],
                                    np.asarray(wstate[2]), schema, w.length,
                                    device)
    if isinstance(w, (TimeBatchWindow, ExternalTimeBatchWindow)):
        return time_batch_state_from_jax(
            wstate[0], wstate[1], np.asarray(wstate[2]),
            np.asarray(wstate[3]), schema, w.capacity, device)
    if isinstance(w, (ExternalTimeWindow, TimeLengthWindow, DelayWindow)):
        return ext_state_from_jax(w, wstate[0], np.asarray(wstate[1]),
                                  schema, device)
    if isinstance(w, SortWindow):
        return sort_state_from_jax(w, wstate[0], np.asarray(wstate[1]),
                                   schema, device)
    if isinstance(w, SessionWindow):
        # one key: the JAX state with a key axis of 1
        from .kernels.keyed_window import MODE_SESSION
        return keyed_slab_from_jax(_stack_one(wstate), MODE_SESSION, types,
                                   device)
    raise NotImplementedError(f"no state conversion for {w.name}")


def named_window_from_jax(jax_nw, nw) -> None:
    """Carry a JAX NamedWindowRuntime's window state into the port's
    NamedWindowRuntime of the same definition (in place)."""
    nw.state = window_state_from_jax(nw.wproc, jax_nw.state, nw.schema,
                                     nw.device)


def aggregation_from_jax(jax_agg, agg) -> None:
    """Carry a JAX AggregationRuntime's buckets into the port's
    AggregationRuntime of the same definition (in place): per duration
    the allocator (its mapping, free order and counters, so
    `decode_keys` lists the buckets in the same order) and the slab."""
    if list(jax_agg.durations) != list(agg.durations) or \
            len(jax_agg.base) != len(agg.base) or \
            jax_agg.bucket_capacity != agg.bucket_capacity:
        raise ValueError("the aggregations' durations, bases or capacities "
                         "differ")
    for d, dur in enumerate(agg.durations):
        src = jax_agg._dstores[dur]
        _copy_allocator(agg._dstores[dur].alloc, src.alloc)
        agg.slabs[d].copy_(_t(np.asarray(src.slab), agg.slabs.device,
                              torch.float64))


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

_ALLOC_ARRAYS = ("_cells", "_cell_by_slot", "_used", "_free", "_meta",
                 "_journal")


def _stack_one(state):
    """A window state as a keyed state of one key: every leaf with a
    leading axis of 1."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_stack_one(x) for x in state))
    if isinstance(state, (tuple, list)):
        return tuple(_stack_one(x) for x in state)
    return np.asarray(state)[None]


def _copy_allocator(dst, src) -> None:
    """Make `dst` (a port SlotAllocator) the exact copy of `src` (either
    package's, same capacity): bindings, free stack order and counters."""
    if dst.capacity != src.capacity:
        raise ValueError("allocator capacities differ")
    for name in _ALLOC_ARRAYS:
        setattr(dst, name, np.array(getattr(src, name), copy=True))
    dst._w8 = src._w8
    dst._arena = None if src._arena is None else src._arena.copy()
    dst._pcache[:] = 0
    dst.version += 1


def table_from_jax(jt, table) -> None:
    """Carry a JAX TableRuntime's state into the port's TableRuntime of
    the same definition (in place)."""
    if jt.capacity != table.capacity:
        raise ValueError("table capacities differ")
    dev = table.device
    for dst, src in zip(table.cols, jt.cols):
        dst.copy_(_t(src, dev, dst.dtype))
    table.ts.copy_(_t(jt.ts, dev, torch.int64))
    table.valid.copy_(_t(jt.valid, dev, torch.bool))
    table.version += 1
    table._append_ptr = int(jt._append_ptr)
    table._free_rows = [int(x) for x in jt._free_rows]
    if jt.allocator is not None:
        _copy_allocator(table.allocator, jt.allocator)
    for pos, src in jt.indexes.items():
        dst = table.indexes[pos]
        _copy_allocator(dst.alloc, src.alloc)
        for name in ("lanes", "counts", "shadow", "bucket_of"):
            setattr(dst, name, np.array(getattr(src, name), copy=True))
        dst._sorted_dirty = True
    table.index_stats = dict(jt.index_stats)


def _np(x) -> np.ndarray:
    """A copy as numpy (a CPU tensor's numpy view would follow the
    table's in-place writes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def table_to_numpy(t) -> dict:
    """Either package's TableRuntime as numpy: the columns, ts and valid;
    the append pointer and free rows; the primary-key allocator's bindings
    and free stack; each @Index's lanes, counts, shadow and bucket map."""
    out = {"cols": [_np(c) for c in t.cols], "ts": _np(t.ts),
           "valid": _np(t.valid), "append_ptr": int(t._append_ptr),
           "free_rows": [int(x) for x in t._free_rows],
           "slots": None, "free_slots": None, "indexes": {}}
    if t.allocator is not None:
        out["slots"] = t.allocator.snapshot()
        out["free_slots"] = t.allocator._free[:int(
            t.allocator._meta[1])].copy()
    for pos, idx in t.indexes.items():
        out["indexes"][pos] = {
            "lanes": idx.lanes.copy(), "counts": idx.counts.copy(),
            "shadow": idx.shadow.copy(), "bucket_of": idx.bucket_of.copy(),
            "buckets": idx.alloc.snapshot()}
    return out


# ---------------------------------------------------------------------------
# sharded runtimes (A14): the JAX package's global arrays in state-row order
# against the port's per-shard states
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return np.asarray(x)


def sharded_state_from_jax(planned, jax_state, mesh):
    """A meshed JAX runtime's state -> the port's per-shard state for the
    port's sharded plan of the same query.  A JAX global array fetched to
    the host is in state-row order, so shard d's block of a split leaf is
    the contiguous slice [d * C / n, (d + 1) * C / n) (blobs [W, C] on
    axis 1, selector slabs and keyed slabs on axis 0); a replicated leaf
    (scalars, a keyed window's selector state) goes to every shard."""
    from .sharding import ShardedState
    n = mesh.n
    if getattr(planned, "packer", None) is not None:          # pattern
        (b32, b64, scalars), sel_state = jax_state
        b32, b64 = _host(b32), _host(b64)
        sel = [_host(s) for s in sel_state]
        blk = b32.shape[1] // n
        return ShardedState(
            state_from_jax(b32[:, d * blk:(d + 1) * blk],
                           b64[:, d * blk:(d + 1) * blk],
                           [_host(s) for s in scalars],
                           [s[d * blk:(d + 1) * blk] for s in sel], dev)
            for d, dev in enumerate(mesh.devices))
    wstate, sel_state = jax_state
    if planned.keyed_mesh is not None:
        slab, astate = query_state_from_jax(
            planned, (wstate, [_host(s) for s in sel_state]))
        blk = slab.K // n
        return ShardedState(
            (slab.take_rows(torch.arange(d * blk, (d + 1) * blk), dev),
             tuple(a.to(dev) for a in astate))
            for d, dev in enumerate(mesh.devices))
    sel = [_host(s) for s in sel_state]
    blk = sel[0].shape[0] // n if sel else 0
    return ShardedState(
        (torch.tensor([int(_host(wstate))], dtype=torch.int64, device=dev),
         selector_state_from_jax([s[d * blk:(d + 1) * blk] for s in sel],
                                 dev))
        for d, dev in enumerate(mesh.devices))


def sharded_state_to_numpy(qr) -> list:
    """A sharded pattern or windowless group-by runtime's state as the JAX
    package's global leaves in state-row order (numpy): the blobs and
    split selector slabs concatenated shard by shard, the scalars and the
    seq counter once."""
    st = qr.state
    if getattr(qr.planned, "packer", None) is not None:
        (_, _, scal), _ = st[0]
        return ([np.concatenate([p[0].cpu().numpy() for p, _ in st], 1),
                 np.concatenate([p[1].cpu().numpy() for p, _ in st], 1)] +
                [s.cpu().numpy() for s in scal] +
                [np.concatenate([s[i].cpu().numpy() for _, s in st])
                 for i in range(len(st[0][1]))])
    return ([st[0][0].cpu().numpy().reshape(())] +
            [np.concatenate([a[i].cpu().numpy() for _, a in st])
             for i in range(len(st[0][1]))])


def jax_sharded_state_to_numpy(jqr) -> list:
    """The leaves `sharded_state_to_numpy` gives, of a meshed JAX
    runtime."""
    if hasattr(jqr.planned, "spec"):
        (b32, b64, scal), sel = jqr.state
        return [_host(b32), _host(b64)] + [_host(s) for s in scal] + \
            [_host(s) for s in sel]
    w, sel = jqr.state
    return [_host(w)] + [_host(s) for s in sel]


def carry_sharded_runtime(jrt, rt) -> None:
    """Carry a meshed JAX app runtime's partitioned state into the port's
    runtime of the same app on a mesh of the same size: each sharded
    query's state (`sharded_state_from_jax`), its group-slot allocator,
    and the partitions' key allocators (bindings in slot order, so each
    key keeps its shard)."""
    seen = set()
    for name, qr in rt.query_runtimes.items():
        jqr = jrt.query_runtimes[name]
        p = qr.planned
        for a, b in ((getattr(qr, "slot_allocator", None),
                      getattr(jqr, "slot_allocator", None)),
                     (getattr(p, "slot_allocator", None),
                      getattr(jqr.planned, "slot_allocator", None)),
                     (getattr(p, "window_key_allocator", None),
                      getattr(jqr.planned, "window_key_allocator", None))):
            if a is not None and b is not None and id(a) not in seen:
                seen.add(id(a))
                _copy_allocator(a, b)
        mesh = p.mesh if p.mesh is not None else getattr(p, "keyed_mesh",
                                                         None)
        if mesh is None:
            continue
        qr.state = sharded_state_from_jax(p, jqr.state, mesh)
