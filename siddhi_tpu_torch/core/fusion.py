"""Fused multi-batch stepping: K staged batches per dispatch, one header
fetch (`@fuse(batches='K')`; port of `siddhi_tpu/core/fusion.py`).

A fused query stacks K same-signature staged batches (same input tag and
bucket capacity) and dispatches them together: the stack goes to the card
in ONE host-to-device copy (`event.StackedBatch`), the pre-window filters
of all K batches run as one launch sequence of kernel K29 (`kernels/
multi_filter.py`) and a top-level pattern's K batches, unless it is a
simple chain, as one stacked launch of `pattern_step`'s general mode; the
window, selector and join
stages then run batch after batch on the filtered rows, state threading
from batch to batch exactly as K sequential sends thread it; and the K
headers come back in ONE device-to-host transfer.

Semantics: a fused query's processing (and so its delivery, table writes
and downstream routing) lags up to K-1 batches until the stack fills or
`flush()` drains it.  A partial stack drains through the ORIGINAL
sequential path, so a flush is identical to never having fused.
Timer-bearing queries are excluded at wiring time (their wake cannot
lag).  The `in Table` probes and a join's table side are read once per
stack, at dispatch.

Paths fused: plain (non-keyed, non-range-partition) single-stream
queries, non-partitioned pattern / sequence queries (a simple chain on
the block NFA batch after batch, as the JAX package scans its block body;
every other plan through one stacked launch of the general mode), join
sides, and merge groups
(`optimizer/mqo.py`), and mesh-sharded partitioned patterns
(`_dispatch_pattern_sharded`: each shard walks the stack's batches in
order, a data launch a batch).  EXPLAIN's `eligibility` waits for A15.
The JAX
package caches one compiled scan per (kind, step body); the port has no
compiled bodies to cache: each dispatch calls the plan's current steps.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from . import event as ev


def ineligible_reason(qr, kind: str):
    """Why this runtime cannot fuse (None = eligible).  Static properties
    only; per-batch variation is handled by the stack signature."""
    if kind == "merged":
        return None
    p = qr.planned
    if kind == "plain":
        if p.needs_timer:
            return "timer-bearing window (time/cron) — wake cannot lag"
        if p.keyed_window:
            return "keyed-window slab path is not fused yet"
        if p.partition_key_fn is not None:
            return "range-partition key derivation is not fused yet"
        if p.mesh is not None:
            return "sharded step has no fusable body"
        return None
    if kind == "pattern":
        if p.timer_step is not None:
            return "absent pattern needs timer wakeups — wake cannot lag"
        if p.mesh is not None:
            # sharded partitioned patterns fuse through their shard steps'
            # fused entry (`pattern_planner.ShardedStep`)
            if p.shard_fused_steps:
                return None
            return "sharded pattern step has no fusable body"
        if p.partition_positions:
            return "partitioned pattern grouping is not fused yet"
        return None
    if kind == "join":
        if p.needs_timer:
            return "timer-bearing join window — wake cannot lag"
        return None
    return f"unknown runtime kind {kind!r}"


class FuseBuffer:
    """Per-query accumulator of staged sends for fused dispatch.

    Every entry point runs under the query lock (junction dispatch holds
    it).  `offer` stacks same-signature batches (same input tag + bucket
    capacity); a signature change drains the pending stack sequentially
    first, so cross-batch order within the query is kept exactly."""

    __slots__ = ("qr", "k", "kind", "items", "sig", "bypass")

    def __init__(self, qr, k: int, kind: str):
        self.qr = qr
        self.k = max(1, int(k))
        self.kind = kind
        self.items: List[Tuple] = []
        self.sig = None
        self.bypass = False

    def offer(self, args: Tuple, staged: ev.StagedBatch, tag) -> bool:
        """Accept a send into the stack.  Returns False when the caller
        must run the sequential path itself (a drain re-entering)."""
        if self.bypass:
            return False
        sig = (tag, staged.ts.shape[0])
        if self.items and sig != self.sig:
            self.drain()
        self.sig = sig
        self.items.append(args)
        if len(self.items) >= self.k:
            self.dispatch()
        return True

    def drain(self) -> None:
        """Deliver a partial stack through the ORIGINAL sequential path
        (flush / signature change): identical to never having fused."""
        if not self.items:
            return
        items, self.items = self.items, []
        self.bypass = True
        try:
            for args in items:
                self.qr.process_staged(*args)
        finally:
            self.bypass = False

    def dispatch(self) -> None:
        """Run the full stack as one fused dispatch (its latency and
        batches-per-dispatch recorded with statistics on, reference
        `FuseBuffer.dispatch`, `siddhi_tpu/core/fusion.py:179-196`)."""
        from .runtime import _maybe_span
        items, self.items = self.items, []
        qr = self.qr
        stats = qr.app.stats
        t0 = time.perf_counter_ns() if stats.enabled else 0
        with _maybe_span("fused_step", query=qr.name, k=len(items)):
            _DISPATCH[self.kind](qr, items)
        if stats.enabled:
            n = sum(int(a[-2].n) for a in items)
            stats.fused_dispatch(qr.name, len(items), n,
                                 time.perf_counter_ns() - t0)


def pending(qr) -> int:
    """Batches held in a runtime's fuse stack (0 for unfused runtimes)."""
    fb = getattr(qr, "_fuse", None)
    return len(fb.items) if fb is not None else 0


def drain(qr) -> None:
    """Flush a runtime's partial stack (flush / shutdown), under the query
    lock the producer's offer path runs under."""
    fb = getattr(qr, "_fuse", None)
    if fb is None or not fb.items:
        return
    with qr._qlock:
        fb.drain()


# ---------------------------------------------------------------------------
# per-kind dispatch: host slot prep (in arrival order), one upload, K29 /
# the stacked pattern launch, the per-batch stages, delivery
# ---------------------------------------------------------------------------

def _facts(staged, full: bool = True):
    """The batch's host facts as the sequential path gives them (a join
    side's without the staged batch)."""
    from .window import BatchFacts
    cur = np.logical_and(staged.valid, staged.kind == ev.CURRENT)
    if not full:
        return BatchFacts(staged.ts[cur], staged.ts.shape[0])
    return BatchFacts(staged.ts[cur], staged.ts.shape[0], staged, cur)


def _batch(stacked: ev.EventBatch, s: int) -> ev.EventBatch:
    return ev.EventBatch(stacked.ts[s], stacked.kind[s], stacked.valid[s],
                         tuple(c[s] for c in stacked.cols))


def prefilter(window, wstate, spec, batch: ev.EventBatch, gslot, nows,
              extra=None):
    """K29 over a stack for one window: [Prefiltered] per batch, or None
    where the window filters its rows itself (its kernel evaluates the
    filters).  `extra` is a join side's extra column ([S, B])."""
    from ..kernels import multi_filter as k29
    if not window.prefilters:
        return None
    cols = tuple(batch.cols) + ((extra,) if extra is not None else ())
    seq = window.arrival_seq(wstate)
    res = k29.multi_filter([spec], batch.ts, batch.kind, batch.valid, cols,
                           [gslot], nows, [seq], [window.keeps_expired])
    return k29.prefiltered([spec], res, [seq])[0]


def _dispatch_plain(qr, items) -> None:
    p = qr.planned
    nows = [now for _, now in items]
    gslots, pslots = [], []
    for staged, now in items:
        g = qr._group_slots(staged)
        if qr._touch is not None:
            qr._touch(g, now)
        gslots.append(g)
        pslots.append([alloc.slots_for([g, staged.cols[pos]], staged.valid)
                       for alloc, pos in p.pair_allocs])
    extra = [np.stack(gslots)] + [np.stack([ps[j] for ps in pslots])
                                  for j in range(len(p.pair_allocs))]
    batch, dev_extra = ev.StackedBatch([st for st, _ in items]).to_device(
        p.in_schema, p.device, extra)
    g_dev, ps_dev = dev_extra[0], dev_extra[1:]
    # the `in Table` snapshot: once per stack, at dispatch
    kw = qr.app.in_probe_kw(p.in_deps)
    pre = prefilter(p.window, qr.state[0], p.filter_spec.bind(
        kw.get("in_tabs")), batch, g_dev, nows)
    results = []
    for s, (staged, now) in enumerate(items):
        kws = dict(kw)
        if ps_dev:
            kws["pslots"] = tuple(x[s] for x in ps_dev)
        qr.state, out, header = p.step(
            qr.state, _batch(batch, s), g_dev[s], now, _facts(staged),
            pre=None if pre is None else pre[s], **kws)
        results.append((out, header))
    from . import runtime as _rt
    _deliver_fused(qr, results, nows, _rt._deliver_plain)


def _dispatch_pattern(qr, items) -> None:
    p = qr.planned
    if p.mesh is not None:
        return _dispatch_pattern_sharded(qr, items)
    stream_id = items[0][0]
    B = items[0][1].ts.shape[0]
    nows = [now for _, _, now in items]
    ar = np.arange(B, dtype=np.int32)
    sels = np.stack([(ar if st.valid.all() else
                      np.where(st.valid, ar, -1).astype(np.int32))[None, :]
                     for _, st, _ in items])
    stack = ev.StackedBatch([st for _, st, _ in items])
    batch, (sel,) = stack.to_device(p.in_schemas[stream_id], p.device,
                                    [sels])
    key_idx = qr.__dict__.get("_key0")
    if key_idx is None or key_idx.device != p.device:
        key_idx = qr._key0 = torch.zeros((1,), dtype=torch.int32,
                                          device=p.device)
    pstate, sel_state = qr.state
    kw = qr.app.in_probe_kw(p.exec.in_deps)
    step = p.steps[stream_id]
    if p.block:
        # a simple chain runs the block NFA (kernel K8) batch after batch,
        # as the JAX package scans its block body
        outs = []
        for s in range(len(items)):
            pstate, sel_state, out, _ = step(
                pstate, sel_state, tuple(c[s] for c in batch.cols),
                batch.ts[s], sel[s], key_idx, nows[s], **kw)
            outs.append(out)
    else:
        # every other top-level plan: one stacked launch of the general
        # mode walks the stack
        pstate, sel_state, outs, _ = step.stacked(
            pstate, sel_state, batch.cols, batch.ts, sel, key_idx, nows,
            **kw)
    qr.state = (pstate, sel_state)
    from . import runtime as _rt
    results = [(out, torch.stack([out[0], out[1]])) for out in outs]
    _deliver_fused(qr, results, nows, _rt._deliver_pattern)


def _dispatch_pattern_sharded(qr, items) -> None:
    """Fused dispatch of a mesh-sharded partitioned pattern (reference
    `_dispatch_pattern_sharded`, `siddhi_tpu/core/fusion.py:352-386`):
    each batch routes through the key-space router on the host in arrival
    order (`_shard_prep`), the groupings pad to one common [n, Kb, E]
    (key = the sentinel block, sel = -1), the stack goes to the card in
    one copy, and the shard steps' fused entry runs the batches in order,
    each merged as the reference's scan body merges it."""
    p = qr.planned
    stream_id = items[0][0]
    preps = [qr._shard_prep(stream_id, staged, now)
             for _, staged, now in items]
    n = preps[0][0].shape[0]
    Kb = max(ki.shape[1] for ki, _ in preps)
    E = max(s.shape[2] for _, s in preps)
    block = qr.shard_router.block
    k = len(items)
    key_k = np.full((k, n, Kb), block, np.int32)
    sel_k = np.full((k, n, Kb, E), -1, np.int32)
    for i, (ki, s) in enumerate(preps):
        key_k[i, :, :ki.shape[1]] = ki
        sel_k[i, :, :s.shape[1], :s.shape[2]] = s
    nows = [now for _, _, now in items]
    batch, _ = ev.StackedBatch([st for _, st, _ in items]).to_device(
        p.in_schemas[stream_id], p.mesh.first, [])
    qr.state, outs = p.shard_fused_steps[stream_id](
        qr.state, batch.cols, batch.ts, sel_k, key_k, nows,
        **qr.app.in_probe_kw(p.exec.in_deps))
    from . import runtime as _rt
    results = [(out, torch.stack([out[0], out[1]])) for out, _ in outs]
    _deliver_fused(qr, results, nows, _rt._deliver_pattern)


def _dispatch_join(qr, items) -> None:
    p = qr.planned
    is_left = items[0][0]
    side = p.left if is_left else p.right
    other = p.right if is_left else p.left
    step = p.step_left if is_left else p.step_right
    S = len(items)
    B = items[0][1].ts.shape[0]
    nows = [now for _, _, now in items]
    alloc = p.group_allocators[0 if is_left else 1]
    gs = []
    for _, staged, _ in items:
        if alloc is not None:
            gs.append(alloc.slots_for(
                [staged.cols[i]
                 for i in p.group_positions[0 if is_left else 1]],
                staged.valid))
        else:
            gs.append(np.zeros(B, np.int32))
    extra = [np.stack(gs)]
    if p.fastpath == "bucket":
        # probes were bound (and the retention mirror fed) at offer time
        extra.append(np.stack([qr._join_key_probe(is_left, st)
                               for _, st, _ in items]))
    elif p.fastpath == "table":
        extra.append(np.broadcast_to(np.arange(B, dtype=np.int32), (S, B)))
    batch, dev_extra = ev.StackedBatch([st for _, st, _ in items]).to_device(
        side.schema, p.device, extra)
    g_dev = dev_extra[0]
    probe_k = dev_extra[1] if p.fastpath == "bucket" else None
    kw = qr.app.in_probe_kw(p.in_deps)
    pre = prefilter(side.window, qr.state[0 if is_left else 1],
                    side.fspec.bind(kw.get("in_tabs")), batch, g_dev, nows,
                    dev_extra[1] if len(dev_extra) > 1 else None)
    results = []

    def run(view=None):
        for s, (_, staged, now) in enumerate(items):
            probe = probe_k[s] if probe_k is not None else None
            if p.fastpath == "table":
                probe = _rt._h2d(qr._table_probe(staged), p.device)
            args = (qr.state, _batch(batch, s), g_dev[s], probe, now,
                    _facts(staged, full=False))
            if view is not None:
                args = args + (view,)
            out, header = step(*args, pre=None if pre is None else pre[s],
                               **kw)
            results.append((out, header))

    from . import runtime as _rt
    # the other side's table / window / aggregation: read once per stack
    if not other.is_table:
        run()
    elif other.is_aggregation:
        run(qr.app.aggregations[other.stream_id].device_view(
            p.per_duration, p.within_range))
    elif other.is_named_window:
        nw = qr.app.named_windows[other.stream_id]
        with nw._qlock:
            view = nw.current_buffer()
        run(view)
    else:
        t = qr.app.tables[other.stream_id]
        with t._lock:
            run((t.cols, t.ts, t.valid))
    _deliver_fused(qr, results, nows, _rt._deliver_join)


def _dispatch_merged(qr, items) -> None:
    qr._dispatch_many(items)


_DISPATCH = {"plain": _dispatch_plain, "pattern": _dispatch_pattern,
             "join": _dispatch_join, "merged": _dispatch_merged}


# ---------------------------------------------------------------------------
# fused delivery: one header fetch, per-batch delivery
# ---------------------------------------------------------------------------

def _deliver_fused(qr, results, nows: List[int], deliver) -> None:
    """Deliver each batch's emission in order.  Sync mode fetches the K
    headers in ONE transfer and delivers per batch; @serve / @async /
    @pipeline re-enter the emission entry per batch (the ring appends stay
    dispatch-only; the drainer and the deque batch their fetches).  A
    per-batch failure (emission-cap overflow, callback error) waits until
    every batch has been delivered, then the first one raises."""
    from . import runtime as _rt
    if not _rt._live(qr):
        return
    if getattr(qr, "serve_emit", False) or getattr(qr, "pipeline_emit", 0) \
            or (getattr(qr, "async_emit", False) and
                qr.app._drainer is not None):
        for (out, header), now in zip(results, nows):
            _rt._emit(qr, out, header, now, deliver)
        return
    hdrs = _rt.fetch_headers([h for _, h in results])
    first_exc = None
    for (out, _), hdr, now in zip(results, hdrs, nows):
        try:
            deliver(qr, out, hdr, now)
        except Exception as exc:  # noqa: BLE001 — deliver the rest
            first_exc = first_exc or exc
    if first_exc is not None:
        raise first_exc
