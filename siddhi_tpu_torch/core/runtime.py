"""App runtime (port of the pattern-query and single-stream-query subset of
`siddhi_tpu/core/runtime.py`): manager, junctions, input handlers,
callbacks, the timer scheduler.

A send stages the micro-batch into numpy once.  Each subscribed pattern
query resolves partition keys to dense slots on the host
(`core/keyslots.py`, C pass in `native/staging.c`), ships the batch and the
[Kb, E] selection to its device, runs one step, and fetches only the
two-count emission header.  Each single-stream query resolves its group-by
slots on the host, ships the batch, runs one step (filters, window,
aggregation, having, projection) and fetches its [n_valid, n_current, wake,
missed] header in one sync.  Each join query subscribes to both sides'
streams; a batch on one side binds its equi-join key slots on the host,
runs that side's step (filters, window, lane table, probe, projection) and
fetches its [n_valid, n_current, n_dropped, lane overflow, wake, missed]
header in one sync.  Rows transfer when a consumer reads them.

A pattern query with absent atoms also fetches its wake (the earliest
pending absent deadline) with the header, and the scheduler runs its timer
step at that time.

A query whose output target is a table writes it after its event
callbacks (`_apply_table_op`): its CURRENT rows, in delivery order,
drive an insert, a delete, an update or an update-or-insert
(`core/table.py`, kernels K9 and K10).  `query()` runs an on-demand query
(`core/ondemand.py`) against the tables' current contents.

A query with `output ... every` / `output snapshot every` hands its
delivered events to its rate limiter (`core/ratelimit.py`, host code),
which forwards what is due; a time or snapshot limiter ticks from the
timer scheduler.  A single-stream query inside a partition keeps its
window per partition key: its events group per key on the host
(`slots_and_group`) and `kstep` advances every key's window (kernel K11);
a timer tick advances every key.  A range partition's key is the label
of the first range a row matches (conditions evaluated on the host); a
row that matches none leaves the query.  `@purge` frees the key slots
that stayed idle past `idle.period` and resets their state on the device
(`_PartitionPurger`).

Ported: stream definitions, `@app:playback` (with `idle.time` and
`increment`), value and range partitions around pattern, single-stream
(`length` / `time` / `lengthBatch` / `timeBatch` windows kept per key, or
none) and join queries (value partitions only), `@purge`, output rate
limiting,
top-level pattern queries (non-partitioned simple chains
on the block NFA, absent atoms with their timer step),
top-level single-stream queries (filters, `length` / `time` /
`lengthBatch` windows, group by, having, `@capacity(window='N')`),
stream-stream joins (`length` / `time` windows, inner and outer,
`unidirectional`, the equi-join bucket path and the grid path, having),
in-memory tables (`@PrimaryKey`, `@Index`, `@capacity(rows=...)`; insert,
delete, update, update or insert; stream-table joins with a windowed or
windowless stream side, on the grid or the table fast path; on-demand
queries),
the timer scheduler (playback
drain and wall-clock thread), `InputHandler.send` / `send_columns`,
synchronous junctions, the three callback kinds, emission-cap growth,
`flush` and `shutdown`; incremental aggregations (`core/aggregation.py`,
kernels K27 and K28), named windows (`NamedWindowRuntime`: a shared window
processor whose published rows reader queries, bidirectional joins and
stream callbacks receive; joins and on-demand reads probe its contents)
and triggers (`TriggerRuntime`, host code on the scheduler); the dispatch
layer: merge groups (`optimizer/mqo.py`), `@fuse` stacks
(`core/fusion.py`), `@serve` emission rings (`serving/`), `@pipeline`
and `@async` (`_emit`, `_EmissionDrainer`, a stream's ingress queue),
the manager's config properties.  Everything else raises `CompileError`
naming its ROADMAP item.
"""
from __future__ import annotations

import collections
import contextlib
import heapq
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..exceptions import (DefinitionNotExistError, MatchOverflowError,
                          QueryNotExistError)
from ..query_api.app import SiddhiApp
from ..query_api.definition import StreamDefinition
from ..query_api.expression import Expression, Variable
from ..query_api.query import (JoinInputStream, Partition, Query,
                               RangePartitionType, SingleInputStream,
                               ValuePartitionType, Window)
from . import event as ev
from .executor import CompileError
from .keyslots import SlotAllocator
from .pattern_planner import plan_pattern_query
from .. import sharding as _sharding
from ..observability import phases as _phases
from ..observability import stateobs as _stateobs
from ..observability import tracing as _tracing
from .planner import plan_single_query
from .window import NO_WAKEUP, BatchFacts

_log = logging.getLogger("siddhi_tpu_torch")

# annotations whose machinery is not ported yet -> ROADMAP item
_UNPORTED_ANNOTATIONS = {
    "app:admission": "A15", "source": "A15",
    "sink": "A15", "store": "A15", "app:errorstore": "A15",
}

_NULL_CM = contextlib.nullcontext()


def _maybe_span(stage: str, **meta):
    """A `tracing.span` when a DETAIL pipeline trace is active on this
    thread, else a shared no-op context (reference `_maybe_span`,
    `siddhi_tpu/core/runtime.py:54`)."""
    if _tracing.active() is None:
        return _NULL_CM
    return _tracing.span(stage, **meta)


def _sub_name(sub, default: str) -> str:
    """Metric name of a junction subscriber (wrappers hold the runtime in
    `_qr`; runtimes carry `.name`)."""
    return getattr(getattr(sub, "_qr", sub), "name", default)


def _step_phase(qr, fn, name=None, mult=1):
    """Run one step call, recording its wall as the `dispatch_submit`
    phase (the kernels return at submit).  Every `profile.sample.every`
    dispatches per query the sampled deep mode records a CUDA event on
    the step's stream after the call and synchronizes it, recording that
    wait as `device_compute` (the reference's `block_until_ready` fence,
    `siddhi_tpu/core/runtime.py:69-95`); unsampled dispatches never wait.
    `mult`: the batches one dispatch serves (a @fuse stack), each of whose
    e2e samples contains this wall (observability/phases.py)."""
    st = qr.app.stats
    if not st.enabled:
        return fn()
    qname = name or qr.name
    ph = st.phases
    t0 = time.perf_counter_ns()
    res = fn()
    t1 = time.perf_counter_ns()
    ph.add(qname, "dispatch_submit", (t1 - t0) * mult)
    every = _phases.sample_every(qr.app)
    if every and ph.should_sample(qname, every):
        dev = qr.app.device
        if dev.type == "cuda":
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(dev))
            fence.synchronize()
        ph.add(qname, "device_compute",
               (time.perf_counter_ns() - t1) * mult)
    return res


_STATEOBS_ONE = np.ones(1, np.int64)


def _stateobs_feed_slots(qr, alloc, slots) -> None:
    """Fold one batch's resolved key slots (per-event slot ids, -1 =
    invalid) into the app's key-hotness tracker (reference
    `_stateobs_feed_slots`, `siddhi_tpu/core/runtime.py:216`): host numpy
    only; a disabled observatory costs one memoized dict read."""
    if not _stateobs.obs_enabled(qr.app):
        return
    slots = np.asarray(slots)
    live = slots[slots >= 0]
    if live.size == 0:
        return
    if live.size == 1:
        keys, counts = live, _STATEOBS_ONE
    else:
        keys, counts = np.unique(live, return_counts=True)
    qr.app.stats.stateobs.feed_keys(qr.name, alloc.capacity, keys, counts)


def _row_counts(sel) -> np.ndarray:
    """Valid entries of each row of a [K, E] selection (native pass)."""
    from ..native import LIB, ptr
    sel = np.ascontiguousarray(sel, np.int32)
    if LIB is None:
        return np.count_nonzero(sel >= 0, axis=1)
    import ctypes
    out = np.empty(sel.shape[0], np.int64)
    LIB.sg_row_counts(ptr(sel, ctypes.c_int32), sel.shape[0],
                      sel.shape[1] if sel.ndim == 2 else 1,
                      ptr(out, ctypes.c_int64))
    return out


def _stateobs_feed_group(qr, alloc, key_idx, sel, pad) -> None:
    """Fold one grouped batch's key set into the hotness tracker: the
    per-key row counts are the [Kb, E] selection's valid entries
    (reference `_stateobs_feed_group`, `:234`)."""
    if not _stateobs.obs_enabled(qr.app):
        return
    keys = np.asarray(key_idx)
    live = keys < pad
    n_live = int(np.count_nonzero(live))
    if not n_live:
        return
    counts = _row_counts(sel)
    if n_live < keys.shape[0]:
        keys, counts = keys[live], counts[live]
    qr.app.stats.stateobs.feed_keys(qr.name, alloc.capacity, keys, counts)


def _row_nbytes(qr) -> int:
    """Bytes of ONE output row from schema metadata (ts int64 + kind int32
    + each column's element size), cached per runtime: the
    `<q>.emitted_bytes` counter's unit (reference `_row_nbytes`,
    `siddhi_tpu/core/runtime.py:1147`)."""
    nb = qr.__dict__.get("_out_row_nbytes")
    if nb is None:
        nb = 12
        try:
            for t in qr.planned.out_schema.types:
                nb += int(np.dtype(ev.np_dtype(t)).itemsize)
        except Exception:  # noqa: BLE001 — metrics must not throw
            pass
        qr.__dict__["_out_row_nbytes"] = nb
    return nb


def _emitted(qr, rows: int) -> None:
    """Count a delivery's output rows and bytes (statistics on)."""
    st = qr.app.stats
    if st.enabled and rows:
        st.emitted(qr.name, rows, rows * _row_nbytes(qr))


def _deferred(deliver, ingest_ns):
    """`deliver` for a deferred path (@pipeline, @async, @serve): it runs
    under the dispatch's handed-off pipeline trace, so its spans join the
    originating trace on the drain track, and closes `<query>:e2e` after
    the delivery (reference `_emit_output_sync`, :1125-1145)."""
    trace = _tracing.handoff()
    if ingest_ns is None and trace is None:
        return deliver

    def run(qr, out, hdr, now):
        try:
            with _tracing.adopt(trace):
                deliver(qr, out, hdr, now)
        finally:
            st = qr.app.stats
            if ingest_ns is not None and st.enabled:
                st.e2e_latency(qr.name, time.perf_counter_ns() - ingest_ns)
    return run


def current_millis() -> int:
    return int(time.time() * 1000)


class StreamCallback:
    """Subscribe to all events of a stream (reference:
    CORE/stream/output/StreamCallback.java:38)."""

    def receive(self, events: List[ev.Event]) -> None:
        raise NotImplementedError


class QueryCallback:
    """Per-query output callback: receive(timestamp, current_events,
    expired_events)."""

    def receive(self, timestamp: int, in_events: Optional[List[ev.Event]],
                out_events: Optional[List[ev.Event]]) -> None:
        raise NotImplementedError


def _wrap_stream_callback(cb) -> Callable[[List[ev.Event]], None]:
    return cb.receive if isinstance(cb, StreamCallback) else cb


def _wrap_query_callback(cb) -> Callable:
    return cb.receive if isinstance(cb, QueryCallback) else cb


def _check_annotations(annotations, where: str) -> None:
    for ann in annotations:
        item = _UNPORTED_ANNOTATIONS.get(ann.name.lower())
        if item is not None:
            raise CompileError(
                f"@{ann.name} on {where} is not yet ported (ROADMAP {item})")
        if ann.name.lower() == "onerror" and \
                str(ann.element("action") or "LOG").upper() != "LOG":
            raise CompileError(
                f"@OnError(action='{ann.element('action')}') on {where} is "
                f"not yet ported (ROADMAP A15)")


class InputHandler:
    """reference: CORE/stream/input/InputHandler.java:50"""

    def __init__(self, stream_id: str, runtime: "SiddhiAppRuntime"):
        self.stream_id = stream_id
        self._runtime = runtime

    def send(self, data, timestamp: Optional[int] = None) -> None:
        """Accepts one event's data list/tuple, an Event, or a list of
        those."""
        self._runtime._route(self.stream_id, self._to_events(data, timestamp))

    def _to_events(self, data, timestamp) -> List[ev.Event]:
        now = timestamp if timestamp is not None \
            else self._runtime.timestamp_millis()
        if isinstance(data, ev.Event):
            return [data]
        if isinstance(data, (list, tuple)) and data and isinstance(
                data[0], (list, tuple, ev.Event)):
            return [d if isinstance(d, ev.Event) else ev.Event(now, d)
                    for d in data]
        return [ev.Event(now, list(data))]

    def send_columns(self, cols: Sequence, timestamps=None) -> None:
        """Columnar ingestion: `cols` is one numpy array per attribute (equal
        lengths; strings pre-encoded as interner ids).  Arrays that exactly
        fill the staging bucket are adopted, not copied: the caller must not
        mutate them after the send."""
        self._runtime._route_columns(self.stream_id, cols, timestamps)


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class PatternQueryRuntime:
    """Host wrapper for a pattern query: groups events per key into the
    [Kb, E] layout and drives the per-stream steps."""

    _EMIT_CAP_MAX = 512

    # dispatch decorations, set at wiring time (A12): the @fuse stack
    # (core/fusion.py), @async / @pipeline / @serve emission, the merge
    # group that dispatches this query (optimizer/mqo.py)
    _fuse = None
    async_emit = False
    pipeline_emit = 0
    serve_emit = False
    _merged = None

    def __init__(self, planned, app: "SiddhiAppRuntime",
                 slot_allocator=None):
        self.planned = planned
        self.app = app
        self.state = planned.init_state(planned.key_capacity)
        self.callbacks: List[Callable] = []
        self.batch_callbacks: List[Callable] = []
        self.slot_allocator = slot_allocator  # shared per partition
        self.next_wakeup: int = NO_WAKEUP
        self._qlock = threading.RLock()
        # set by _PartitionPurger: fn(slots, now) recording key liveness
        self._touch = None
        # set at wiring time: fn(new_cap) -> plan with a larger emission cap
        self._replan = None
        # steady-state block memo for _grouped_slots: (k0, n) ->
        # (allocator version, key_idx, sel, keys copy)
        self._block_cache: Dict = {}

    @property
    def name(self):
        return self.planned.name

    @property
    def shard_router(self):
        """The key-space router of a plan deployed on a mesh, else None
        (reference `_MeshResolved.shard_router`,
        `siddhi_tpu/core/runtime.py:324-347`); replans never change the
        mesh or the capacity, so it is resolved once."""
        r = self.__dict__.get("_shard_router_memo")
        if r is None:
            r = self._shard_router_memo = (_sharding.router_for(self),)
        return r[0]

    def _grow_emission_cap(self, n_dropped: int, n_valid: int = 0) -> bool:
        """Size the implicit per-key emission cap to the observed demand
        (next power of two) in one jump.  State shapes do not depend on the
        cap, so the live slab carries over.  Returns False once growth is
        exhausted."""
        if self._replan is None:
            return False
        cap = self.planned.compact_rows
        new_cap = _grown_cap(self, "pattern match rows", n_dropped,
                             max(n_valid + n_dropped, cap * 2), cap,
                             self._EMIT_CAP_MAX)
        if new_cap is None:
            return False
        self.planned = self._replan(new_cap)
        return True

    def _grouped_slots(self, key_cols, valid, p):
        """Slot resolution + [Kb, E] grouping with a steady-state block memo:
        when the allocator's bindings are unchanged since a key block was
        last resolved and the keys compare equal, the grouping replays from
        cache."""
        alloc = self.slot_allocator
        keys = key_cols[0] if len(key_cols) == 1 else None
        cacheable = (keys is not None and keys.dtype.kind in "iu" and
                     keys.shape[0] >= 1024 and bool(valid.all()))
        if cacheable:
            blk = (int(keys[0]), keys.shape[0])
            ent = self._block_cache.get(blk)
            if ent is not None and ent[0] == alloc.version and \
                    np.array_equal(keys, ent[3]):
                return ent[1], ent[2]
        _, key_idx, sel = alloc.slots_and_group(key_cols, valid,
                                                pad=p.key_capacity)
        if cacheable:
            if len(self._block_cache) >= 64:
                self._block_cache.clear()
            self._block_cache[blk] = (alloc.version, key_idx, sel,
                                      keys.copy())
        return key_idx, sel

    def process_staged(self, stream_id: str, staged: ev.StagedBatch,
                       now: int) -> None:
        fb = self._fuse
        if fb is not None and fb.offer((stream_id, staged, now), staged,
                                       stream_id):
            return
        if self.shard_router is not None:
            self._process_sharded(stream_id, staged, now)
            return
        p = self.planned
        dev = p.device
        B = staged.ts.shape[0]
        raw_cols = tuple(_h2d(c, dev) for c in staged.cols)
        # ts-delta wire: (base, i32 delta) instead of an i64 column when the
        # batch's span fits i32 (fit-checked over the real rows only)
        ts_wire = None
        if staged.n:
            tsn = staged.ts[:staged.n]
            base = int(tsn[0])
            dmax = int(tsn.max()) - base
            dmin = int(tsn.min()) - base
            if dmax < 2**31 and dmin >= -(2**31):
                delta32 = np.zeros(staged.ts.shape, np.int32)
                delta32[:staged.n] = tsn - base
                ts_wire = (base, _h2d(delta32, dev))
        raw_ts = _h2d(staged.ts, dev) if ts_wire is None else None
        if p.partition_positions:
            kf = (p.partition_key_fns or {}).get(stream_id)
            if kf is not None:
                # range partition: the label of each row's first matching
                # range; rows matching none are left out of the grouping
                key_cols, kvalid = kf(staged)
                valid = staged.valid & kvalid
            else:
                key_cols = [staged.cols[i]
                            for i in p.partition_positions[stream_id]]
                valid = staged.valid
            key_idx_np, sel = self._grouped_slots(key_cols, valid, p)
            _stateobs_feed_group(self, self.slot_allocator, key_idx_np, sel,
                                 p.key_capacity)
            if self._touch is not None:
                self._touch(key_idx_np, now)
            sel_d = _h2d(sel, dev)
            Kb = key_idx_np.shape[0]
            nuniq = int((key_idx_np < p.key_capacity).sum())
            # contiguous-slot fast path; the guard keeps the dense range
            # inside the slab, and nuniq > 1 keeps both packages on the same
            # step kind for every send
            if (nuniq > 1 and int(key_idx_np[0]) + Kb <= p.key_capacity and
                    int(key_idx_np[nuniq - 1]) ==
                    int(key_idx_np[0]) + nuniq - 1):
                key_ref = int(key_idx_np[0])
                steps = p.dense_steps_w if ts_wire else p.dense_steps
            else:
                key_ref = _h2d(key_idx_np, dev)
                steps = p.steps_w if ts_wire else p.steps
        else:
            if staged.valid.all():
                sel_np = np.arange(B, dtype=np.int32)[None, :]
            else:
                sel_np = np.where(staged.valid,
                                  np.arange(B, dtype=np.int32), -1)[None, :]
            sel_d = _h2d(sel_np, dev)
            key_ref = torch.zeros((1,), dtype=torch.int32, device=dev)
            steps = p.steps_w if ts_wire else p.steps
        pstate, sel_state = self.state
        ts_args = ts_wire if ts_wire else (raw_ts,)
        with _maybe_span("step", query=self.name, kind="pattern"):
            pstate, sel_state, out, wake = _step_phase(
                self, lambda: steps[stream_id](
                    pstate, sel_state, raw_cols, *ts_args, sel_d, key_ref,
                    now, **self.app.in_probe_kw(p.exec.in_deps)))
        self.state = (pstate, sel_state)
        _emit_output(self, out, now, wake)

    def _shard_prep(self, stream_id: str, staged: ev.StagedBatch,
                    now: int):
        """Staging-time routing of one batch through the key-space router
        (reference `_shard_prep`, `siddhi_tpu/core/runtime.py:782-828`):
        slot binding, the purger's liveness touch and the grouping
        (key_idx [n, Kb], sel [n, Kb, E]).  The reference's dirty marking
        for incremental snapshots waits for persistence (ROADMAP A13), its
        per-shard spans for the tracer's shard view."""
        p = self.planned
        kf = (p.partition_key_fns or {}).get(stream_id)
        if kf is not None:
            key_cols, kvalid = kf(staged)
            valid = staged.valid & kvalid
        else:
            key_cols = [staged.cols[i]
                        for i in p.partition_positions[stream_id]]
            valid = staged.valid
        t0 = time.perf_counter_ns()
        slots = self.slot_allocator.slots_for(key_cols, valid)
        _stateobs_feed_slots(self, self.slot_allocator, slots)
        if self._touch is not None:
            self._touch(slots, now)
        key_idx, sel, counts = self.shard_router.group(slots, staged.valid)
        stats = self.app.stats
        if stats.enabled:
            stats.shard_events(self.name, counts)
            stats.phases.add(self.name, "stage_host",
                             time.perf_counter_ns() - t0)
        return key_idx, sel

    def _process_sharded(self, stream_id: str, staged: ev.StagedBatch,
                         now: int) -> None:
        """The mesh path (reference `_process_sharded`, `:830-847`): each
        key routes to its shard (slot % n) and every shard steps its own
        key rows (`pattern_planner.ShardedStep`)."""
        p = self.planned
        key_idx, sel = self._shard_prep(stream_id, staged, now)
        dev = p.mesh.first
        self.state, out, wake = p.steps[stream_id](
            self.state, tuple(_h2d(c, dev) for c in staged.cols),
            _h2d(staged.ts, dev), sel, key_idx, now,
            **self.app.in_probe_kw(p.exec.in_deps))
        _emit_output(self, out, now, wake)

    def on_timer(self, now: int) -> None:
        """The timer step (absent deadlines) over the whole slab (on a
        mesh, over every shard's slab)."""
        p = self.planned
        if p.timer_step is None:
            return
        kw = self.app.in_probe_kw(p.exec.in_deps)
        if p.mesh is not None:
            self.state, out, wake = p.timer_step(self.state, now, **kw)
            _emit_output(self, out, now, wake)
            return
        pstate, sel_state = self.state
        pstate, sel_state, out, wake = p.timer_step(
            pstate, sel_state, now, **kw)
        self.state = (pstate, sel_state)
        _emit_output(self, out, now, wake)

    def _apply_wake(self, w: int) -> None:
        self.next_wakeup = w
        if w < NO_WAKEUP:
            self.app._scheduler.notify_at(w, self)


def _target_live(qr) -> bool:
    if getattr(qr, "table_op", None) is not None or \
            getattr(qr, "rate_limiter", None) is not None:
        return True
    tgt = qr.planned.output_target
    if not tgt:
        return False
    if tgt in qr.app.named_windows:
        return True
    j = qr.app.junctions.get(tgt)
    return j is not None and bool(j.queries or j.stream_callbacks or
                                  qr.app.stats.enabled)


def _live(qr) -> bool:
    """Anything downstream that would read this output (checked before any
    device-to-host transfer)."""
    return bool(qr.callbacks or qr.batch_callbacks or _target_live(qr))


def _timed(qr) -> bool:
    """A query whose device wake must be applied after every step (absent
    atoms, time / cron windows): its emission never defers."""
    p = qr.planned
    if isinstance(qr, PatternQueryRuntime):
        return p.timer_step is not None
    return bool(p.needs_timer)


def _emit(qr, out, header, now: int, deliver) -> None:
    """Emission entry (reference `_emit_output`,
    `siddhi_tpu/core/runtime.py:899-960`): `header` is the step's device
    counts (i64[H]), `deliver(qr, out, header as a host list, now)` its
    delivery.  `@serve` appends the output to the query's emission ring on
    the card and returns (the serving drainer delivers it); `@async` hands
    it to the app's emission drainer thread; `@pipeline(depth=k)` keeps
    up to k deferred emissions on the producer (depth 1 delivers each
    send's predecessor; depth k drains to k/2 in one batched fetch).
    Timer-bearing queries never defer: a deferred wake would stall their
    expiry.  Otherwise the header comes to the host in one transfer and
    the delivery runs inline."""
    timed = _timed(qr)
    live = _live(qr)
    if not live and not timed:
        return
    # the send's acceptance stamp (statistics on, inside a junction
    # dispatch): a deferred delivery closes `<query>:e2e` itself, an
    # inline one leaves it to the dispatcher (`_e2e_owed`)
    ingest_ns = qr.__dict__.get("_ingest_ns")
    if live and not timed and out is not None:
        if getattr(qr, "serve_emit", False):
            from ..serving import ring_append
            ring_append(qr, out, header, now,
                        _deferred(deliver, ingest_ns))
            return
        if getattr(qr, "async_emit", False) and \
                qr.app._drainer is not None:
            qr.app._drainer.enqueue(qr, out, header, now,
                                    _deferred(deliver, ingest_ns))
            return
        depth = int(getattr(qr, "pipeline_emit", 0) or 0)
        if depth:
            dq = qr.__dict__.get("_pending_emit")
            if dq is None:
                dq = qr._pending_emit = collections.deque()
            dq.append((out, header, now, _deferred(deliver, ingest_ns)))
            if len(dq) > depth:
                if depth == 1:
                    _deliver_output(qr, *dq.popleft())
                else:
                    take = len(dq) - depth // 2
                    _deliver_many(qr, [dq.popleft() for _ in range(take)])
            return
    if live and ingest_ns is not None:
        qr.__dict__["_e2e_owed"] = True
    _deliver_output(qr, out, header, now, deliver)


def _deliver_output(qr, out, header, now: int, deliver) -> None:
    """Fetch one emission's header and deliver it.  A pending window-fill
    probe (kernel K33's counts, `observability/stateobs.py`) rides the
    same transfer: the header and the counts are joined on the device
    and come to the host together (reference `_deliver_output`,
    `siddhi_tpu/core/runtime.py:968-992`)."""
    st = qr.app.stats
    t0 = time.perf_counter_ns()
    probe = _stateobs.take_fill_probe(qr) if _live(qr) else None
    if probe is None:
        hdr, fills = ev.device_get(header).tolist(), None
    else:
        h = header.reshape(-1)
        flat = ev.device_get(torch.cat([h.to(torch.int64), probe])).tolist()
        hdr, fills = flat[:h.numel()], flat[h.numel():]
    if st.enabled:
        st.phases.add(qr.name, "d2h_drain", time.perf_counter_ns() - t0)
    if fills is not None:
        _stateobs.record_fill(qr, fills)
    deliver(qr, out, hdr, now)


def fetch_headers(headers) -> List[List[int]]:
    """Several emissions' headers in ONE device-to-host transfer."""
    if not headers:
        return []
    flat = ev.device_get(torch.cat([h.reshape(-1) for h in headers]))
    out, o = [], 0
    for h in headers:
        n = h.numel()
        out.append(flat[o:o + n].tolist())
        o += n
    return out


def _deliver_many(qr, items) -> None:
    """Deliver several deferred emissions of one query with ONE batched
    header fetch (reference `_deliver_many`, :997-1022)."""
    hdrs = fetch_headers([h for _, h, _, _ in items])
    for (out, _, now, deliver), hdr in zip(items, hdrs):
        deliver(qr, out, hdr, now)


def _drain_pending_emit(qr) -> None:
    """Deliver a @pipeline runtime's held emissions (flush / shutdown),
    under the query lock the producer's branch runs under."""
    if not qr.__dict__.get("_pending_emit"):
        return
    with qr._qlock:
        dq = qr.__dict__.get("_pending_emit")
        if not dq:
            return
        items = list(dq)
        dq.clear()
        _deliver_many(qr, items)


def _emit_output(qr, out, now: int, wake=NO_WAKEUP) -> None:
    """Emit one pattern step's output: its header is [n_valid, n_dropped]
    and, where the plan has absent atoms, the wake (the earliest pending
    absent deadline)."""
    n_valid, n_dropped = out[0], out[1]
    parts = [n_valid, n_dropped]
    if qr.planned.timer_step is not None:
        parts.append(torch.as_tensor(wake, dtype=torch.int64,
                                     device=n_valid.device))
    _emit(qr, out, torch.stack(parts), now, _deliver_pattern)


def _deliver_pattern(qr, out, hdr, now: int) -> None:
    """Deliver one pattern step's output from its host header: apply the
    wake, fan out to batch callbacks, and decode rows to events only when
    an event consumer exists."""
    if qr.planned.timer_step is not None:
        nv, nd, w = hdr
        qr._apply_wake(w)
        if not _live(qr):
            return
    else:
        nv, nd = hdr[:2]
    _deliver_capped(qr, "pattern match rows", "per-key emission capacity",
                    nv, nv, nd, tuple(out[2:]), now)


def _grown_cap(qr, what: str, n_dropped: int, need: int,
               cur: Optional[int], cap_max: int) -> Optional[int]:
    """The implicit emission cap sized to the observed demand `need` in
    one jump (next power of two, at most `cap_max`), or None when that is
    no larger than `cur`.  Logs the growth."""
    new_cap = min(1 << (need - 1).bit_length(), cap_max)
    if cur is not None and new_cap <= cur:
        return None
    if qr.app.stats.enabled:
        qr.app.stats.counter_inc(f"{qr.name}.cap_growths")
    _log.warning(
        "%s: %d %s dropped at emission capacity%s; growing the cap to %d "
        "(set @emit(rows='N') to pre-size and silence this)", qr.name,
        n_dropped, what, "" if cur is None else f" {cur}", new_cap)
    return new_cap


def _deliver_capped(qr, what: str, cap_name: str, nv: int, ncur: int,
                    nd: int, rows, now: int) -> None:
    """Deliver one step's `nv` kept rows (`ncur` of them CURRENT), `nd`
    more having been dropped at the emission cap.  An implicit cap must not
    lose rows silently: it grows for the next batches (`qr`'s
    `_grow_emission_cap`), and once growth is exhausted the loss raises
    MatchOverflowError after this batch's rows are delivered.  Past an
    explicit cap the rows are dropped with a warning."""
    overflow_exc = None
    p = qr.planned
    if p.compact_rows is not None and _stateobs.obs_enabled(qr.app):
        # emission-cap demand (nv + nd rows wanted out) is host-side off
        # the header: the high-water the sizing ledger keeps
        qr.app.stats.stateobs.observe(
            qr.name, "emission_cap", nv + nd, p.compact_rows,
            growable=not p.emit_explicit, config_key="@emit(rows='N')")
    if nd:
        if qr.app.stats.enabled:
            qr.app.stats.counter_inc(f"{qr.name}.dropped", nd)
        if not qr.planned.emit_explicit:
            if not qr._grow_emission_cap(nd, nv):
                overflow_exc = MatchOverflowError(
                    f"{qr.name}: {nd} {what} exceeded the {cap_name} this "
                    f"batch; set @emit(rows='N') on the query to raise the "
                    f"cap or accept capped delivery")
        else:
            _log.warning("%s: %d %s exceeded the %s this batch and were "
                         "dropped", qr.name, nd, what, cap_name)
    try:
        if nv:
            _emitted(qr, nv)
            _deliver(qr, {"n_valid": nv, "n_current": ncur,
                          "n_expired": nv - ncur, "n_dropped": nd},
                     *rows, now)
    finally:
        if overflow_exc is not None:
            raise overflow_exc


def _deliver(qr, counts, ots, okind, ovalid, ocols, now: int,
             ts_order: bool = True) -> None:
    """Fan one step's rows out to the batch callbacks, and decode them to
    events only for an event consumer: the valid rows in a stable
    timestamp order (`ts_order`, for rows compacted rank-major) or in row
    order.  An `emit` span on an active DETAIL trace."""
    if _tracing.active() is None:
        _deliver_rows(qr, counts, ots, okind, ovalid, ocols, now, ts_order)
        return
    with _tracing.span("emit", query=qr.name):
        _deliver_rows(qr, counts, ots, okind, ovalid, ocols, now, ts_order)


def _deliver_rows(qr, counts, ots, okind, ovalid, ocols, now: int,
                  ts_order: bool) -> None:
    p = qr.planned
    if qr.batch_callbacks:
        payload = _LazyBatchPayload(p.out_schema.names, ots, okind, ovalid,
                                    ocols, counts)
        for bcb in qr.batch_callbacks:
            bcb(now, payload)
    if not qr.callbacks and not _target_live(qr):
        return
    ts_np, okind_np, ovalid_np = (ev.device_get(x) for x in
                                  (ots, okind, ovalid))
    order = np.nonzero(ovalid_np)[0]
    if ts_order:
        order = order[np.argsort(ts_np[order], kind="stable")]
    table_op = getattr(qr, "table_op", None)
    if table_op is not None:
        # reference `_emit_output_sync_impl`: the event callbacks, then the
        # table op, once the batch holds a CURRENT or EXPIRED row
        k = okind_np[order]
        if not np.any((k == ev.CURRENT) | (k == ev.EXPIRED)):
            return
        if qr.callbacks:
            pairs = ev.unpack(p.out_schema, ev.EventBatch(
                ts_np[order], k, np.ones(order.shape[0], np.bool_),
                tuple(ev.device_get(c)[order] for c in ocols)),
                want_kinds=(ev.CURRENT, ev.EXPIRED))
            current = [e for kk, e in pairs if kk == ev.CURRENT]
            expired = [e for kk, e in pairs if kk == ev.EXPIRED]
            for cb in qr.callbacks:
                cb(now, current or None, expired or None)
        _apply_table_op(qr, order, ts_np, okind_np, ots, okind, ocols)
        return
    nw = qr.app.named_windows.get(p.output_target)
    if nw is not None and not qr.callbacks and \
            getattr(qr, "rate_limiter", None) is None:
        _insert_into_window(qr, nw, order, ts_np, okind_np, ocols)
        return
    if not qr.callbacks and getattr(qr, "rate_limiter", None) is None and \
            _route_rows(qr, order, ts_np, okind_np, ocols):
        return
    batch = ev.EventBatch(ts_np[order], okind_np[order],
                          np.ones(order.shape[0], np.bool_),
                          tuple(ev.device_get(c)[order] for c in ocols))
    pairs = ev.unpack(p.out_schema, batch,
                      want_kinds=(ev.CURRENT, ev.EXPIRED))
    if not pairs:
        return
    limiter = getattr(qr, "rate_limiter", None)
    if limiter is not None:
        # the limiter forwards what is due to _deliver_pairs (reference
        # `_emit_output_sync_impl`, siddhi_tpu/core/runtime.py:1334)
        limiter.process(pairs, now)
        return
    _deliver_pairs(qr, pairs, now)


def _routed_rows(qr, order, okind_np):
    """The rows (of `order`) that the query's output event type routes."""
    sel = qr.planned.output_event_type
    k = okind_np[order]
    keep = (k == ev.CURRENT) if sel == "CURRENT_EVENTS" else \
        (k == ev.EXPIRED) if sel == "EXPIRED_EVENTS" else \
        (k == ev.CURRENT) | (k == ev.EXPIRED)
    return order[keep]


def _stage_rows(ts, cols, types) -> ev.StagedBatch:
    """Routed rows staged as `_route` would stage their events: CURRENT, a
    float column's NaN as the canonical null, padded to the staging bucket
    size."""
    n = ts.shape[0]
    cap = ev.bucket_size(n)

    def staged(x, dtype):
        a = np.zeros(cap, dtype)
        a[:n] = x
        if a.dtype.kind == "f":
            a[:n][np.isnan(a[:n])] = np.nan
        return a
    return ev.StagedBatch(
        staged(ts, np.int64), np.zeros(cap, np.int32), np.arange(cap) < n,
        [staged(c, ev.np_dtype(t)) for c, t in zip(cols, types)], n)


def _insert_into_window(qr, nw, order, ts_np, okind_np, ocols) -> None:
    """`insert into` a named window without decoding the rows to events:
    the routed rows, in order, staged as the window's arrivals."""
    rows = _routed_rows(qr, order, okind_np)
    if not rows.shape[0]:
        return
    cols = [ev.device_get(c)[rows] for c in ocols]
    qr.app._route_window(nw, _stage_rows(ts_np[rows], cols,
                                         nw.schema.types),
                         int(ts_np[rows].max()))


def _route_rows(qr, order, ts_np, okind_np, ocols) -> bool:
    """`insert into` a stream without decoding the rows to events (a query
    with no event callback and no rate limiter): the routed rows, in
    order, staged as one batch.  Returns False where the rows must go
    through events: a target that is not a stream of the output's types,
    or an OBJECT column.  A STRING id the interner does not hold becomes
    the null id, as its decoding to None and re-interning would make it."""
    p = qr.planned
    app = qr.app
    j = app.junctions.get(p.output_target)
    types = [t.upper() for t in p.out_schema.types]
    if j is None or [t.upper() for t in j.schema.types] != types or \
            "OBJECT" in types:
        return False
    rows = _routed_rows(qr, order, okind_np)
    if not rows.shape[0]:
        return True
    cols = [ev.device_get(c)[rows] for c in ocols]
    known = len(app.interner)
    cols = [np.where((c < 0) | (c >= known), ev.NULL_ID, c)
            if t == "STRING" else c for c, t in zip(cols, types)]
    app._route_staged(j, _stage_rows(ts_np[rows], cols, types),
                      int(ts_np[rows].max()))
    return True


def _apply_table_op(qr, order, ts_np, okind_np, ots, okind, ocols) -> None:
    """Table writes from a query's output rows (reference `_apply_table_op`,
    `siddhi_tpu/core/runtime.py:1397`): the delivered rows in their order
    (a pattern's or a join's in the host's stable ts order, a single-stream
    query's in device row order), the CURRENT ones driving the op.  An
    insert or an upsert also takes a host copy of the rows: the primary-key
    allocator and the append bookkeeping run on the host."""
    op, table, cond, set_fns, key = qr.table_op
    # rows a serving drainer delivers are host tensors: the write runs on
    # the table's device all the same
    dev = table.device
    want = okind_np[order] == ev.CURRENT
    idx = _h2d(order.astype(np.int64), ots.device)
    cols = tuple(c[idx].to(dev) for c in ocols)
    batch = ev.EventBatch(ots[idx].to(dev), okind[idx].to(dev),
                          _h2d(want, dev), cols)
    staged = None
    if op in ("insert", "upsert"):
        staged = ev.StagedBatch(ts_np[order], okind_np[order], want,
                                [ev.device_get(c) for c in cols],
                                int(want.sum()))
    if op == "insert":
        table.insert(batch, staged)
    elif op == "delete":
        table.delete_where(cond, key, batch)
    elif op == "update":
        table.update_where(cond, key, batch, set_fns)
    else:
        table.update_where(cond, key, batch, set_fns, upsert=True,
                           staged=staged)


class _LazyBatchPayload(dict):
    """Batch-callback payload: the counts ride the header fetch; bulk rows
    move device->host on first access ('ts', 'kind', 'valid' together,
    'cols' as a dict of numpy columns)."""

    _LAZY = ("ts", "kind", "valid", "cols")
    _COUNTS = ("n_valid", "n_current", "n_expired", "n_dropped")

    def __init__(self, names, ots, okind, ovalid, ocols, counts):
        super().__init__()
        self._names = names
        self._ots, self._okind = ots, okind
        self._ovalid, self._ocols = ovalid, ocols
        for k, v in counts.items():
            dict.__setitem__(self, k, v)

    def __missing__(self, k):
        if k in ("ts", "kind", "valid"):
            dict.__setitem__(self, "ts", ev.device_get(self._ots))
            dict.__setitem__(self, "kind", ev.device_get(self._okind))
            dict.__setitem__(self, "valid", ev.device_get(self._ovalid))
            return dict.__getitem__(self, k)
        if k == "cols":
            v = dict(zip(self._names,
                         (ev.device_get(c) for c in self._ocols)))
            dict.__setitem__(self, k, v)
            return v
        raise KeyError(k)

    def _materialize(self):
        for k in self._LAZY:
            if not dict.__contains__(self, k):
                self[k]
        return self

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __contains__(self, k):
        return k in self._LAZY or dict.__contains__(self, k)

    def __iter__(self):
        return iter(dict.keys(self._materialize()))

    def keys(self):
        return dict.keys(self._materialize())

    def items(self):
        return dict.items(self._materialize())

    def values(self):
        return dict.values(self._materialize())

    def __len__(self):
        extra = sum(1 for k in dict.keys(self)
                    if k not in self._LAZY and k not in self._COUNTS)
        return len(self._LAZY) + len(self._COUNTS) + extra


def _deliver_pairs(qr, pairs, now: int) -> None:
    """Query callbacks, then routing into the output stream."""
    p = qr.planned
    current = [e for k, e in pairs if k == ev.CURRENT]
    expired = [e for k, e in pairs if k == ev.EXPIRED]
    for cb in qr.callbacks:
        cb(now, current or None, expired or None)
    if p.output_target:
        sel = p.output_event_type
        if sel == "CURRENT_EVENTS":
            routed = current
        elif sel == "EXPIRED_EVENTS":
            routed = expired
        else:
            routed = [e for _, e in pairs]
        if routed:
            qr.app._route(p.output_target, routed)


class _QSub:
    """A single-stream query's subscription to its input stream."""

    def __init__(self, qr: "QueryRuntime"):
        self._qr = qr

    def process_staged(self, staged, now):
        with self._qr._qlock:
            self._qr.process_staged(staged, now)


class _Sub:
    """A pattern or join query's subscription to one of its input streams:
    `which` tells the query where the batch came from (a pattern's stream
    id, a join's side)."""

    def __init__(self, qr, which):
        self._qr, self._which = qr, which

    def process_staged(self, staged, now):
        with self._qr._qlock:
            self._qr.process_staged(self._which, staged, now)


_ZERO_SLOTS: Dict[int, np.ndarray] = {}


def _zero_slots(cap: int) -> np.ndarray:
    """[cap] all-zero int32 group-slot column, cached read-only per size
    (queries without group by put every row in slot 0)."""
    z = _ZERO_SLOTS.get(cap)
    if z is None:
        z = _ZERO_SLOTS[cap] = np.zeros((cap,), np.int32)
    return z


class QueryRuntime:
    """Host wrapper around one planned single-stream query: group slots,
    the device step, wake scheduling, delivery (reference:
    `siddhi_tpu/core/runtime.py` QueryRuntime)."""

    # dispatch decorations, set at wiring time (A12): the @fuse stack
    # (core/fusion.py), @async / @pipeline / @serve emission, the merge
    # group that dispatches this query (optimizer/mqo.py)
    _fuse = None
    async_emit = False
    pipeline_emit = 0
    serve_emit = False
    _merged = None

    def __init__(self, planned, app: "SiddhiAppRuntime"):
        self.planned = planned
        self.app = app
        self.state = planned.init_state()
        self.callbacks: List[Callable] = []
        self.batch_callbacks: List[Callable] = []
        self.next_wakeup: int = NO_WAKEUP
        self._qlock = threading.RLock()
        # set by _PartitionPurger: fn(slots, now) recording the liveness of
        # the group slots (`_touch`) or, on a keyed window, of the window
        # keys (`_touch`) and the group slots (`_touch_group`)
        self._touch = None
        self._touch_group = None

    @property
    def name(self):
        return self.planned.name

    @property
    def state(self):
        """(window state, selector state); a merge group's member reads
        its view of the group's state (a shared unit's window once)."""
        mg = self._merged
        return self._state if mg is None else mg.member_state(self)

    @state.setter
    def state(self, v) -> None:
        mg = self._merged
        if mg is None:
            self._state = v
        else:
            mg.set_member_state(self, v)

    def _range_keys(self, staged: ev.StagedBatch):
        """A range partition's label column and the batch with the rows
        that match no range left out (reference `process_staged`,
        `siddhi_tpu/core/runtime.py:430-447`)."""
        kcols, kvalid = self.planned.partition_key_fn(staged)
        return list(kcols), ev.StagedBatch(
            staged.ts, staged.kind, staged.valid & kvalid, staged.cols,
            staged.n)

    def _group_slots(self, staged: ev.StagedBatch, kcols=()) -> np.ndarray:
        """Group slots of the batch's rows (host side: binds new keys):
        a range partition's labels lead the group key."""
        p = self.planned
        if p.slot_allocator is not None:
            gslot = p.slot_allocator.slots_for(
                list(kcols) + [staged.cols[i] for i in p.group_by_positions],
                staged.valid)
            if not kcols and not p.keyed_window and p.group_by_positions:
                # the reference's `_slots_for_batch` feed: group keys of a
                # plain step (merged and fused ones too, under this name)
                _stateobs_feed_slots(self, p.slot_allocator, gslot)
            return gslot
        return _zero_slots(staged.ts.shape[0])

    def process_staged(self, staged: ev.StagedBatch, now: int) -> None:
        fb = self._fuse
        if fb is not None and fb.offer((staged, now), staged, None):
            return
        p = self.planned
        if p.keyed_window:
            self._process_keyed(staged, now)
            return
        kcols = ()
        if p.partition_key_fn is not None:
            kcols, staged = self._range_keys(staged)
        gslot = self._group_slots(staged, kcols)
        if self._touch is not None:
            self._touch(gslot, now)
        batch = staged.to_device(p.in_schema, p.device)
        cur = np.logical_and(staged.valid, staged.kind == ev.CURRENT)
        facts = BatchFacts(staged.ts[cur], staged.ts.shape[0], staged, cur)
        kw = self.app.in_probe_kw(p.in_deps)
        if p.pair_allocs:
            # distinctCount: (group slot, value) -> pair slot, by input row
            # (reference `_slots_for_batch`, :401-457)
            kw["pslots"] = tuple(
                _h2d(alloc.slots_for([gslot, staged.cols[pos]],
                                     staged.valid), p.device)
                for alloc, pos in p.pair_allocs)
        with _maybe_span("step", query=self.name, kind="window"):
            self.state, out, header = _step_phase(self, lambda: p.step(
                self.state, batch, _h2d(gslot, p.device), now, facts,
                **kw))
        # sampled window-fill probe (K33): launched now, its counts ride
        # the header fetch in _deliver_output (observability/stateobs.py)
        _stateobs.arm_fill_probe(self)
        _emit_plain(self, out, header, now)

    def _process_keyed(self, staged: ev.StagedBatch, now: int,
                       all_keys: bool = False) -> None:
        """A window per partition key (reference `_process_keyed`,
        `siddhi_tpu/core/runtime.py:472`): the batch's events group per
        key into [Kb, E] on the host and `kstep` advances each key's
        window.  A timer tick advances every key, each seeing the TIMER row
        (row 0), with no group slots to resolve; it does not apply a range
        partition's key function, whose conditions a TIMER row's zeroed
        columns would fail."""
        p = self.planned
        if all_keys:
            key_idx, sel = p.timer_keys()
            gslot = _zero_slots(staged.ts.shape[0])
        else:
            if p.partition_key_fn is not None:
                kcols, staged = self._range_keys(staged)
                wkeys = kcols
            else:
                kcols = ()
                wkeys = [staged.cols[i] for i in p.window_key_positions]
            _, key_idx, sel = p.window_key_allocator.slots_and_group(
                wkeys, staged.valid, pad=p.key_capacity)
            _stateobs_feed_group(self, p.window_key_allocator, key_idx, sel,
                                 p.key_capacity)
            if self._touch is not None:
                self._touch(key_idx, now)
            key_idx, sel = _h2d(key_idx, p.device), _h2d(sel, p.device)
            gslot = self._group_slots(staged, kcols)
            if self._touch_group is not None:
                self._touch_group(gslot, now)
        batch = staged.to_device(p.in_schema, p.device)
        with _maybe_span("step", query=self.name, kind="keyed-window"):
            self.state, out, header = _step_phase(self, lambda: p.kstep(
                self.state, batch, _h2d(gslot, p.device), key_idx, sel,
                now, all_keys, **self.app.in_probe_kw(p.in_deps)))
        _emit_plain(self, out, header, now)

    def on_timer(self, now: int) -> None:
        staged = ev.pack_np(self.planned.in_schema, [], capacity=8)
        staged.ts[0] = now
        staged.kind[0] = ev.TIMER
        staged.valid[0] = True
        if self.planned.keyed_window:
            self._process_keyed(staged, now, all_keys=True)
            return
        self.process_staged(staged, now)

    def _apply_wake(self, w: int) -> None:
        self.next_wakeup = w
        if w < NO_WAKEUP:
            self.app._scheduler.notify_at(w, self)


# windows whose rows beyond their capacity are counted in the header's
# `missed` word (the reference drops them silently): what fills up
_HOLDS = {"timeBatch": "time batch window's slice",
          "externalTimeBatch": "externalTimeBatch window's slice",
          "externalTime": "externalTime window's buffer",
          "delay": "delay window's buffer",
          "session": "session window's session (per key)",
          "cron": "cron window's pending batch",
          "hopping": "hopping window's buffer",
          "batch": "batch window's chunk"}


def _slab_of(qr: QueryRuntime):
    """A keyed query's window slab (shard 0's on a mesh)."""
    st = qr.state
    return st[0][0] if qr.planned.keyed_mesh is not None else st[0]


def _emit_plain(qr: QueryRuntime, out, header, now: int) -> None:
    """Emit one plain step's output: its header is [n_valid, n_current,
    wake, missed]."""
    _emit(qr, out, header, now, _deliver_plain)


def _deliver_plain(qr: QueryRuntime, out, hdr, now: int) -> None:
    """Deliver one plain step's output from its host header.  A time
    window step whose expire bound missed rows left the window and the
    aggregates as they were and raises here.  The wake is applied before
    delivery, and rows move to the host only for an event consumer, valid
    ones in row (seq) order."""
    live = _live(qr)
    nv, ncur, wake, missed = hdr
    w = qr.planned.window
    if missed and w.name in _HOLDS:
        per_key = qr.planned.keyed_window and "per key" not in \
            _HOLDS[w.name]
        raise RuntimeError(
            f"query {qr.name!r}: {missed} rows did not fit the "
            f"{_HOLDS[w.name]}{' (per key)' if per_key else ''} of "
            f"{_slab_of(qr).C if qr.planned.keyed_window else w.capacity} "
            f"rows; raise @capacity(window=...)")
    if missed:
        raise RuntimeError(
            f"query {qr.name!r}: {missed} more rows expired than the time "
            f"window's expire bound allowed; the window and the aggregates "
            f"were left as they were")
    if getattr(w, "host_scheduled", False):
        # cron: the host's schedule, after every step (reference
        # `siddhi_tpu/core/runtime.py:466-467`)
        qr._apply_wake(w.host_next_wakeup(now))
    elif qr.planned.needs_timer:
        qr._apply_wake(wake)
    if not live or not nv:
        return
    _emitted(qr, nv)
    _deliver(qr, {"n_valid": nv, "n_current": ncur, "n_expired": nv - ncur,
                  "n_dropped": 0}, *out, now, ts_order=False)


class JoinQueryRuntime:
    """Host wrapper for a join query (reference:
    `siddhi_tpu/core/runtime.py:1422` JoinQueryRuntime): binds equi-join
    key slots and keeps the retention mirror on the host, probes a table
    side's index on the table fast path, runs the side's step against the
    other side's window or the table's current rows, schedules a time
    side's expiry and delivers the output.  The
    step's lane width and emission cap live on the plan and grow in place
    (the reference replans its jitted steps; the port's steps read them
    at each call)."""

    _EMIT_CAP_MAX = 1 << 21   # 2M emitted rows per batch

    # dispatch decorations, set at wiring time (A12): the @fuse stack
    # (core/fusion.py), @async / @pipeline / @serve emission, the merge
    # group that dispatches this query (optimizer/mqo.py)
    _fuse = None
    async_emit = False
    pipeline_emit = 0
    serve_emit = False
    _merged = None

    def __init__(self, planned, app: "SiddhiAppRuntime"):
        self.planned = planned
        self.app = app
        self.state = planned.init_state()
        self.callbacks: List[Callable] = []
        self.batch_callbacks: List[Callable] = []
        self.next_wakeup: int = NO_WAKEUP
        self._qlock = threading.RLock()
        self._zero: Dict[int, torch.Tensor] = {}
        self._jk = None
        if planned.fastpath == "bucket":
            from .join import JoinKeyTracker
            self._jk = JoinKeyTracker(planned.join_key_allocator,
                                      planned.ring_caps,
                                      planned.lane_buckets)

    @property
    def name(self):
        return self.planned.name

    def _grow_emission_cap(self, n_dropped: int, n_valid: int = 0) -> bool:
        """Size the implicit emission cap to the observed demand (next power
        of two) in one jump.  The batch that overflowed has lost its
        surplus rows all the same."""
        p = self.planned
        need = max(n_valid + n_dropped, 1024)
        cur = p.compact_rows
        if cur is not None and need <= cur:
            return True
        new_rows = _grown_cap(self, "join result rows", n_dropped, need, cur,
                              self._EMIT_CAP_MAX)
        if new_rows is None:
            return False
        p.compact_rows = new_rows
        return True

    def _join_key_probe(self, is_left: bool,
                        staged: ev.StagedBatch) -> np.ndarray:
        """Key bucket slots of one arriving batch (bucket fast path),
        cached on the staged batch per (runtime, side).  Grows the lane
        width before the step that would need it."""
        cache = staged.jprobe
        if cache is None:
            cache = staged.jprobe = {}
        key = (id(self), is_left)
        cached = cache.get(key)
        if cached is not None:
            return cached
        from .join import _norm_key_cols
        p = self.planned
        kvalid = staged.valid & (staged.kind == ev.CURRENT)
        pos = p.key_left if is_left else p.key_right
        slots = self._jk.track(
            is_left, _norm_key_cols(staged.cols, pos, p.key_dtypes), kvalid)
        need = self._jk.needed_k()
        if need > p.lane_k:
            self._grow_lane_k(need)
        out = np.where(kvalid, slots, -1).astype(np.int32)
        if _stateobs.obs_enabled(self.app):
            # lane demand: the tracker's running bucket-occupancy max
            self.app.stats.stateobs.observe(
                self.name, "join_lane", need, self.planned.lane_k,
                growable=True, config_key="auto (lane grows via replan)")
            _stateobs_feed_slots(self, p.join_key_allocator, out)
        cache[key] = out
        return out

    def _grow_lane_k(self, need: int) -> None:
        new_k = 1 << (max(need, 1) - 1).bit_length()
        _log.info("%s: growing equi-join candidate lanes to %d (max same-"
                  "bucket window occupancy %d)", self.name, new_k, need)
        self.planned.lane_k = new_k
        if self.app.stats.enabled:
            self.app.stats.counter_inc(f"{self.name}.lane_growths")

    def _table_probe(self, staged: ev.StagedBatch) -> np.ndarray:
        """The table index's candidates for one trigger batch (table fast
        path, reference `siddhi_tpu/core/runtime.py:1568`): [B, K] row ids
        ascending per row (the grid path's emission order), -1 where
        none."""
        p = self.planned
        tid = (p.left if p.table_is_left else p.right).stream_id
        table = self.app.tables[tid]
        vals = np.asarray(staged.cols[p.stream_key_pos])
        with table._lock:
            cand, ok = table.probe_rows(p.table_pos, vals)
        big = np.int32(np.iinfo(np.int32).max)
        cand = np.where(ok, cand, big)
        cand.sort(axis=1)
        return np.where(cand < big, cand, -1).astype(np.int32)

    def _zero_slots(self, n: int) -> torch.Tensor:
        z = self._zero.get(n)
        if z is None:
            z = self._zero[n] = torch.zeros(n, dtype=torch.int32,
                                            device=self.planned.device)
        return z

    def process_staged(self, is_left: bool, staged: ev.StagedBatch,
                       now: int) -> None:
        p = self.planned
        fb = self._fuse
        if fb is not None and not fb.bypass:
            if p.fastpath == "bucket":
                # bound (and the retention mirror fed) in arrival order;
                # the stack replays the cached probe (reference
                # `siddhi_tpu/core/fusion.py:398-403`)
                self._join_key_probe(is_left, staged)
            if fb.offer((is_left, staged, now), staged, is_left):
                return
        probe = None
        if p.fastpath == "bucket":
            probe = _h2d(self._join_key_probe(is_left, staged), p.device)
        side = p.left if is_left else p.right
        other = p.right if is_left else p.left
        step = p.step_left if is_left else p.step_right
        batch = staged.to_device(side.schema, p.device)
        cur = np.logical_and(staged.valid, staged.kind == ev.CURRENT)
        facts = BatchFacts(staged.ts[cur], staged.ts.shape[0])
        alloc = p.group_allocators[0 if is_left else 1]
        if alloc is not None:
            # the side's group slots ride its window (join group by)
            gslot = _h2d(alloc.slots_for(
                [staged.cols[i]
                 for i in p.group_positions[0 if is_left else 1]],
                staged.valid), p.device)
        else:
            gslot = self._zero_slots(staged.ts.shape[0])
        kw = self.app.in_probe_kw(p.in_deps)
        if not other.is_table:
            out, header = step(self.state, batch, gslot, probe, now, facts,
                               **kw)
        elif other.is_aggregation:
            # the buckets of the `per` duration within the range
            # (reference `_other_table`, :1626-1628)
            view = self.app.aggregations[other.stream_id].device_view(
                p.per_duration, p.within_range)
            out, header = step(self.state, batch, gslot, probe, now, facts,
                               view, **kw)
        elif other.is_named_window:
            # the shared window's contents (reference :1629-1634)
            nw = self.app.named_windows[other.stream_id]
            with nw._qlock:
                view = nw.current_buffer()
            out, header = step(self.state, batch, gslot, probe, now, facts,
                               view, **kw)
        else:
            # the table's current rows (reference `_other_table`, :1623)
            t = self.app.tables[other.stream_id]
            with t._lock:
                if p.fastpath == "table":
                    probe = _h2d(self._table_probe(staged), p.device)
                out, header = step(self.state, batch, gslot, probe, now,
                                   facts, (t.cols, t.ts, t.valid), **kw)
        _emit_join(self, out, header, now)

    def on_timer(self, now: int) -> None:
        p = self.planned
        for is_left, side in ((True, p.left), (False, p.right)):
            if side.window is not None and side.window.needs_timer:
                staged = ev.pack_np(side.schema, [], capacity=8)
                staged.ts[0] = now
                staged.kind[0] = ev.TIMER
                staged.valid[0] = True
                self.process_staged(is_left, staged, now)

    def _apply_wake(self, w: int) -> None:
        self.next_wakeup = w
        if w < NO_WAKEUP:
            self.app._scheduler.notify_at(w, self)


def _emit_join(qr: JoinQueryRuntime, out, header, now: int) -> None:
    """Emit one join step's output: its header is [n_valid, n_current,
    n_dropped, lane overflow, wake, missed]."""
    _emit(qr, out, header, now, _deliver_join)


def _deliver_join(qr: JoinQueryRuntime, out, hdr, now: int) -> None:
    """Deliver one join step's output from its host header.  A lane
    overflow (the lane table lost candidates) or a time side's short
    expire bound raises; rows past an implicit emission cap grow the cap
    for the next batches, past an explicit one they are dropped with a
    warning.  Rows move to the host only for an event consumer, the valid
    ones in a stable timestamp order."""
    p = qr.planned
    live = _live(qr)
    nv, ncur, nd, lane_over, wake, missed = hdr
    if nd and p.aggregates:
        raise RuntimeError(
            f"query {qr.name!r}: {nd} joined rows did not fit the emission "
            f"cap @emit(rows='{p.compact_rows}'); the aggregates missed "
            f"them (raise the cap)")
    if lane_over:
        raise RuntimeError(
            f"query {qr.name!r}: {lane_over} window rows did not fit the "
            f"equi-join candidate lanes (width {p.lane_k}); this step's "
            f"output is incomplete")
    if missed:
        raise RuntimeError(
            f"query {qr.name!r}: {missed} more rows expired than the time "
            f"window's expire bound allowed; the window was left as it was")
    if p.needs_timer:
        qr._apply_wake(wake)
    if not live or out is None:
        return
    _deliver_capped(qr, "join result rows", "emission capacity", nv, ncur,
                    nd, out, now)


class _ASub:
    """An aggregation's subscription to its input stream."""

    def __init__(self, agg):
        self._agg = agg

    def process_staged(self, staged, now):
        self._agg.process_staged(staged, now)


class TriggerRuntime:
    """An event generator into a stream named after the trigger (reference
    `TriggerRuntime`, `siddhi_tpu/core/runtime.py:1705`; CORE/trigger/
    {Start,Periodic,Cron}Trigger.java): each firing publishes one event
    `[triggered_time]` and reschedules itself on the app's scheduler.
    Host code."""

    def __init__(self, tdef, app: "SiddhiAppRuntime"):
        self.definition = tdef
        self.app = app
        self.stream_id = tdef.id
        self.name = f"trigger {tdef.id}"
        self._qlock = threading.RLock()
        self._cron = None
        if tdef.at is not None and tdef.at.lower() != "start":
            from ..utils.cron import CronExpression
            self._cron = CronExpression(tdef.at)

    def start(self, now: int) -> None:
        d = self.definition
        if d.at is not None and d.at.lower() == "start":
            self.app._scheduler.notify_at(now, self)
        elif d.at_every is not None:
            self.app._scheduler.notify_at(now + d.at_every, self)
        elif self._cron is not None:
            self.app._scheduler.notify_at(self._cron.next_fire(now), self)

    def on_timer(self, now: int) -> None:
        self.app._route(self.stream_id, [ev.Event(now, [now])])
        d = self.definition
        if d.at_every is not None:
            self.app._scheduler.notify_at(now + d.at_every, self)
        elif self._cron is not None:
            self.app._scheduler.notify_at(self._cron.next_fire(now), self)


class NamedWindowRuntime:
    """A shared window (reference `NamedWindowRuntime`,
    `siddhi_tpu/core/runtime.py:1738`; CORE/window/Window.java:65):
    queries insert into it, and reader queries, bidirectional joins and
    stream callbacks receive what it publishes, CURRENT and / or EXPIRED
    rows by its `output ... events`.  Joins and on-demand reads probe its
    contents (`current_buffer`).

    A step runs the port's window processor of the kind (with its
    kernels), fetches [valid rows, wake, missed] in one sync, and stages
    the published rows to numpy once for every subscriber.

    Capacity: the reference builds the window with a batch capacity of 512
    and 2,048 rows, so a `time` window silently drops its oldest unemitted
    rows beyond 2,048 (`siddhi_tpu/core/window.py:400-405`).  The port
    does not copy that: a `time` window's ring grows before a step whose
    rows could pass its capacity (the host's bound of the rows alive after
    the step), and every other kind keeps what it keeps or raises, naming
    its buffer, where rows would not fit."""

    def __init__(self, wdef, schema: ev.Schema, app: "SiddhiAppRuntime"):
        from ..kernels.filter_compact import FilterSpec
        from .window import create_window
        self.definition = wdef
        self.schema = schema
        self.app = app
        self.device = app.device
        w = wdef.window
        if w is None:
            raise CompileError(
                f"window definition {wdef.id!r} needs a window function")
        self.wproc = create_window(
            (w.namespace + ":" if w.namespace else "") + w.name, schema,
            w.parameters, batch_capacity=512)
        if getattr(self.wproc, "session_key_pos", None) is not None:
            # a shared window has no key axis: the key-less processor would
            # merge every key into one session
            raise CompileError(
                "session(gap, key) is not supported on a `define window` "
                "shared instance; use it on a query's input stream")
        self.needs_timer = self.wproc.needs_timer
        self.output_event_type = wdef.output_event_type or "ALL_EVENTS"
        self.subscribers: List = []
        self.stream_callbacks: List[Callable] = []
        self._qlock = threading.RLock()
        self.next_wakeup: int = NO_WAKEUP
        # no filters: every valid CURRENT row arrives
        self._fspec = FilterSpec(
            schema.types, [], [] if self.device.type == "cuda" else None,
            wdef.id)
        self.state = self.wproc.init_state(self.device)

    @property
    def name(self):
        return self.definition.id

    def current_buffer(self):
        """(cols, ts, alive) of the window's contents, or None for a kind
        whose reference state exposes no buffer."""
        return self.wproc.current_buffer(self.state)

    def _fit(self, staged: ev.StagedBatch, now: int) -> None:
        """Grow a `time` window's ring to hold every row that can be alive
        after this step."""
        from .window import TimeWindow
        if not isinstance(self.wproc, TimeWindow):
            return
        ring = self.state
        need = int(np.count_nonzero(staged.valid & (staged.kind ==
                                                    ev.CURRENT)))
        need += sum(n for _, hi, n in ring.facts.entries if hi > now)
        if need > ring.C:
            self.state = ring.grown(1 << (need - 1).bit_length())
            self.wproc.capacity = self.state.C

    def process_staged(self, staged: ev.StagedBatch, now: int) -> None:
        from .window import Rows
        self._fit(staged, now)
        batch = staged.to_device(self.schema, self.device)
        cur = np.logical_and(staged.valid, staged.kind == ev.CURRENT)
        facts = BatchFacts(staged.ts[cur], staged.ts.shape[0], staged, cur)
        gslot = torch.zeros(staged.ts.shape[0], dtype=torch.int32,
                            device=self.device)
        rows = Rows(ts=batch.ts, kind=batch.kind, valid=batch.valid,
                    seq=None, gslot=gslot, cols=batch.cols)
        self.state, wout = self.wproc.process(self.state, rows, self._fspec,
                                              now, facts)
        o = wout.rows
        wake = wout.next_wakeup
        if wake is None:
            wake = torch.tensor([NO_WAKEUP, 0], dtype=torch.int64,
                                device=self.device)
        nv, w, missed = torch.cat([o.valid.sum().reshape(1),
                                   wake]).tolist()
        if missed:
            what = _HOLDS.get(self.wproc.name, "time window's expire bound")
            raise RuntimeError(
                f"window {self.name!r}: {missed} rows did not fit the "
                f"{what}; the step was not applied in full")
        if getattr(self.wproc, "host_scheduled", False):
            w = self.wproc.host_next_wakeup(now)
        if self.needs_timer:
            self.next_wakeup = w
            if w < NO_WAKEUP:
                self.app._scheduler.notify_at(w, self)
        if nv:
            self._fanout(o, now)

    def on_timer(self, now: int) -> None:
        staged = ev.pack_np(self.schema, [], capacity=8)
        staged.ts[0] = now
        staged.kind[0] = ev.TIMER
        staged.valid[0] = True
        self.process_staged(staged, now)

    def _fanout(self, o, now: int) -> None:
        """The published rows (valid ones, in the step's row order, cut to
        the output event type) to the stream callbacks, then to each
        subscriber as one staged batch."""
        valid = ev.device_get(o.valid)
        kind = ev.device_get(o.kind)
        sel = self.output_event_type
        if sel == "CURRENT_EVENTS":
            keep = kind == ev.CURRENT
        elif sel == "EXPIRED_EVENTS":
            keep = kind == ev.EXPIRED
        else:
            keep = (kind == ev.CURRENT) | (kind == ev.EXPIRED)
        idx = np.nonzero(valid & keep)[0]
        n = idx.shape[0]
        if not n:
            return
        cap = ev.bucket_size(n)

        def staged_col(x, dtype):
            a = np.zeros(cap, dtype)
            a[:n] = ev.device_get(x)[idx]
            return a
        kinds = np.zeros(cap, np.int32)
        kinds[:n] = kind[idx]
        valid_s = np.zeros(cap, np.bool_)
        valid_s[:n] = True
        staged = ev.StagedBatch(
            staged_col(o.ts, np.int64), kinds, valid_s,
            [staged_col(c, ev.np_dtype(t))
             for c, t in zip(o.cols, self.schema.types)], n)
        if self.stream_callbacks:
            pairs = ev.unpack(self.schema, ev.EventBatch(
                staged.ts[:n], kinds[:n], valid_s[:n],
                tuple(c[:n] for c in staged.cols)),
                want_kinds=(ev.CURRENT, ev.EXPIRED))
            events = [e for _, e in pairs]
            for cb in self.stream_callbacks:
                cb(events)
        for q in self.subscribers:
            q.process_staged(staged, now)


class _EmissionDrainer:
    """The `@async` emission drainer (reference `_EmissionDrainer`,
    `siddhi_tpu/core/runtime.py:2435`): a background thread that fetches
    queued emissions' headers and delivers them, so the producer keeps
    dispatching device work.  It drains every queued emission (up to 32)
    with ONE header transfer.  The bounded queue backpressures the
    producer."""

    def __init__(self, capacity: int = 64):
        import queue
        self._q = queue.Queue(maxsize=capacity)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="siddhi-torch-drain")
        self._started = False
        self._start_lock = threading.Lock()

    def start(self) -> None:
        with self._start_lock:
            if not self._started:
                self._started = True
                self._thread.start()

    def enqueue(self, qr, out, header, now: int, deliver) -> None:
        self.start()
        self._q.put((qr, out, header, now, deliver))

    def flush(self) -> None:
        self._q.join()

    def pending(self) -> int:
        return self._q.unfinished_tasks

    def stop(self) -> None:
        if self._started:
            self._q.join()

    def _run(self) -> None:
        import queue as queue_mod
        while True:
            items = [self._q.get()]
            while len(items) < 32:
                try:
                    items.append(self._q.get_nowait())
                except queue_mod.Empty:
                    break
            try:
                hdrs = fetch_headers([it[2] for it in items])
            except Exception:  # noqa: BLE001 — the drainer must survive
                _log.exception("async emission fetch failed")
                hdrs = [None] * len(items)
            for (qr, out, _, now, deliver), hdr in zip(items, hdrs):
                try:
                    if hdr is not None:
                        deliver(qr, out, hdr, now)
                except Exception:  # noqa: BLE001 — the drainer survives
                    _log.exception("async emission error in %s",
                                   getattr(qr, "name", "?"))
                finally:
                    self._q.task_done()


class _Scheduler:
    """Timer queue injecting TIMER batches (reference:
    CORE/util/Scheduler.java:48).  In playback, due timers fire from the
    send path before the batch is dispatched (`drain_playback`); otherwise
    a thread fires them on the wall clock.  One entry per (time, query):
    the reference package pushes one per step, and its drain then runs a
    TIMER step per duplicate, each one expiring nothing."""

    def __init__(self, app: "SiddhiAppRuntime"):
        self.app = app
        self._heap: List = []
        self._pending = set()
        self._cv = threading.Condition()
        self._counter = 0
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.app.playback or self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="siddhi-torch-scheduler")
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def notify_at(self, ts: int, q) -> None:
        with self._cv:
            key = (ts, id(q))
            if key in self._pending:
                return
            self._pending.add(key)
            self._counter += 1
            heapq.heappush(self._heap, (ts, self._counter, q))
            self._cv.notify_all()

    def _pop(self):
        ts, _, q = heapq.heappop(self._heap)
        self._pending.discard((ts, id(q)))
        return ts, q

    def drain_playback(self, now: int) -> None:
        if self._draining:
            return
        self._draining = True
        try:
            while True:
                with self._cv:
                    if not self._heap or self._heap[0][0] > now:
                        return
                    ts, q = self._pop()
                with q._qlock:
                    q.on_timer(ts)
        finally:
            self._draining = False

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
                if not self._heap:
                    self._cv.wait(timeout=0.2)
                    continue
                ts = self._heap[0][0]
                now = self.app.timestamp_millis()
                if ts > now:
                    self._cv.wait(timeout=min((ts - now) / 1000.0, 0.2))
                    continue
                ts, q = self._pop()
            try:
                with q._qlock:
                    q.on_timer(max(ts, self.app.timestamp_millis()))
            except Exception:  # noqa: BLE001 — the scheduler must survive
                _log.exception("timer of query %s failed", q.name)


class _PartitionPurger:
    """Idle partition-key GC for `@purge` (reference `_PartitionPurger`,
    `siddhi_tpu/core/runtime.py:2223-2375`; PartitionRuntimeImpl.java
    :120-147).  It keeps the last event time of every key slot across a
    partition's runtimes (their `_touch` hooks); each tick, the slots idle
    past `idle.period` go back to their allocators and their state is reset
    in place on the device: a pattern's [W, K] key columns, a keyed
    window's counters, the selector's slots.  A join runtime has no
    liveness hook and is left out, as in the reference.  (The reference
    also skips distinctCount queries and marks purged pattern keys dirty
    for incremental snapshots; the port has no snapshots yet.)  A query
    with distinctCount pair slots is left out too, with a warning, as in
    the reference: its pair slots key on the group slots, which recycling
    would corrupt."""

    name = "partition purger"

    def __init__(self, app: "SiddhiAppRuntime", shared_alloc: SlotAllocator,
                 runtimes, interval_ms: int, idle_ms: int):
        self.app = app
        self.shared_alloc = shared_alloc
        self.runtimes = runtimes
        self.interval_ms = interval_ms
        self.idle_ms = idle_ms
        self._qlock = threading.RLock()
        self._seen_shared = np.zeros(shared_alloc.capacity, np.int64)
        self._seen_q: Dict[int, np.ndarray] = {}
        self._init_cols: Dict[int, Any] = {}
        for qr in runtimes:
            if isinstance(qr, PatternQueryRuntime):
                qr._touch = self._make_touch(self._seen_shared)
                mesh = qr.planned.mesh
                if mesh is None:
                    (b32, b64, _), _ = qr.planned.init_state(1)
                else:
                    # one key column of a shard's slab
                    (b32, b64, _), _ = qr.planned.init_state(mesh.n)[0]
                self._init_cols[id(qr)] = (b32[:, :1], b64[:, :1])
                continue
            if not hasattr(qr, "_touch"):
                continue
            if qr.planned.pair_allocs:
                # reference :2253-2262
                _log.warning(
                    "@purge skips query %s: distinctCount state is not "
                    "purgeable yet", qr.name)
                continue
            if qr.planned.keyed_window:
                # keyed windows share the partition's key allocator
                qr._touch = self._make_touch(self._seen_shared)
            alloc = qr.planned.slot_allocator
            if alloc is not None:
                seen = np.zeros(alloc.capacity, np.int64)
                self._seen_q[id(qr)] = seen
                if qr.planned.keyed_window:
                    qr._touch_group = self._make_touch(seen)
                else:
                    qr._touch = self._make_touch(seen)
        app._scheduler.notify_at(app.timestamp_millis() + interval_ms, self)

    @staticmethod
    def _make_touch(seen: np.ndarray):
        cap = seen.shape[0]

        def touch(slots, now: int) -> None:
            slots = np.asarray(slots)
            live = slots[(slots >= 0) & (slots < cap)]
            if live.size:
                seen[live] = now
        return touch

    @staticmethod
    def _idle_slots(alloc: SlotAllocator, seen: np.ndarray, now: int,
                    cutoff: int) -> np.ndarray:
        used = np.nonzero(alloc._used)[0]
        # a slot this purger has not seen touched starts ageing now
        fresh = used[seen[used] == 0]
        if fresh.size:
            seen[fresh] = now
        return used[seen[used] < cutoff]

    def on_timer(self, now: int) -> None:
        cutoff = now - self.idle_ms
        # every runtime this purger resets is locked first, so no step of
        # theirs interleaves with the resets
        with contextlib.ExitStack() as stack:
            for qr in self.runtimes:
                stack.enter_context(qr._qlock)
            idle = self._idle_slots(self.shared_alloc, self._seen_shared,
                                    now, cutoff)
            if idle.size:
                self.shared_alloc.purge(idle.tolist())
                for qr in self.runtimes:
                    if isinstance(qr, PatternQueryRuntime):
                        self._reset_pattern_keys(qr, idle)
                    elif isinstance(qr, QueryRuntime) and \
                            qr.planned.keyed_window:
                        self._reset_keyed_window(qr, idle)
            for qr in self.runtimes:
                seen = self._seen_q.get(id(qr))
                if seen is None:
                    continue
                alloc = qr.planned.slot_allocator
                qidle = self._idle_slots(alloc, seen, now, cutoff)
                if qidle.size:
                    alloc.purge(qidle.tolist())
                    self._reset_selector_slots(qr, qidle)
        self.app._scheduler.notify_at(now + self.interval_ms, self)

    @staticmethod
    def _reset_slots(state, specs, idx: torch.Tensor) -> None:
        """A selector's accumulators at `idx` back to their identities, so
        a recycled slot does not carry the purged key's aggregates."""
        for a, spec in zip(state, specs):
            a[idx[idx < a.shape[0]]] = spec.init

    @staticmethod
    def _by_shard(qr, mesh, idle: np.ndarray):
        """(shard state, local rows) of each shard holding some of the
        `idle` slots: slot s lives at local row s // n of shard s % n (the
        reference resets `router.state_row(s)`, `siddhi_tpu/core/
        runtime.py:2339-2393`); unsharded, the whole state and `idle`."""
        if mesh is None:
            return [(qr.state, idle)]
        n = mesh.n
        return [(qr.state[d], idle[idle % n == d] // n) for d in range(n)
                if np.any(idle % n == d)]

    def _reset_pattern_keys(self, qr, idle: np.ndarray) -> None:
        init32, init64 = self._init_cols[id(qr)]
        for ((b32, b64, _), sel_state), rows in self._by_shard(
                qr, qr.planned.mesh, idle):
            idx = _h2d(rows.astype(np.int64), b32.device)
            b32[:, idx] = init32.to(b32.device)
            b64[:, idx] = init64.to(b64.device)
            self._reset_slots(sel_state,
                              qr.planned.selector_exec.bank.specs, idx)

    def _reset_keyed_window(self, qr, idle: np.ndarray) -> None:
        for (slab, _), rows in self._by_shard(qr, qr.planned.keyed_mesh,
                                              idle):
            slab.reset_keys(_h2d(rows.astype(np.int64), slab.head.device))

    def _reset_selector_slots(self, qr, idle: np.ndarray) -> None:
        specs = qr.planned.selector_exec.bank.specs
        if qr.planned.keyed_mesh is not None:
            # a keyed window's selector state is replicated: every replica
            parts = [(st, idle) for st in qr.state]
        else:
            parts = self._by_shard(qr, qr.planned.mesh, idle)
        for (_, astate), rows in parts:
            if astate:
                self._reset_slots(astate, specs, _h2d(
                    rows.astype(np.int64), astate[0].device))


class StreamJunction:
    """Per-stream pub/sub hub (reference: CORE/stream/StreamJunction.java:61).
    A subscriber's failure is logged and the batch dropped for it (the
    reference's default @OnError action, LOG).

    Synchronous unless the stream is `@async(buffer.size, workers,
    queue.policy)` (reference `enable_async`, `siddhi_tpu/core/runtime.py
    :1875-1990`): then sends enqueue into a bounded queue and worker
    threads dispatch them.  `queue.policy='block'` (default) backpressures
    the producer; 'shed' drops the send with a warning instead.  With
    workers > 1 cross-batch order within the stream is relaxed, as the
    reference's multi-consumer ring relaxes it."""

    def __init__(self, schema: ev.Schema, stream_id: str = "", app=None):
        self.schema = schema
        self.stream_id = stream_id
        self.app = app
        self.queries: List[_Sub] = []
        self.stream_callbacks: List[Callable] = []
        self._async_q = None
        self._async_policy = "block"
        self._async_workers: List[threading.Thread] = []
        self._serve_staging = None
        self.shed_total = 0

    def subscribe_query(self, q) -> None:
        self.queries.append(q)

    def subscribe_callback(self, cb: Callable) -> None:
        self.stream_callbacks.append(cb)

    # -- @async ingress ---------------------------------------------------
    def enable_async(self, buffer_size: int = 256, workers: int = 1,
                     policy: str = "block") -> None:
        if self._async_q is not None:
            return
        if policy not in ("block", "shed"):
            raise CompileError(
                f"@async(queue.policy={policy!r}) on {self.stream_id!r}: "
                "policy must be 'block' or 'shed'")
        import queue
        self._async_policy = policy
        self._async_q = queue.Queue(maxsize=max(1, buffer_size))
        for i in range(max(1, workers)):
            t = threading.Thread(
                target=self._drain_async, daemon=True,
                name=f"siddhi-torch-ingest-{self.stream_id}-{i}")
            t.start()
            self._async_workers.append(t)

    def _serve_stage(self, staged: ev.StagedBatch) -> None:
        """Double-buffered upload (serving/staging.py) at the accept edge
        when a subscriber runs the serving loop."""
        on = self._serve_staging
        if on is None:
            on = self._serve_staging = any(
                getattr(getattr(q, "_qr", None), "serve_emit", False) or
                any(m.serve_emit for m in getattr(getattr(q, "_qr", None),
                                                  "members", ()))
                for q in self.queries)
        if on and self.app is not None:
            self.app._serve_stager.stage(staged, self.schema,
                                         self.app.device)

    def enqueue(self, tag: str, payload, now: int) -> None:
        if tag == "staged":
            self._serve_stage(payload)
        q = self._async_q
        if q is None:           # raced with stop_async: process inline
            self._dispatch(tag, payload, now)
            return
        if self._async_policy == "shed":
            import queue
            try:
                q.put_nowait((tag, payload, now))
            except queue.Full:
                n = payload.n if tag == "staged" else len(payload)
                self.shed_total += n
                _log.warning("@async queue for %r full: shed %d events "
                             "(queue.policy='shed')", self.stream_id, n)
            return
        q.put((tag, payload, now))

    def _dispatch(self, tag: str, payload, now: int) -> None:
        if tag == "staged":
            self.dispatch_staged(payload, now)
        elif tag == "published":
            self.publish_staged(payload, now)
        else:
            self.publish(payload, now)

    def _drain_async(self) -> None:
        while True:
            tag, payload, now = self._async_q.get()
            try:
                if tag == "stop":
                    return
                self._dispatch(tag, payload, now)
            except Exception:  # noqa: BLE001 — the worker must survive
                _log.exception("stream %s: async dispatch failed",
                               self.stream_id)
            finally:
                self._async_q.task_done()

    def flush_async(self) -> None:
        if self._async_q is not None:
            self._async_q.join()

    def pending_async(self) -> int:
        return self._async_q.unfinished_tasks if self._async_q is not None \
            else 0

    def stop_async(self) -> None:
        """Process every accepted send, then stop the workers."""
        q = self._async_q
        if q is None:
            return
        q.join()
        for _ in self._async_workers:
            q.put(("stop", None, 0))
        for t in self._async_workers:
            t.join(timeout=2.0)
        self._async_workers = []
        self._async_q = None

    def _dispatch_one(self, q, staged: ev.StagedBatch, now: int, stats,
                      n: int, traced: bool, ingest_ns=None) -> None:
        """One subscriber's processing, with its latency sample and (at
        DETAIL with an active trace) a per-query span (reference
        `_dispatch_one`, `siddhi_tpu/core/runtime.py:2025-2077`).  The
        send's acceptance stamp `ingest_ns` sits on the runtime while it
        processes, so its emission path closes `<query>:e2e`: an inline
        delivery here, after the step and the delivery."""
        if stats is None:
            q.process_staged(staged, now)
            return
        qname = _sub_name(q, self.stream_id)
        tgt = getattr(q, "_qr", None) or q
        t0 = time.perf_counter_ns()
        try:
            with (_tracing.span("query", query=qname) if traced
                  else _NULL_CM):
                tgt.__dict__["_ingest_ns"] = ingest_ns
                try:
                    q.process_staged(staged, now)
                finally:
                    tgt.__dict__["_ingest_ns"] = None
        finally:
            stats.query_latency(qname, n, time.perf_counter_ns() - t0)
            if ingest_ns is not None and \
                    tgt.__dict__.pop("_e2e_owed", False):
                stats.e2e_latency(qname, time.perf_counter_ns() - ingest_ns)

    def _stats(self):
        st = self.app.stats if self.app is not None else None
        return st if st is not None and st.enabled else None

    def dispatch_staged(self, staged: ev.StagedBatch, now: int,
                        stage_ns: int = 0) -> None:
        """Run every subscriber over a staged batch.  With statistics on:
        the stream's event count, each subscriber's latency and e2e, the
        junction's latency, `stage_ns` of host staging charged to every
        subscriber, and at DETAIL a pipeline trace."""
        s0 = time.perf_counter_ns()
        self._serve_stage(staged)
        stats = self._stats()
        if stats is None:
            for q in self.queries:
                try:
                    q.process_staged(staged, now)
                except Exception:  # noqa: BLE001 — @OnError LOG semantics
                    _log.exception("stream %s: processing failed; batch of "
                                   "%d events dropped", self.stream_id,
                                   staged.n)
            return
        ingest_ns = s0
        s1 = time.perf_counter_ns()
        ph = stats.phases
        for q in self.queries:
            qn = _sub_name(q, self.stream_id)
            ph.add(qn, "stage_host", stage_ns)
            ph.add(qn, "h2d", s1 - s0)
        stats.stream_in(self.stream_id, staged.n)
        tr = stats.tracer.start(self.stream_id, staged.n) \
            if stats.detail else None
        j0 = time.perf_counter_ns()
        try:
            for q in self.queries:
                try:
                    self._dispatch_one(q, staged, now, stats, staged.n,
                                       tr is not None, ingest_ns)
                except Exception:  # noqa: BLE001 — @OnError LOG semantics
                    _log.exception("stream %s: processing failed; batch of "
                                   "%d events dropped", self.stream_id,
                                   staged.n)
        finally:
            stats.junction_latency(self.stream_id,
                                   time.perf_counter_ns() - j0)
            if tr is not None:
                stats.tracer.finish(tr)

    def publish(self, events: List[ev.Event], now: int) -> None:
        t0 = time.perf_counter_ns()
        for cb in self.stream_callbacks:
            cb(events)
        if self.queries:
            t1 = time.perf_counter_ns()
            staged = ev.pack_np(self.schema, events)
            self.dispatch_staged(staged, now, time.perf_counter_ns() - t1)
        else:
            self._no_subscribers(len(events), t0)

    def _no_subscribers(self, n: int, t0: int) -> None:
        """Statistics of a batch no query subscribes to: its events and
        the junction's latency, as a dispatch records them."""
        stats = self._stats()
        if stats is not None:
            stats.stream_in(self.stream_id, n)
            stats.junction_latency(self.stream_id,
                                   time.perf_counter_ns() - t0)

    def publish_staged(self, staged: ev.StagedBatch, now: int) -> None:
        """`publish` of rows already staged: the stream callbacks get them
        as events, the subscribers the staged batch."""
        t0 = time.perf_counter_ns()
        if self.stream_callbacks:
            n = staged.n
            events = [e for _, e in ev.unpack(self.schema, ev.EventBatch(
                staged.ts[:n], staged.kind[:n], staged.valid[:n],
                tuple(c[:n] for c in staged.cols)))]
            for cb in self.stream_callbacks:
                cb(events)
        if self.queries:
            self.dispatch_staged(staged, now)
        else:
            self._no_subscribers(staged.n, t0)

    def queue_depth(self) -> int:
        """Sends waiting in the @async ingress queue (0 without one)."""
        q = self._async_q
        return q.qsize() if q is not None else 0


def _in_deps(node, seen=None) -> List[str]:
    """The tables a query's `x in T` conditions probe, in order of first
    appearance (reference: the planners' dependency scans)."""
    from ..query_api.expression import In
    seen = set() if seen is None else seen
    out: List[str] = []
    stack = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen or n is None or isinstance(
                n, (str, int, float, bool)):
            continue
        seen.add(id(n))
        if isinstance(n, In) and n.source_id not in out:
            out.append(n.source_id)
        if isinstance(n, dict):
            stack.extend(reversed(list(n.values())))
        elif isinstance(n, (list, tuple)):
            stack.extend(reversed(n))
        elif hasattr(n, "__dict__"):
            stack.extend(reversed(list(vars(n).values())))
    return out


class SiddhiAppRuntime:
    """reference: CORE/SiddhiAppRuntimeImpl.java:99"""

    def __init__(self, app: SiddhiApp, manager: "SiddhiManager",
                 name: Optional[str] = None, mesh=None):
        self.app = app
        self.manager = manager
        # a sharding.ShardMesh, or None (reference :2649-2652): partitioned
        # patterns, keyed windows and windowless partition group-bys split
        # their key state over it; everything else runs unsharded on its
        # first device
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else manager.device
        self.name = name or app.name or "SiddhiApp"
        self.interner = manager.interner
        self._lock = threading.RLock()
        self._started = False
        pb = app.get_annotation("app:playback")
        self.playback = pb is not None
        self._playback_time = 0
        # @app:playback(idle.time='...', increment='...'): when the input
        # goes quiet for idle.time (wall clock), advance the event clock by
        # increment and fire the timers it passes
        self._playback_idle_ms: Optional[int] = None
        self._playback_increment_ms = 1000
        self._playback_last_wall = current_millis()
        self._idle_stop: Optional[threading.Event] = None
        self._idle_thread: Optional[threading.Thread] = None
        if pb is not None and pb.element("idle.time") is not None:
            self._playback_idle_ms = _parse_time_ms(pb.element("idle.time"))
            self._playback_increment_ms = _parse_time_ms(
                pb.element("increment", "1 sec")) or 1000
        self._scheduler = _Scheduler(self)
        self._timed_limiters: List = []
        # statistics (reference :2700-2725): @app:statistics levels OFF /
        # BASIC / DETAIL, an include filter, a console reporter
        from ..utils.statistics import OFF, StatisticsManager
        st_ann = app.get_annotation("app:statistics")
        level = OFF
        if st_ann is not None:
            v = st_ann.element() or st_ann.element("level") or "BASIC"
            level = str(v).upper()
            if level == "TRUE":
                level = "BASIC"
            elif level == "FALSE":
                level = OFF
        self.stats = StatisticsManager(
            level, include=str(st_ann.element("include", ""))
            if st_ann is not None else "")
        self._stats_reporter = None
        if st_ann is not None and \
                str(st_ann.element("reporter", "")).lower() == "console":
            from ..utils.statistics import ConsoleReporter
            iv = _parse_time_ms(st_ann.element("interval", "5 sec")) or 5000
            self._stats_reporter = ConsoleReporter(self, iv / 1000.0)
        # the dispatch layer (A12): manager config, the @async emission
        # drainer, the serving loop's drainer and staging
        self.config_manager = manager.config_manager
        self._drainer = _EmissionDrainer()
        from ..serving import (DoubleBufferedStager, ServingDrainer,
                               serving_config)
        self._serve_drainer = ServingDrainer(
            self, serving_config(self)["drain_interval_ms"])
        self._serve_stager = DoubleBufferedStager()
        _check_annotations(
            [a for a in app.annotations
             if a.name.lower() not in ("app:playback",)], "the app")
        if app.function_definition_map:
            raise CompileError("functions are not yet ported (ROADMAP A4)")

        self.schemas: Dict[str, ev.Schema] = {}
        self.junctions: Dict[str, StreamJunction] = {}
        for sdef in list(app.stream_definition_map.values()):
            _check_annotations(sdef.annotations, f"stream {sdef.id!r}")
            self._define_stream_runtime(sdef)

        # in-memory tables (reference :2745-2781); @store tables raise
        from .table import TableRuntime
        self.tables: Dict[str, TableRuntime] = {}
        for tid, tdef in app.table_definition_map.items():
            _check_annotations(tdef.annotations, f"table {tid!r}")
            self.tables[tid] = TableRuntime(
                tdef, ev.Schema(tdef, self.interner), self.device)
        # named windows (reference :2783-2788; Window.java:65)
        self.named_windows: Dict[str, NamedWindowRuntime] = {}
        for wid, wdef in getattr(app, "window_definition_map", {}).items():
            _check_annotations(wdef.annotations, f"window {wid!r}")
            schema = ev.Schema(wdef, self.interner)
            self.schemas[wid] = schema
            self.named_windows[wid] = NamedWindowRuntime(wdef, schema, self)
        # incremental aggregations (reference :2790-2809): each subscribes
        # to its input stream, and its retention purge rides the scheduler
        # from construction on
        from .aggregation import AggregationRuntime
        self.aggregations: Dict[str, AggregationRuntime] = {}
        for aid, adef in app.aggregation_definition_map.items():
            _check_annotations(adef.annotations, f"aggregation {aid!r}")
            agg = AggregationRuntime(adef, self)
            self.aggregations[aid] = agg
            self.junctions[agg.input_stream_id].subscribe_query(_ASub(agg))
            if agg.purge_enabled:
                self._scheduler.notify_at(
                    self.timestamp_millis() + agg.purge_interval_ms, agg)
        # triggers define a stream `<id> (triggered_time long)` (reference
        # :2811-2820)
        self.triggers: Dict[str, TriggerRuntime] = {}
        for tid, tdef in app.trigger_definition_map.items():
            if tid not in self.schemas:
                sdef = StreamDefinition(tid).attribute("triggered_time",
                                                       "LONG")
                app.stream_definition_map[tid] = sdef
                self._define_stream_runtime(sdef)
            self.triggers[tid] = TriggerRuntime(tdef, self)
        # on-demand queries: parsed plans by query string, least recently
        # used first (reference: at most 50)
        self._ondemand_cache: "OrderedDict" = OrderedDict()
        self._ondemand_lock = threading.Lock()

        self.query_runtimes: Dict[str, Union[PatternQueryRuntime,
                                             QueryRuntime,
                                             JoinQueryRuntime]] = {}
        qi = 0
        for element in app.execution_element_list:
            if isinstance(element, Query):
                qname = self._query_name(element, qi)
                qi += 1
                if isinstance(element.input_stream, SingleInputStream):
                    self._add_query(element, qname)
                elif isinstance(element.input_stream, JoinInputStream):
                    self._add_join_query(element, qname)
                else:
                    self._add_pattern_query(element, qname)
            elif isinstance(element, Partition):
                qi = self._add_partition(element, qi)
        # whole-app multi-query optimizer: co-resident plain queries on one
        # stream run as merged dispatches (reference :2849-2859)
        from ..optimizer import apply_merge
        apply_merge(self)

    # -- `x in Table` probes ---------------------------------------------------
    def in_probe_tables(self, deps) -> Dict[str, Any]:
        """What each `x in T` probe of a step sees: the table's first
        column and valid flags as they stand at that step (reference
        `in_probe_tables`, `siddhi_tpu/core/runtime.py:3607`), the one
        definition every step kind ships."""
        from ..kernels.in_probe import InTab
        return {d: InTab(self.tables[d]) for d in deps}

    def in_probe_kw(self, deps) -> Dict[str, Any]:
        """A step's `in_tabs` keyword, for a query that probes tables."""
        return {"in_tabs": self.in_probe_tables(deps)} if deps else {}

    def _validate_in_deps(self, deps, qname: str) -> None:
        """`x in <id>` probes defined tables only (reference
        `_validate_in_deps`, `siddhi_tpu/core/runtime.py:3614`)."""
        for d in deps:
            if d not in self.tables:
                raise CompileError(
                    f"query {qname!r}: `in {d}` requires a defined table "
                    f"(named windows and aggregations are not probe-able "
                    f"with `in`; defined tables: {sorted(self.tables)})")

    def _in_cols(self, q: Query, qname: str) -> Dict[str, str]:
        """Validate a query's probes; the probed tables' first attribute
        types, which the kernels' compare types follow."""
        deps = _in_deps(q)
        self._validate_in_deps(deps, qname)
        return {d: self.tables[d].schema.types[0] for d in deps}

    # -- construction ---------------------------------------------------------
    def _define_stream_runtime(self, sdef: StreamDefinition):
        schema = ev.Schema(sdef, self.interner)
        self.schemas[sdef.id] = schema
        self.junctions[sdef.id] = StreamJunction(schema, stream_id=sdef.id,
                                                 app=self)

    def _query_name(self, q: Query, i: int) -> str:
        info = q.get_annotation("info")
        if info:
            n = info.element("name")
            if n:
                return n
        return f"query{i + 1}"

    # -- dispatch decorations (A12) ------------------------------------------
    def _serve_enabled(self, q) -> bool:
        """@serve on the query / an input stream / @app:serve, or the
        `serving.enabled` config property; an explicit @serve that does not
        enable opts the query out of the config blanket (reference
        `_serve_enabled`, `siddhi_tpu/core/runtime.py:3174`)."""
        from ..serving import serving_config
        from .plan_facts import serve_enabled
        if serve_enabled(self.app, q):
            return True
        if q.get_annotation("serve") is not None or \
                self.app.get_annotation("app:serve") is not None:
            return False
        return bool(serving_config(self)["enabled"])

    def _wire_dispatch(self, runtime, q, kind: str) -> None:
        """Stash a runtime's @async / @pipeline / @serve decisions and its
        @fuse stack at wiring time (reference :2988-2991, `_maybe_fuse`
        :3214)."""
        from . import fusion
        from .plan_facts import (async_enabled, fuse_depth, pipeline_depth,
                                 serve_ring_capacity)
        runtime.async_emit = async_enabled(self.app, q)
        runtime.pipeline_emit = pipeline_depth(self.app, q)
        runtime.serve_emit = self._serve_enabled(q)
        if runtime.serve_emit:
            runtime.serve_ring_capacity = serve_ring_capacity(self.app, q)
        k = fuse_depth(self.app, q)
        if k <= 0:
            return
        runtime._fuse_requested = k
        why = fusion.ineligible_reason(runtime, kind)
        if why is not None:
            runtime._fuse_excluded = why
            _log.warning("@fuse(batches=%d) ignored on query %s: %s", k,
                         runtime.name, why)
            return
        runtime._fuse = fusion.FuseBuffer(runtime, k, kind)

    def _add_query(self, q: Query, name: str) -> None:
        """A top-level single-stream query (filters, window, group by,
        having).  `@capacity(window='N')` sizes the window's buffer."""
        _check_annotations(q.annotations, f"query {name!r}")
        wch, wch_set = 2048, False
        cap_ann = q.get_annotation("capacity")
        if cap_ann is not None and cap_ann.element("window"):
            wch, wch_set = int(cap_ann.element("window")), True
        kw = dict(window_capacity_hint=wch)
        # session(gap, key) keeps a window per key outside partitions: the
        # per-key batches are small, so the window's shapes key off a batch
        # capacity of 64 and a per-key capacity of max(@capacity(window),
        # 128); @capacity(keys) keys (reference runtime.py:2958-2980)
        if any(isinstance(h, Window) and h.name == "session" and
               len(h.parameters) >= 2
               for h in getattr(q.input_stream, "stream_handlers", [])):
            kcap = 4096
            if cap_ann is not None and cap_ann.element("keys"):
                kcap = int(cap_ann.element("keys"))
            if self.mesh is not None:
                # reference :2971-2973
                n = self.mesh.n
                kcap = ((kcap + n - 1) // n) * n
            kw = dict(batch_capacity=64,
                      window_capacity_hint=wch if wch_set else 128,
                      window_key_allocator=SlotAllocator(
                          kcap, name=f"{name}:sessionkey"),
                      key_capacity=kcap, mesh=self.mesh)
        from_window = q.input_stream.unique_stream_id in self.named_windows
        planned = plan_single_query(q, name, self.schemas, self.interner,
                                    device=self.device,
                                    in_cols=self._in_cols(q, name),
                                    named_window_input=from_window, **kw)
        runtime = QueryRuntime(planned, self)
        self.query_runtimes[name] = runtime
        self._wire_dispatch(runtime, q, "plain")
        if from_window:
            # a reader of a named window (reference :2993-2994)
            self.named_windows[planned.input_stream_id].subscribers.append(
                _QSub(runtime))
        else:
            self.junctions[planned.input_stream_id].subscribe_query(
                _QSub(runtime))
        self._wire_output(runtime, q, planned, name)

    def _add_join_query(self, q: Query, name: str) -> None:
        """A top-level stream-stream join: one runtime subscribed to both
        sides' streams (the left side first, so a self-join runs its left
        step first)."""
        from .join import plan_join_query
        _check_annotations(q.annotations, f"query {name!r}")
        planned = plan_join_query(q, name, self.schemas, self.interner,
                                  device=self.device, tables=self.tables,
                                  in_cols=self._in_cols(q, name),
                                  aggregations=self.aggregations,
                                  named_windows=self.named_windows)
        runtime = JoinQueryRuntime(planned, self)
        self.query_runtimes[name] = runtime
        self._wire_dispatch(runtime, q, "join")
        for side, is_left in ((planned.left, True), (planned.right, False)):
            if not side.is_table:
                self.junctions[side.stream_id].subscribe_query(
                    _Sub(runtime, is_left))
            elif side.is_named_window and (
                    planned.step_left if is_left else
                    planned.step_right) is not None:
                # bidirectional: the rows the shared window publishes
                # trigger the join too (reference :3139-3146)
                self.named_windows[side.stream_id].subscribers.append(
                    _Sub(runtime, is_left))
        self._wire_output(runtime, q, planned, name)

    def _add_pattern_query(self, q: Query, name: str, key_capacity: int = 1,
                           slots: Optional[int] = None, positions=None,
                           allocator=None, key_fns=None,
                           mesh=None) -> None:
        _check_annotations(q.annotations, f"query {name!r}")
        if slots is None:
            slots = 8
            cap_ann = q.get_annotation("capacity")
            if cap_ann is not None:
                slots = int(cap_ann.element("slots", slots))

        in_cols = self._in_cols(q, name)

        def plan(cap=None):
            return plan_pattern_query(
                q, name, self.schemas, self.interner,
                key_capacity=key_capacity, slots=slots,
                partition_positions=positions, compact_rows_override=cap,
                device=self.device, in_col0_types=in_cols,
                partition_key_fns=key_fns, mesh=mesh)

        planned = plan()
        runtime = PatternQueryRuntime(planned, self, slot_allocator=allocator)
        # the SAME closure replans on emission-cap growth
        runtime._replan = plan
        self.query_runtimes[name] = runtime
        self._wire_dispatch(runtime, q, "pattern")
        for sid in planned.spec.stream_ids:
            self.junctions[sid].subscribe_query(_Sub(runtime, sid))
        self._wire_output(runtime, q, planned, name)

    def _add_partition(self, part: Partition, qi: int) -> int:
        """Partitions: the partition key becomes an explicit key axis of the
        pattern state, of a keyed window, of the group key, or an extra
        equality of a join's `on` (reference `_add_partition`,
        `siddhi_tpu/core/runtime.py:3234`;
        CORE/partition/PartitionRuntimeImpl.java).  A range partition's key
        is a function of the row (`_range_key_fn`) in place of a
        position.  `@purge` on the partition or any of its queries starts
        a `_PartitionPurger` over its runtimes."""
        _check_annotations(part.annotations, "a partition")
        positions: Dict[str, List[int]] = {}
        key_fns: Dict[str, Callable] = {}
        for sid, pt in part.partition_type_map.items():
            schema = self.schemas.get(sid)
            if schema is None:
                raise CompileError(f"undefined partitioned stream {sid!r}")
            if isinstance(pt, RangePartitionType):
                key_fns[sid] = self._range_key_fn(sid, schema, pt)
                positions[sid] = []
                continue
            if not isinstance(pt.expression, Variable):
                raise CompileError(
                    "partition-by expression must be a plain attribute in "
                    "this build")
            positions[sid] = [schema.position(pt.expression.attribute_name)]

        # @capacity(keys, slots, window) on the partition or any of its
        # queries; `window` is the per-key row capacity of a time window
        keys_cap, nfa_slots, win_cap = 4096, 8, 128
        all_anns = list(part.annotations)
        for q in part.query_list:
            all_anns.extend(q.annotations)
        for ann in all_anns:
            if ann.name.lower() == "capacity":
                keys_cap = int(ann.element("keys", keys_cap))
                nfa_slots = int(ann.element("slots", nfa_slots))
                win_cap = int(ann.element("window", win_cap))
        if self.mesh is not None:
            # the key capacity rounds up to a multiple of the shards
            # (reference :3306-3308)
            n = self.mesh.n
            keys_cap = ((keys_cap + n - 1) // n) * n
        shared_allocator = SlotAllocator(keys_cap, name="partition")
        part_runtimes = []
        for q in part.query_list:
            qname = self._query_name(q, qi)
            qi += 1
            if isinstance(q.input_stream, JoinInputStream):
                self._add_partitioned_join(q, qname, positions, key_fns)
            elif isinstance(q.input_stream, SingleInputStream):
                self._add_partitioned_query(q, qname, positions, keys_cap,
                                            win_cap, shared_allocator,
                                            key_fns)
            else:
                ppos, pfns = {}, {}
                for sid in q.input_stream.all_stream_ids:
                    if sid not in positions:
                        raise CompileError(
                            f"pattern stream {sid!r} has no partition key")
                    ppos[sid] = positions[sid]
                    if sid in key_fns:
                        pfns[sid] = key_fns[sid]
                self._add_pattern_query(q, qname, key_capacity=keys_cap,
                                        slots=nfa_slots, positions=ppos,
                                        allocator=shared_allocator,
                                        key_fns=pfns or None,
                                        mesh=self.mesh)
            part_runtimes.append(self.query_runtimes[qname])
        # @purge(enable, interval='1 sec', idle.period='5 min') on the
        # partition or any of its queries (reference :3439-3456)
        for ann in all_anns:
            if ann.name.lower() == "purge":
                if str(ann.element("enable", "true")).lower() != "true":
                    break
                interval = _parse_time_ms(ann.element("interval", "1 sec")) \
                    or 1000
                idle = _parse_time_ms(ann.element("idle.period", "5 min")) \
                    or 300_000
                # the scheduler's queue holds it from tick to tick
                _PartitionPurger(self, shared_allocator, part_runtimes,
                                 interval, idle)
                break
        return qi

    def _range_key_fn(self, sid: str, schema: ev.Schema,
                      pt: RangePartitionType) -> Callable:
        """A range partition's key function (reference
        `siddhi_tpu/core/runtime.py:3262-3283`; RangePartitionExecutor):
        staged batch -> ([each row's label id], mask of the rows that
        match a range), the label the interned name of the first range
        whose condition holds.  The conditions run on the host, where the
        slots are resolved."""
        from .executor import Scope, compile_expression
        cpu = torch.device("cpu")
        scope = Scope(cpu)
        scope.interner = self.interner
        scope.add_source(sid, schema)
        conds = []
        for rp in pt.ranges:
            c = compile_expression(rp.condition, scope)
            if c.type != "BOOL":
                raise CompileError(
                    "range partition conditions must be boolean")
            conds.append((self.interner.intern(rp.partition_key), c))

        def fn(staged: ev.StagedBatch):
            ts = torch.from_numpy(np.ascontiguousarray(staged.ts))
            env = {sid: tuple(torch.from_numpy(np.ascontiguousarray(c))
                              for c in staged.cols),
                   "__ts__": ts, "__now__": ts,
                   "__kind__": torch.from_numpy(
                       np.ascontiguousarray(staged.kind))}
            n = staged.ts.shape[0]
            ids = np.full(n, -1, np.int32)
            for label, c in conds:
                m = np.broadcast_to(np.asarray(c.fn(env), np.bool_), (n,))
                ids = np.where((ids < 0) & m, np.int32(label), ids)
            return [ids], ids >= 0
        return fn

    def _attach_rate_limiter(self, q: Query, runtime) -> None:
        """`output [all|first|last] every ... | snapshot every t`
        (reference `_attach_rate_limiter`,
        `siddhi_tpu/core/runtime.py:2999`): the limiter receives the
        query's delivered pairs and forwards what is due.  A time or
        snapshot limiter's first tick is scheduled at `start()`."""
        from .ratelimit import create_rate_limiter
        runtime.rate_limiter = None
        if q.output_rate is None:
            return
        group_positions = None
        if q.selector.group_by_list:
            # positions of projected group-by attributes in the OUTPUT row;
            # qualified variables match by (stream, attribute)
            def _matches(oa_expr) -> bool:
                if not isinstance(oa_expr, Variable):
                    return False
                for v in q.selector.group_by_list:
                    if v.attribute_name != oa_expr.attribute_name:
                        continue
                    if v.stream_id is None or oa_expr.stream_id is None \
                            or v.stream_id == oa_expr.stream_id:
                        return True
                return False
            group_positions = [
                i for i, oa in enumerate(q.selector.selection_list)
                if _matches(oa.expression)] or None
            if group_positions is None and \
                    q.output_rate.behavior in ("FIRST", "LAST"):
                raise CompileError(
                    f"output {q.output_rate.behavior.lower()} with group "
                    f"by requires projecting the group-by attribute(s) in "
                    f"the select clause")
        lim = create_rate_limiter(
            q.output_rate,
            lambda pairs, now, _rt=runtime: _deliver_pairs(_rt, pairs, now),
            group_positions)
        runtime.rate_limiter = lim
        if lim is not None and lim.needs_timer:
            lim.name = f"{runtime.name} (output rate)"
            lim._schedule = lambda ts, _l=lim: \
                self._scheduler.notify_at(ts, _l)
            self._timed_limiters.append(lim)

    def _add_partitioned_query(self, q: Query, name: str, positions,
                               keys_cap: int, win_cap: int,
                               allocator: SlotAllocator,
                               key_fns=None) -> None:
        """A single-stream query inside a partition (reference
        `_add_partition`, `siddhi_tpu/core/runtime.py:3398-3438`): the
        partition key (a value partition's attribute, a range partition's
        label) joins the group key, and a window is kept per key (`kstep`,
        kernel K11) with the partition's allocator as the window-key
        allocator.  An inner stream (`#S`) carries no key."""
        _check_annotations(q.annotations, f"query {name!r}")
        ist = q.input_stream
        sid = ist.unique_stream_id
        ppos = positions.get(sid)
        if ppos is None and not ist.is_inner_stream:
            raise CompileError(f"stream {sid!r} has no partition key")
        has_window = any(isinstance(h, Window) for h in ist.stream_handlers)
        planned = plan_single_query(
            q, name, self.schemas, self.interner,
            group_slots=max(keys_cap, 4096),
            # keyed windows see per-key E-row batches, so their window
            # shapes key off a small batch capacity
            batch_capacity=64 if has_window else 512,
            window_capacity_hint=win_cap, device=self.device,
            partition_positions=ppos, window_key_allocator=allocator,
            key_capacity=keys_cap, in_cols=self._in_cols(q, name),
            partition_key_fn=(key_fns or {}).get(sid), mesh=self.mesh)
        runtime = QueryRuntime(planned, self)
        self.query_runtimes[name] = runtime
        self._wire_dispatch(runtime, q, "plain")
        self.junctions[sid].subscribe_query(_QSub(runtime))
        # the reference wires a partitioned query's limiter and output
        # stream only (no table op)
        self._attach_rate_limiter(q, runtime)
        self._define_output_for(planned, name)

    def _add_partitioned_join(self, q: Query, name: str, positions,
                              key_fns=None) -> None:
        """A join inside a value partition (reference
        `siddhi_tpu/core/runtime.py:3360-3397`): a plain join whose `on`
        also requires equal partition keys on both sides.  Its windows are
        shared by the keys, as in the reference.  A range-partitioned join
        raises, as in the reference."""
        jis = q.input_stream
        if key_fns and (jis.left_input_stream.unique_stream_id in key_fns or
                        jis.right_input_stream.unique_stream_id in key_fns):
            raise CompileError("range-partitioned joins are not supported")
        sides = []
        for sis in (jis.left_input_stream, jis.right_input_stream):
            ssid = sis.unique_stream_id
            if ssid in self.tables or ssid in self.named_windows or \
                    ssid in self.aggregations:
                continue        # shared collections: no key column
            pos = positions.get(ssid)
            if not pos:
                raise CompileError(f"stream {ssid!r} has no partition key")
            sides.append(Expression.variable(
                self.schemas[ssid].names[pos[0]]).of_stream(
                    sis.stream_reference_id or ssid))
        if len(sides) == 2:
            eq = Expression.compare(sides[0], "==", sides[1])
            jis.on_compare = Expression.and_(jis.on_compare, eq) \
                if jis.on_compare is not None else eq
        self._add_join_query(q, name)

    def _wire_output(self, runtime, q: Query, planned, name: str) -> None:
        """Route a query's output: its rate limiter, then a table op when
        the target is a table (reference `_wire_output`,
        `siddhi_tpu/core/runtime.py:3049`), else the output stream (defined
        if missing)."""
        from ..query_api.expression import Variable as V
        from ..query_api.query import (DeleteStream, UpdateOrInsertStream,
                                       UpdateStream)
        from .executor import Scope, compile_expression
        self._attach_rate_limiter(q, runtime)
        runtime.table_op = None
        tgt = planned.output_target
        out_stream = q.output_stream
        if not tgt or tgt not in self.tables:
            self._define_output_for(planned, name)
            return
        table = self.tables[tgt]
        out_key = "__out__"
        scope_schema = planned.out_schema
        if not isinstance(out_stream, (DeleteStream, UpdateStream,
                                       UpdateOrInsertStream)):
            if len(table.schema.names) != len(scope_schema.names):
                raise CompileError(
                    f"query {name!r} output arity does not match table "
                    f"{tgt!r}")
            runtime.table_op = ("insert", table, None, [], out_key)
            return
        cond_expr = (out_stream.on_delete_expression
                     if isinstance(out_stream, DeleteStream)
                     else out_stream.on_update_expression)
        scope = Scope(self.device)
        scope.interner = self.interner
        scope.add_source(out_key, scope_schema)
        # table attributes must be qualified (T.attr); unqualified names
        # resolve to the query's output, as in the reference
        scope.add_source(tgt, table.schema, default=False)
        cond = table.plan_condition(cond_expr, scope, other_key=out_key)
        set_fns = []
        us = getattr(out_stream, "update_set", None)
        if us is None and not isinstance(out_stream, DeleteStream):
            # default set: overwrite all same-named columns
            for n in table.schema.names:
                if n in scope_schema.names:
                    e = compile_expression(V(n, stream_id=out_key), scope)
                    set_fns.append((table.schema.position(n), e.fn))
        elif us is not None:
            for sa in us.set_attribute_list:
                pos = table.schema.position(sa.table_variable.attribute_name)
                e = compile_expression(sa.value_expression, scope)
                set_fns.append((pos, e.fn))
        op = ("delete" if isinstance(out_stream, DeleteStream) else
              "upsert" if isinstance(out_stream, UpdateOrInsertStream)
              else "update")
        if op == "upsert":
            _check_upsert_arity(table, scope_schema, f"query {name!r}")
        runtime.table_op = (op, table, cond, set_fns, out_key)

    def _define_output_for(self, planned, name: str):
        tgt = planned.output_target
        if tgt and tgt in self.named_windows:
            if len(self.named_windows[tgt].schema.names) != len(
                    planned.out_schema.names):
                raise CompileError(
                    f"query {name!r} output arity does not match window "
                    f"{tgt!r}")
            return
        if tgt and tgt not in self.junctions:
            sdef = StreamDefinition(tgt)
            for a in planned.out_schema.definition.attribute_list:
                sdef.attribute(a.name, a.type)
            self.app.stream_definition_map[tgt] = sdef
            self._define_stream_runtime(sdef)
        elif tgt:
            tdef = self.app.stream_definition_map.get(tgt)
            if tdef is not None and len(tdef.attribute_list) != len(
                    planned.out_schema.names):
                raise CompileError(
                    f"query {name!r} output arity does not match stream "
                    f"{tgt!r}")

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if not self._started:
            # a timed limiter's first tick (reference :3509-3510)
            now = self.timestamp_millis()
            for tr in self.triggers.values():
                tr.start(now)
            for lim in self._timed_limiters:
                self._scheduler.notify_at(now + lim.interval, lim)
            # @async(buffer.size, workers, queue.policy) streams get an
            # ingress queue and workers; playback keeps synchronous
            # dispatch, event time must stay ordered (reference :3490-3502)
            if not self.playback:
                for sid, j in self.junctions.items():
                    sdef = self.app.stream_definition_map.get(sid)
                    ann = sdef.get_annotation("async") \
                        if sdef is not None else None
                    if ann is not None:
                        j.enable_async(
                            int(ann.element("buffer.size", 256) or 256),
                            int(ann.element("workers", 1) or 1),
                            str(ann.element("queue.policy", "block")
                                or "block").lower())
        self._started = True
        self._scheduler.start()
        if self.playback and self._playback_idle_ms and \
                self._idle_thread is None:
            self._playback_last_wall = current_millis()
            self._idle_stop = threading.Event()
            self._idle_thread = threading.Thread(
                target=self._run_playback_idle, daemon=True,
                name="siddhi-torch-playback-idle")
            self._idle_thread.start()
        if self._stats_reporter is not None:
            self._stats_reporter.start()

    def _run_playback_idle(self) -> None:
        """Quiet-input clock advance for @app:playback(idle.time,
        increment): every idle.time of wall clock without a send, the
        event clock moves on by increment and the timers it passes fire."""
        idle_s = self._playback_idle_ms / 1000.0
        stop = self._idle_stop
        while not stop.wait(idle_s):
            if current_millis() - self._playback_last_wall \
                    < self._playback_idle_ms:
                continue
            with self._lock:
                if stop.is_set():
                    return
                self._playback_time += self._playback_increment_ms
                self._scheduler.drain_playback(self._playback_time)

    def shutdown(self) -> None:
        if self._idle_stop is not None:
            # under the app lock: once it is set, no advance runs again
            with self._lock:
                self._idle_stop.set()
            if self._idle_thread is not None:
                self._idle_thread.join(timeout=2.0)
            self._idle_thread = None
        # accepted sends, held @fuse stacks and @pipeline emissions, the
        # serving rings and the @async drainer deliver before teardown
        # (reference :3535-3560)
        for j in self.junctions.values():
            j.stop_async()
        from . import fusion
        for qr in self._step_runtimes():
            fusion.drain(qr)
            _drain_pending_emit(qr)
        self._serve_drainer.stop()
        self._drainer.stop()
        self._scheduler.stop()
        self.flush()
        if self._stats_reporter is not None:
            self._stats_reporter.stop()
        self._started = False

    def _step_runtimes(self):
        """Every runtime that can hold a @fuse stack or deferred
        emissions: the per-query runtimes and the merge groups."""
        return list(self.query_runtimes.values()) + \
            list(getattr(self, "merged_groups", {}).values())

    def flush(self) -> None:
        """Deliver everything accepted: the @async ingress queues, the
        partial @fuse stacks, the held @pipeline emissions, the @async
        drainer and the serving rings, in that order, to a fixpoint (a
        delivery may feed another stream); then wait for the device
        (reference :3577-3600)."""
        from . import fusion
        for _ in range(64):
            for j in self.junctions.values():
                j.flush_async()
            for qr in self._step_runtimes():
                fusion.drain(qr)
                _drain_pending_emit(qr)
            self._drainer.flush()
            self._serve_drainer.drain_all()
            if all(j.pending_async() == 0
                   for j in self.junctions.values()) and \
                    not any(qr.__dict__.get("_pending_emit") or
                            fusion.pending(qr)
                            for qr in self._step_runtimes()) and \
                    self._serve_drainer.pending() == 0 and \
                    self._drainer.pending() == 0:
                break
        else:
            _log.warning("flush() gave up after 64 rounds with batches "
                         "still pending (sustained re-ingestion?)")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timestamp_millis(self) -> int:
        if self.playback:
            return self._playback_time
        return current_millis()

    # -- on-demand queries ----------------------------------------------------
    _ONDEMAND_CACHE_MAX = 50

    def query(self, q) -> List[ev.Event]:
        """Run a one-shot query against the tables' current contents
        (reference `SiddhiAppRuntime.query`, `siddhi_tpu/core/runtime.py
        :4040`).  A query string's parsed plan is kept in an LRU of at most
        50, so a repeated query re-plans nothing."""
        from ..query_api.query import OnDemandQuery
        from .ondemand import OnDemandPlanMemo, execute_on_demand
        memo = None
        if isinstance(q, str):
            with self._ondemand_lock:
                ent = self._ondemand_cache.get(q)
                if ent is not None:
                    self._ondemand_cache.move_to_end(q)
            if ent is None:
                from ..compiler import SiddhiCompiler
                ent = (SiddhiCompiler.parse_on_demand_query(q),
                       OnDemandPlanMemo())
                with self._ondemand_lock:
                    self._ondemand_cache[q] = ent
                    while len(self._ondemand_cache) > \
                            self._ONDEMAND_CACHE_MAX:
                        self._ondemand_cache.popitem(last=False)
            q, memo = ent
        if not isinstance(q, OnDemandQuery):
            raise TypeError("query() takes a query string or an "
                            "OnDemandQuery")
        # the reference quiesces first: batches held in @fuse stacks and
        # @pipeline deques reach the tables before the read
        from . import fusion
        for qr in self._step_runtimes():
            fusion.drain(qr)
            _drain_pending_emit(qr)
        with self._lock:
            return execute_on_demand(self, q, memo)

    # -- I/O ------------------------------------------------------------------
    def get_input_handler(self, stream_id: str) -> InputHandler:
        if stream_id not in self.junctions:
            raise DefinitionNotExistError(f"undefined stream {stream_id!r}")
        return InputHandler(stream_id, self)

    def add_batch_callback(self, query_name: str, cb) -> None:
        """Columnar query callback receiving (timestamp, payload) where the
        payload holds the counts and, on access, numpy rows."""
        if query_name not in self.query_runtimes:
            raise QueryNotExistError(f"no query named {query_name!r}")
        self.query_runtimes[query_name].batch_callbacks.append(cb)

    def add_callback(self, name: str, cb) -> None:
        """Stream or window name -> StreamCallback; query name ->
        QueryCallback."""
        if name in self.named_windows:
            self.named_windows[name].stream_callbacks.append(
                _wrap_stream_callback(cb))
        elif name in self.junctions and name not in self.query_runtimes:
            self.junctions[name].subscribe_callback(_wrap_stream_callback(cb))
        elif name in self.query_runtimes:
            self.query_runtimes[name].callbacks.append(
                _wrap_query_callback(cb))
        else:
            raise QueryNotExistError(f"no stream or query named {name!r}")

    def _advance_playback(self, max_ts: int) -> None:
        if self.playback:
            with self._lock:
                self._playback_time = max(self._playback_time, max_ts)
                self._playback_last_wall = current_millis()

    def _route_columns(self, stream_id: str, cols, timestamps) -> None:
        junction = self.junctions.get(stream_id)
        if junction is None:
            raise DefinitionNotExistError(f"undefined stream {stream_id!r}")
        n = len(cols[0])
        cap = ev.bucket_size(max(n, 1))
        schema = junction.schema
        if timestamps is None:
            ts = np.full((cap,), self.timestamp_millis(), np.int64)
        elif n == cap and isinstance(timestamps, np.ndarray) and \
                timestamps.dtype == np.int64 and timestamps.flags.c_contiguous:
            ts = timestamps          # full bucket: adopt the caller's buffer
        else:
            ts = np.zeros((cap,), np.int64)
            ts[:n] = timestamps
        valid = np.zeros((cap,), np.bool_)
        valid[:n] = True
        kind = np.zeros((cap,), np.int32)
        padded = []
        for c, t in zip(cols, schema.types):
            d = ev.np_dtype(t)
            if n == cap and isinstance(c, np.ndarray) and c.dtype == d \
                    and c.flags.c_contiguous:
                padded.append(c)
                continue
            a = np.zeros((cap,), d)
            a[:n] = c
            padded.append(a)
        staged = ev.StagedBatch(ts, kind, valid, padded, n)
        if n:
            self._advance_playback(int(ts[:n].max()))
        now = self.timestamp_millis()
        # the playback clock moves first and due timers fire before the
        # batch is dispatched
        if self.playback:
            with self._lock:
                self._scheduler.drain_playback(now)
        elif junction._async_q is not None:
            junction.enqueue("staged", staged, now)
            return
        junction.dispatch_staged(staged, now)

    def _route_staged(self, junction, staged: ev.StagedBatch,
                      max_ts: int) -> None:
        """A query's output rows staged into a stream (`_route_rows`), as
        `_route` routes its events: the playback clock moves to the rows'
        latest ts and due timers fire first; the stream callbacks receive
        the events, the subscribers the staged batch."""
        self._advance_playback(max_ts)
        now = self.timestamp_millis()
        if self.playback:
            with self._lock:
                self._scheduler.drain_playback(now)
        elif junction._async_q is not None:
            junction.enqueue("published", staged, now)
            return
        junction.publish_staged(staged, now)

    def _route_window(self, nw, staged: ev.StagedBatch,
                      max_ts: Optional[int]) -> None:
        """`insert into W` (reference :3815-3828): the playback clock
        moves to the rows' latest ts and due timers fire first."""
        if max_ts is not None:
            self._advance_playback(max_ts)
        now = self.timestamp_millis()
        if self.playback:
            with self._lock:
                self._scheduler.drain_playback(now)
        with nw._qlock:
            nw.process_staged(staged, now)

    def _route(self, stream_id: str, events: List[ev.Event]) -> None:
        nw = self.named_windows.get(stream_id)
        if nw is not None:
            self._route_window(nw, ev.pack_np(nw.schema, events),
                               max(e.timestamp for e in events)
                               if events else None)
            return
        junction = self.junctions.get(stream_id)
        if junction is None:
            raise DefinitionNotExistError(f"undefined stream {stream_id!r}")
        if events:
            self._advance_playback(max(e.timestamp for e in events))
        now = self.timestamp_millis()
        if self.playback:
            with self._lock:
                self._scheduler.drain_playback(now)
        elif junction._async_q is not None:
            junction.enqueue("events", events, now)
            return
        junction.publish(events, now)


    # -- statistics and observability (reference :3850-4024) ----------------
    def statistics(self) -> Dict:
        """Metric report (reference: SiddhiStatisticsManager)."""
        return self.stats.report(self)

    def buffered_emissions(self) -> int:
        """Emissions queued in the @async emission drainer."""
        try:
            return self._drainer.pending()
        except Exception:  # noqa: BLE001 — metrics must not throw
            return 0

    def buffered_ingress(self) -> Dict[str, int]:
        """Batches pending in @async ingress queues, per stream (only
        streams with a backlog)."""
        out: Dict[str, int] = {}
        for sid, j in list(self.junctions.items()):
            try:
                n = j.pending_async()
            except Exception:  # noqa: BLE001 — metrics must not throw
                n = 0
            if n > 0:
                out[sid] = n
        return out

    def queue_depths(self) -> Dict[str, int]:
        """@async ingress queue depth per stream running one."""
        return {sid: j.queue_depth() for sid, j in
                list(self.junctions.items()) if j._async_q is not None}

    def drainer_depth(self) -> int:
        """Emissions sitting in the @async drainer's queue."""
        try:
            return self._drainer._q.qsize()
        except Exception:  # noqa: BLE001 — metrics must not throw
            return 0

    def serve_rings(self) -> Dict[str, Any]:
        """{query: EmissionRing} of every runtime that opened a serving
        ring."""
        out: Dict[str, Any] = {}
        for qname, qr in list(self.query_runtimes.items()):
            ring = qr.__dict__.get("_serve_ring")
            if ring is not None:
                out[qname] = ring
        return out

    def ring_occupancies(self) -> Dict[str, int]:
        """Pending (appended, undrained) serving-ring entries per query."""
        return {q: r.occupancy() for q, r in self.serve_rings().items()}

    def serve_drainer_depth(self) -> int:
        """Ring entries awaiting the serving drainer across all rings."""
        try:
            return self._serve_drainer.pending()
        except Exception:  # noqa: BLE001 — metrics must not throw
            return 0

    def timeseries(self) -> Dict:
        """The manager's sampler's series for this app, its tenant
        account and SLO state (`observability/timeseries.py`; `enabled`
        is False until the sampler has ticked)."""
        store = self.__dict__.get("_timeseries")
        out: Dict = {"app": self.name, "enabled": store is not None,
                     "series": store.to_dict() if store is not None else {}}
        acct = self.__dict__.get("_tenant_account")
        if acct is not None:
            out["tenant"] = acct
        slo = self.__dict__.get("_slo_state")
        if slo is not None:
            out["slo"] = slo
        return out

    def trace_dump(self, query: Optional[str] = None,
                   limit: int = 64) -> List[Dict]:
        """Recent DETAIL-level batch traces, newest first, optionally only
        those that touched `query` (observability/tracing.py)."""
        return self.stats.tracer.dump(query, limit)

    def phase_report(self) -> Dict:
        """Per-query phase budget against the `<query>:e2e` histogram
        (observability/phases.py).  Host-side reads only."""
        from ..observability.phases import phase_report as _pr
        return _pr(self)

    def state_report(self) -> Dict:
        """State observatory report (observability/stateobs.py):
        occupancy, capacity and high-water of every sized structure, key
        hotness, near-capacity verdicts, the sizing ledger.  Host-side
        reads only."""
        from ..observability.stateobs import state_report as _sr
        return _sr(self)

    def state_memory(self) -> Dict:
        """{owner: {component: bytes}} of the app's device state, from
        tensor metadata (observability/memory.py)."""
        from ..observability.memory import component_bytes
        return component_bytes(self)

    def health(self) -> Dict:
        """Host-side health report for this app
        (observability/health.py)."""
        from ..observability.health import app_health
        return app_health(self)

    def set_statistics_level(self, level: str) -> None:
        self.stats.level = level.upper()


def _check_upsert_arity(table, out_schema, where: str) -> None:
    """An upsert inserts the rows that matched nothing as they are, so its
    output must have the table's attributes.  (The JAX package accepts a
    narrower output and its insert then zips the output's columns onto
    the table's, dropping the table's last columns.)"""
    if len(out_schema.names) != len(table.schema.names):
        raise CompileError(
            f"{where}: update or insert into {table.definition.id!r} needs "
            f"an output of the table's {len(table.schema.names)} "
            f"attributes, got {len(out_schema.names)}")


def _parse_time_ms(s) -> int:
    """'50 millisec' / '1 sec' / '250' -> milliseconds."""
    from ..compiler.parser import _TIME_UNITS
    s = str(s).strip().lower()
    parts = s.split()
    if len(parts) == 2 and parts[1] in _TIME_UNITS:
        return int(float(parts[0]) * _TIME_UNITS[parts[1]])
    if s.isdigit():
        return int(s)
    raise CompileError(f"cannot parse time value {s!r}")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an app runs on: CUDA unless the caller asks for the CPU.
    Without a CUDA device and without an explicit `device='cpu'` this
    raises; it never continues on the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "siddhi_tpu_torch runs on a CUDA device and none is "
                "available; pass SiddhiManager(device='cpu') to run on the "
                "CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SiddhiManager:
    """reference: CORE/SiddhiManager.java:49"""

    def __init__(self, device: Union[str, torch.device, None] = None):
        from ..utils.config import InMemoryConfigManager
        self.device = resolve_device(device)
        self.interner = ev.StringInterner()
        self.runtimes: Dict[str, SiddhiAppRuntime] = {}
        self.config_manager = InMemoryConfigManager()
        self._sampler = None

    def set_config_manager(self, config_manager) -> None:
        """reference: SiddhiManager.setConfigManager (`siddhi_tpu/core/
        runtime.py:4368`): system-wide properties such as
        `optimizer.merge.enabled` and `serving.*`."""
        self.config_manager = config_manager

    setConfigManager = set_config_manager

    def create_siddhi_app_runtime(
            self, app: Union[str, SiddhiApp],
            mesh=None) -> SiddhiAppRuntime:
        """`mesh` (a `sharding.ShardMesh`) deploys the app over its shards
        (reference `siddhi_tpu/core/runtime.py:4455-4469`)."""
        if isinstance(app, str):
            from ..compiler import SiddhiCompiler
            app = SiddhiCompiler.parse(app)
        runtime = SiddhiAppRuntime(app, self, mesh=mesh)
        self.runtimes[runtime.name] = runtime
        return runtime

    def start_sampler(self, interval_s=None, window=None, rules=None,
                      clock=None):
        """Start (or return) the manager's time-series sampler: a daemon
        thread snapshotting every app's host-side metrics each tick and
        evaluating the SLO rules (observability/timeseries.py,
        observability/slo.py; reference :4592-4616).  Idempotent; with a
        `clock`, drive `tick()` yourself."""
        if self._sampler is None:
            from ..observability.timeseries import TimeSeriesSampler
            self._sampler = TimeSeriesSampler(
                self, interval_s=interval_s, window=window, rules=rules,
                clock=clock)
            if clock is None:
                self._sampler.start()
        return self._sampler

    def stop_sampler(self) -> None:
        s, self._sampler = self._sampler, None
        if s is not None:
            s.stop()

    def shutdown(self) -> None:
        self.stop_sampler()
        for rt in self.runtimes.values():
            rt.shutdown()
