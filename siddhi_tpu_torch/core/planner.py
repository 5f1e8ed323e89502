"""Single-stream query planner (port of `siddhi_tpu/core/planner.py`):
query_api AST -> one step function

    step(state, batch, gslot, now, facts) -> (state', out, header)

over a staged micro-batch: the pre-window filters and the window
(`stage_body`: kernels K1-K3), then the post-window filters and the
selector (`select_body`: kernel K15 for the filters, K4 for
aggregations, torch ops for the projection and having).  `out` is (ts,
kind, valid, cols) with the valid rows in seq order; `header` is i64[4] =
[n_valid, n_current, wake, rows the window missed (a time window's short
expire bound, a timeBatch slice above its capacity)], the one scalar
block the runtime fetches per step.

Inside a value partition (`partition_positions`) the partition key is
prepended to the group-by key when the query aggregates or groups, and a
windowed query keeps one window per partition key: `kstep` (the
reference's `kstep`, `siddhi_tpu/core/planner.py:539-584`)

    kstep(state, batch, gslot, key_idx, sel, now) -> (state', out, header)

runs the pre-window filters and every key's window over the [K, C] slab
(kernel K11, `kernels/keyed_window.py`, for length, time, lengthBatch,
timeBatch and session; K20-K23, `kernels/keyed_ext.py`, for
externalTime, timeLength, delay, externalTimeBatch, batch, cron, sort and
hopping; K24, `kernels/keyed_freq.py`, for frequent and lossyFrequent;
K25 / K26, `kernels/expr_window.py`, for expression and
expressionBatch), then the selector over the rows, which come out
key-major.

A range partition gives no key positions but a key function
(`partition_key_fn`, host code): each row's key is the label of the first
range it matches.  Its window is kept per label, and its group key is the
label followed by the group-by attributes.

A `session(gap, key)` window is kept per value of its key attribute the
same way, outside a partition: the runtime gives it a key allocator of
`@capacity(keys)` keys.

distinctCount and unionSet resolve each (group slot, value) pair of the
batch to a pair slot on the host (`pair_allocs`, one allocator of 8K
slots per distinct argument); the step takes them as `pslots` and the
selector's refcount pass reads each output row's slot by its input index
(the pass-through window's index mode).

Ported: filters before and after the window, the `length`, `time`,
`lengthBatch`, `timeBatch`, `externalTime`, `externalTimeBatch`,
`timeLength`, `delay`, `batch`, `sort`, `cron`, `session`, `frequent`,
`lossyFrequent`, `hopping`, `expression` and `expressionBatch` windows
or none, keyed `length` / `time` / `lengthBatch` / `timeBatch` /
`session` (with or without allowed latency) / `externalTime` /
`timeLength` / `delay` / `externalTimeBatch` / `batch` / `cron` / `sort`
/ `hopping` / `frequent` / `lossyFrequent` / `expression` /
`expressionBatch` windows,
group by, having, the built-in aggregators with distinctCount and
unionSet on queries without a window, `x in Table` probes, and a named
window's rows as input (`named_window_input`: `PassAllWindow`, the
reference's :344-360).  Stream functions and distinctCount over a window
raise `CompileError` naming their ROADMAP item.  On CUDA a query
must also fit the kernels (`kernel_subset_violation`, and filters inside
the bytecode subset); one that does not raises NotImplementedError here,
at plan time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..query_api.definition import StreamDefinition
from ..query_api.query import (Filter, Query, SingleInputStream,
                               StreamFunction, Window)
from . import event as ev
from .executor import CompileError, Scope, compile_expression
from .keyslots import SlotAllocator
from .selector import SelectorExec
from ..sharding import ShardedState, on_device
from .window import NO_WAKEUP, NoWindow, PassAllWindow, Rows, \
    WindowProcessor, create_window


@dataclasses.dataclass
class PlannedQuery:
    """Compiled single-input query."""

    name: str
    input_stream_id: str
    in_schema: ev.Schema
    out_schema: ev.Schema
    output_target: str                 # target stream id ('' => return)
    output_event_type: str             # CURRENT_EVENTS/EXPIRED_EVENTS/ALL
    window: WindowProcessor
    group_by_positions: List[int]
    selector_exec: SelectorExec
    step: Callable
    init_state: Callable
    slot_allocator: Optional[SlotAllocator]
    batch_capacity: int
    needs_timer: bool
    device: torch.device
    filter_spec: Any = None            # kernels.filter_compact.FilterSpec
    post_spec: Any = None              # the filters after the window
    stage_body: Optional[Callable] = None
    select_body: Optional[Callable] = None
    # keyed windows (windows inside a partition)
    keyed_window: bool = False
    window_key_positions: List[int] = dataclasses.field(
        default_factory=list)
    window_key_allocator: Optional[SlotAllocator] = None
    key_capacity: int = 0
    kstep: Optional[Callable] = None
    timer_keys: Optional[Callable] = None
    in_deps: List[str] = dataclasses.field(default_factory=list)
    # range partitions: staged batch -> ([label ids], matched mask)
    partition_key_fn: Optional[Callable] = None
    # distinctCount / unionSet: (pair allocator, value position) each
    pair_allocs: List[Any] = dataclasses.field(default_factory=list)
    # the shard mesh of a windowless group-by split over it (slot s at
    # local slot s // n of shard s % n; purge resets remap through that
    # layout), and of a keyed window whose slab is split over it (key k at
    # local row k // n of shard k % n; the selector state replicated): the
    # JAX package's `mesh` / `keyed_mesh` (B10's shard steps)
    mesh: Any = None
    keyed_mesh: Any = None


def _env_for(scope_key: str, cols, ts, now, kind) -> Dict[str, Any]:
    return {scope_key: tuple(cols), "__ts__": ts, "__now__": now,
            "__kind__": kind}


def header_of(out, wake) -> torch.Tensor:
    """A plain step's header i64[4] = [n_valid, n_current, wake, missed]
    of its output rows and its window's wake (None: no timers)."""
    ots, okind, ovalid, _ = out
    cur = torch.logical_and(ovalid, okind == ev.CURRENT)
    if wake is None:
        wake = torch.tensor([NO_WAKEUP, 0], dtype=torch.int64,
                            device=ots.device)
    return torch.cat([torch.stack([ovalid.sum(), cur.sum()]), wake])


def kernel_subset_violation(in_schema: ev.Schema,
                            sel: Optional[SelectorExec] = None
                            ) -> Optional[str]:
    """Why a query cannot run on the CUDA kernels, or None.  The stream is
    checked first, before anything is compiled for the device; the
    selector once it is compiled."""
    from ..kernels import filter_compact, group_agg
    if len(in_schema.types) > filter_compact.MAX_COLS:
        return (f"{len(in_schema.types)} columns (the kernels take "
                f"{filter_compact.MAX_COLS})")
    if sel is not None and len(sel.bank.specs) > group_agg.MAX_SPECS:
        return (f"{len(sel.bank.specs)} accumulator columns (group_agg "
                f"takes {group_agg.MAX_SPECS})")
    return None


def _check_subset(name: str, in_schema: ev.Schema, sel=None) -> None:
    unsupported = kernel_subset_violation(in_schema, sel)
    if unsupported is not None:
        raise NotImplementedError(
            f"query {name!r} is outside the CUDA kernels' subset: "
            f"{unsupported}")


def plan_single_query(
        query: Query, name: str, schemas: Dict[str, ev.Schema], interner,
        batch_capacity: int = 512, group_slots: int = 4096,
        window_capacity_hint: int = 2048,
        device: Optional[torch.device] = None,
        partition_positions: Optional[List[int]] = None,
        window_key_allocator: Optional[SlotAllocator] = None,
        key_capacity: int = 0,
        in_cols: Optional[Dict[str, str]] = None,
        partition_key_fn: Optional[Callable] = None,
        named_window_input: bool = False, mesh=None) -> PlannedQuery:
    from ..kernels.filter_bytecode import AND, InKeys, compile_filter
    from ..kernels.in_probe import probe_env
    from ..kernels.filter_compact import FilterSpec
    from ..kernels.post_filter import post_filter
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    ist = query.input_stream
    if not isinstance(ist, SingleInputStream):
        raise CompileError(f"query {name!r} has no single input stream; "
                           f"joins plan through core/join.py "
                           f"plan_join_query")
    sid = ist.unique_stream_id
    if sid not in schemas:
        raise CompileError(f"undefined stream {sid!r}")
    in_schema = schemas[sid]
    if device.type == "cuda":
        _check_subset(name, in_schema)
    scope = Scope(device)
    scope.interner = interner
    scope.add_source(sid, in_schema, alias=ist.stream_reference_id)

    # ---- handlers: filters before/after the window -------------------------
    # on CUDA each filter also becomes bytecode for its kernel (K1 before
    # the window, K15 after it), checked before anything is built for the
    # device
    ik = InKeys(dict(in_cols or {}))
    bytecode, post_code = ([], []) if device.type == "cuda" else (None, None)
    pre_chain, post_chain = [], []
    # a query reading a named window passes its CURRENT and EXPIRED rows
    # on (reference :344-360)
    window_proc: WindowProcessor = (PassAllWindow if named_window_input
                                    else NoWindow)(in_schema, [],
                                                   batch_capacity)
    seen_window = False
    for h in ist.stream_handlers:
        if isinstance(h, Filter):
            code = post_code if seen_window else bytecode
            if code is not None:
                try:
                    words = compile_filter(h.expression, scope, sid, {},
                                           in_keys=ik)
                except CompileError as exc:
                    raise NotImplementedError(
                        f"query {name!r} is outside the CUDA kernels' "
                        f"subset: {exc}" + (" (a filter after the window, "
                                            "ROADMAP B10)" if seen_window
                                            else "")) from exc
                code += words + ([AND] if code else [])
            c = compile_expression(h.expression, scope)
            if c.type != "BOOL":
                raise CompileError("filter expression must be boolean")
            (post_chain if seen_window else pre_chain).append(c)
        elif isinstance(h, Window):
            if named_window_input:
                raise CompileError(
                    "cannot apply a window to a named-window input")
            if seen_window:
                raise CompileError("only one window per input stream")
            seen_window = True
            window_proc = create_window(
                (h.namespace + ":" if h.namespace else "") + h.name,
                in_schema, h.parameters, batch_capacity,
                capacity_hint=window_capacity_hint)
        elif isinstance(h, StreamFunction):
            raise CompileError(
                f"stream function {h.name!r} is not yet ported (ROADMAP A4)")

    # ---- selector -----------------------------------------------------------
    out_target = query.output_stream.target_id if query.output_stream \
        else ""
    sel = SelectorExec(query.selector, scope, in_schema, group_slots,
                       out_target or name)
    out_def = StreamDefinition(out_target or f"#{name}.out")
    for n, t in zip(sel.out_names, sel.out_types):
        out_def.attribute(n, t)
    out_schema = ev.Schema(out_def, interner)
    gpos = list(sel.group_by_positions)
    # inside a partition the partition key is prepended to the group key
    # (reference :413-445); a range partition's label leads the group key
    # through the key function instead
    keyed_window = bool((partition_positions or partition_key_fn)
                        and seen_window)
    window_key_positions = list(partition_positions or [])
    skey_pos = getattr(window_proc, "session_key_pos", None)
    if skey_pos is not None:
        # session(gap, key): the session key scopes the window as a
        # partition key would (reference :416-436)
        if partition_positions or partition_key_fn:
            raise CompileError(
                "session(gap, key) inside `partition with` is redundant: "
                "the partition key already scopes the session window")
        keyed_window = True
        window_key_positions = [skey_pos]
    if keyed_window and (window_key_allocator is None or key_capacity <= 0):
        raise CompileError("windows inside partitions (and session(gap, "
                           "key) queries) need a key allocator")
    if partition_positions and (sel.has_aggregation or gpos):
        extra = [g for g in gpos if g not in partition_positions]
        gpos = [q for q in partition_positions if q not in gpos] + gpos
        # keyed rows come out key-major and each group slot belongs to one
        # key when the group key is the partition key alone, so every
        # (slot, epoch) segment is one run of rows: group_agg's run mode
        sel.bank.runs = keyed_window and not extra
    needs_alloc = bool(gpos) or (partition_key_fn is not None and
                                 sel.has_aggregation)
    if partition_key_fn is not None:
        sel.bank.runs = keyed_window and not gpos
    allocator = SlotAllocator(group_slots, name=f"{name}:groupby") \
        if needs_alloc else None

    # distinctCount pair slots: (group, value) -> refcount slot (reference
    # :447-461)
    pair_allocs = []
    if sel.bank.pair_sources:
        if seen_window:
            raise CompileError(
                "distinctCount over windowed queries lands in a later "
                "phase (expired-row pair slots need buffer plumbing; "
                "ROADMAP B14)")
        for j, v in enumerate(sel.bank.pair_sources):
            _, pos, _ = scope.resolve(v)
            pair_allocs.append((SlotAllocator(
                sel.bank.K * 8, name=f"{name}:distinct{j}"), pos))
        # the selector finds each row's pair slot by its input index
        window_proc.index_seq = True
    out_event_type = (query.output_stream.output_event_type
                      if query.output_stream and
                      query.output_stream.output_event_type
                      else "CURRENT_EVENTS")

    # `x in Table` probes (reference: the dependency scan, :319-323); each
    # step's env gets one probe per table (`_probe_env`, :471-480)
    in_deps = list(in_cols or {})
    if device.type == "cuda":
        _check_subset(name, in_schema, sel)
    fspec = FilterSpec(in_schema.types, pre_chain, bytecode, sid, ik.keys)
    post_spec = FilterSpec(in_schema.types, post_chain, post_code, sid,
                           ik.keys) if post_chain else None
    wproc = window_proc

    def stage_body(wstate, batch, gslot, now: int, facts, in_tabs=None,
                   pre=None):
        """Pre-window filters + window advance.  `pre` (a `Prefiltered`
        spec) carries the batch's rows K29 already filtered."""
        rows = Rows(ts=batch.ts, kind=batch.kind, valid=batch.valid,
                    seq=None, gslot=gslot, cols=batch.cols)
        wstate, wout = wproc.process(
            wstate, rows, fspec.bind(in_tabs) if pre is None else pre, now,
            facts)
        return wstate, wout.rows, wout.next_wakeup

    def select_body(astate, orows: Rows, now: int, in_tabs=None,
                    pslots=()):
        """Post-window filters (K15) + selector over the window's rows.
        `pslots` are the batch's pair slots per distinct argument, by
        input row; the rows' seq is their input index."""
        env = _env_for(sid, orows.cols, orows.ts, now, orows.kind)
        env.update(probe_env(in_tabs or {}))
        for j, ps in enumerate(pslots):
            env[f"__pslot__{j}"] = ps[orows.seq]
        if post_spec is not None:
            orows = orows._replace(valid=post_filter(
                post_spec.bind(in_tabs), orows, now))
        return sel.process(astate, orows, env)

    def step(state, batch, gslot, now: int, facts, in_tabs=None,
             pslots=(), pre=None):
        wstate, astate = state
        wstate, orows, wake = stage_body(wstate, batch, gslot, now, facts,
                                         in_tabs, pre)
        astate, out = select_body(astate, orows, now, in_tabs, pslots)
        return (wstate, astate), out, header_of(out, wake)

    def init_state():
        return (wproc.init_state(device), sel.init_state())

    kstep = timer_keys = None
    if keyed_window:
        from ..kernels.keyed_window import KeyedSlab
        mode, C, wkw, key_init = _keyed_shape(wproc, name)
        from ..kernels.keyed_freq import FreqParams
        wstep = _keyed_step(wkw)
        prm = wkw.get("prm")
        nkeys = len(prm.key_pos) if isinstance(prm, FreqParams) else 0
        K = key_capacity
        types = in_schema.types

        def kstep(state, batch, gslot, key_idx, sel_idx, now: int,
                  tick: bool = False, in_tabs=None):
            slab, astate = state
            orows, wake = wstep(
                slab, fspec.bind(in_tabs), batch.ts, batch.kind, batch.valid,
                gslot, batch.cols, key_idx, sel_idx, now, tick=tick, **wkw)
            astate, (ots, okind, ovalid, ocols) = select_body(astate, orows,
                                                              now, in_tabs)
            cur = torch.logical_and(ovalid, okind == ev.CURRENT)
            # wake = [least wake, rows a timeBatch slice could not hold]
            header = torch.cat([torch.stack([ovalid.sum(), cur.sum()]), wake])
            return (slab, astate), (ots, okind, ovalid, ocols), header

        def init_state():                              # noqa: F811
            return (KeyedSlab.empty(mode, types, K, C, device, key_init,
                                    nkeys), sel.init_state())

        tk = []

        def timer_keys():
            """The timer tick's [K] key rows and [K, 1] selection: every
            key sees the TIMER row (row 0)."""
            if not tk:
                tk.extend([torch.arange(K, dtype=torch.int32, device=device),
                           torch.zeros((K, 1), dtype=torch.int32,
                                       device=device)])
            return tk

    plain_mesh = keyed_mesh = None
    if keyed_window:
        n = mesh.n if mesh is not None else 0
        kshardable = (
            mesh is not None and n > 1 and K % n == 0 and not pair_allocs
            and not sel._order_by and query.selector.limit is None
            and query.selector.offset is None
            and not getattr(wproc, "host_scheduled", False)
            # a RESET-emitting batch window resets every selector slot on
            # a shard that sees the flush: many writers a slot break the
            # replicated state's delta merge, so it stays unsharded
            and not wproc.emits_reset)
        if kshardable:
            keyed_mesh = mesh
            kstep = ShardedKeyedStep(wstep, wkw, fspec, select_body, mesh, K)
            unsharded_kinit = init_state

            def init_state():                          # noqa: F811
                slab, astate = unsharded_kinit()
                return ShardedState(
                    (_shard_slab(slab, d, n, dev), on_device(astate, dev))
                    for d, dev in enumerate(mesh.devices))
    else:
        shardable = (
            mesh is not None and allocator is not None
            and isinstance(wproc, NoWindow) and not pair_allocs
            and not sel._order_by and query.selector.limit is None
            and query.selector.offset is None
            and allocator.capacity % mesh.n == 0)
        if shardable:
            plain_mesh = mesh
            # the rows stay aligned to the input, so the shards' outputs
            # merge row by row in the unsharded delivery order
            wproc.compact = False
            step = ShardedPlainStep(step, mesh)
            blk = allocator.capacity // mesh.n

            def init_state():                          # noqa: F811
                return ShardedState(
                    (wproc.init_state(dev),
                     tuple(torch.full((blk,), s.init, dtype=s.dtype,
                                      device=dev) for s in sel.bank.specs))
                    for dev in mesh.devices)

    return PlannedQuery(
        name=name, input_stream_id=sid, in_schema=in_schema,
        out_schema=out_schema, output_target=out_target,
        output_event_type=out_event_type, window=wproc,
        group_by_positions=gpos, selector_exec=sel, step=step,
        init_state=init_state, slot_allocator=allocator,
        batch_capacity=batch_capacity, needs_timer=wproc.needs_timer,
        device=device, filter_spec=fspec, post_spec=post_spec,
        stage_body=stage_body, select_body=select_body,
        keyed_window=keyed_window,
        window_key_positions=window_key_positions,
        window_key_allocator=window_key_allocator,
        key_capacity=key_capacity, kstep=kstep, timer_keys=timer_keys,
        in_deps=in_deps, partition_key_fn=partition_key_fn,
        pair_allocs=pair_allocs, mesh=plain_mesh, keyed_mesh=keyed_mesh)


# ---------------------------------------------------------------------------
# B10's shard steps: a windowless group-by and a keyed window on a mesh
# ---------------------------------------------------------------------------

def _shard_slab(slab, d: int, n: int, dev):
    """Shard d's block of a keyed slab: the key rows k % n == d, in order
    (global state rows [d * K / n, (d + 1) * K / n) of the JAX layout)."""
    return slab.take_rows(torch.arange(d, slab.K, n, device=slab.ts.device),
                          dev)


def _batch_on(batch, dev, valid=None):
    return ev.EventBatch(batch.ts.to(dev), batch.kind.to(dev),
                         (batch.valid if valid is None else valid).to(dev),
                         tuple(c.to(dev) for c in batch.cols))


class ShardedPlainStep:
    """A windowless partitioned group-by on a mesh (JAX `_shard_plain_step`,
    `siddhi_tpu/core/planner.py:151`): each shard holds a G / n block of
    every selector slab; kernel K31 gives each shard the rows whose slot
    it owns (`lvalid`) at their local slots; every shard runs the plan's
    step (K1 in its row-aligned mode, K15, K4) on the whole batch; kernel
    K32 merges the rows row by row, the headers, and the NoWindow seq
    counter (old + the sum of the shards' changes)."""

    def __init__(self, step, mesh):
        self.step = step
        self.mesh = mesh

    def __call__(self, state, batch, gslot, now: int, facts, in_tabs=None,
                 pslots=(), pre=None):
        from ..kernels.shard_merge import (merge_delta, merge_header,
                                           merge_rows)
        from ..kernels.shard_route import route_plain
        mesh = self.mesh
        lvalid, local = route_plain(gslot, batch.valid, mesh.n)
        old_w = state[0][0].clone()
        states, outs, hdrs = [], [], []
        for d, dev in enumerate(mesh.devices):
            st, out, hdr = self.step(
                state[d], _batch_on(batch, dev, lvalid[d]), local[d].to(dev),
                now, facts, in_tabs=in_tabs)
            states.append(st)
            outs.append(out)
            hdrs.append(hdr)
        seq = merge_delta(old_w, [st[0] for st in states], masked=False)
        B = batch.ts.shape[0]
        (ots, okind, *ocols), ovalid = merge_rows(
            [(o[0], o[1]) + tuple(o[3]) for o in outs],
            [o[2] for o in outs], B)
        header = merge_header(hdrs, min_words=(2,))
        return (ShardedState((seq.to(dev).clone(), st[1]) for st, dev
                                  in zip(states, mesh.devices)),
                (ots, okind, ovalid, tuple(ocols)), header)


class ShardedKeyedStep:
    """A keyed window on a mesh (JAX `_shard_keyed_step`,
    `siddhi_tpu/core/planner.py:223`): each shard holds the K / n window
    key rows k % n == d and a replica of the selector state; kernel K31
    gives each shard its local rows of the keys it owns (the others and
    the padding rows drop); every shard runs the plan's keyed window step
    over the whole [Kb, E] grouping and the selector over its rows; K31's
    place mode and K32 merge the shards' key-major rows in key-row order,
    the headers, and the selector state (`dmerge`: old + the sum of the
    shards' changes, each element changed on one shard), which every
    replica then holds.  Where dmerge is undefined, a changed element
    whose old value is +-inf (a min / max accumulator's identity), the
    element takes the changed copy: the JAX package turns it into NaN, so
    its meshed min / max come out null after a key's first step, where
    the unsharded run gives the extreme (a reference defect the port does
    not copy)."""

    def __init__(self, wstep, wkw, fspec, select_body, mesh, K: int):
        self.wstep = wstep
        self.wkw = wkw
        self.fspec = fspec
        self.select_body = select_body
        self.mesh = mesh
        self.K = K

    def __call__(self, state, batch, gslot, key_idx, sel_idx, now: int,
                 tick: bool = False, in_tabs=None):
        from ..kernels.keyed_window import recording_key_counts
        from ..kernels.shard_merge import (merge_delta, merge_header,
                                           merge_rows)
        from ..kernels.shard_route import place, route_keyed
        mesh = self.mesh
        key_l = route_keyed(key_idx, mesh.n, self.K)
        old_a = tuple(x.clone() for x in state[0][1])
        spec = self.fspec.bind(in_tabs)
        slabs, astates, outs, hdrs, counts = [], [], [], [], []
        for d, dev in enumerate(mesh.devices):
            slab, astate = state[d]
            b = _batch_on(batch, dev)
            with recording_key_counts() as rec:
                orows, wake = self.wstep(
                    slab, spec, b.ts, b.kind, b.valid, gslot.to(dev), b.cols,
                    key_l[d].to(dev), sel_idx.to(dev), now, tick=tick,
                    **self.wkw)
            astate, out = self.select_body(astate, orows, now, in_tabs)
            ots, okind, ovalid, _ = out
            cur = torch.logical_and(ovalid, okind == ev.CURRENT)
            hdrs.append(torch.cat([torch.stack([ovalid.sum(), cur.sum()]),
                                   wake]))
            slabs.append(slab)
            astates.append(astate)
            outs.append(out)
            counts.append(rec[-1].to(mesh.first))
        sizes = [o[0].shape[0] for o in outs]
        N = sum(sizes)
        pos = list(torch.split(place(torch.stack(counts), N), sizes))
        (ots, okind, *ocols), ovalid = merge_rows(
            [(o[0], o[1]) + tuple(o[3]) for o in outs],
            [o[2] for o in outs], N, pos=pos)
        # dmerge, except that a changed min / max identity (+-inf) takes
        # the changed copy where the JAX package's old + delta is NaN
        merged = tuple(merge_delta(old, [a[i] for a in astates],
                                   finite_old=True)
                       for i, old in enumerate(old_a))
        header = merge_header(hdrs, min_words=(2,))
        return (ShardedState(
            (slab, tuple(m.to(dev).clone() for m in merged))
            for slab, dev in zip(slabs, mesh.devices)),
            (ots, okind, ovalid, tuple(ocols)), header)


def _keyed_step(wkw):
    """The keyed window step of a window's step arguments: K11's, or the
    family of its parameters' type (K20-K23, K24, K25 / K26)."""
    from ..kernels.expr_window import ExprParams, expr_window_step
    from ..kernels.keyed_ext import keyed_ext_step
    from ..kernels.keyed_freq import FreqParams, keyed_freq_step
    from ..kernels.keyed_window import keyed_window_step
    prm = wkw.get("prm")
    if prm is None:
        return keyed_window_step
    if isinstance(prm, FreqParams):
        return keyed_freq_step
    if isinstance(prm, ExprParams):
        return expr_window_step
    return keyed_ext_step


def _keyed_shape(wproc, name: str):
    """(slab mode, per-key capacity, the keyword arguments of its step,
    the per-key state's initial values) of a window kept per partition
    key (or per session key): K11's windows take their time `t` (the
    session gap) and session latency `lat`, K20-K23's an `ExtParams`,
    K24's a `FreqParams`, K25 / K26's an `ExprParams`.  A key holds the
    window's capacity: max(@capacity(window), 2 * batch capacity) rows
    for timeBatch, session, externalTime, externalTimeBatch, delay, cron
    and hopping, `length` rows for length, lengthBatch, timeLength and
    sort, the batch capacity for `batch()` (grown to the widest key row
    of a step), n counters for frequent and lossyFrequent and
    @capacity(window) rows for expression and expressionBatch, as the
    reference builds them."""
    from ..kernels import keyed_window as kw
    from ..kernels.keyed_ext import ExtParams
    from ..kernels.keyed_freq import FreqParams
    from .window_expr import ExpressionWindow
    from .window_ext import FrequentWindow
    from .window import (LengthBatchWindow, LengthWindow, TimeBatchWindow,
                         TimeWindow)
    from .window_ext import (ChunkBatchWindow, CronWindow, DelayWindow,
                             ExternalTimeBatchWindow, ExternalTimeWindow,
                             HoppingWindow, SessionLatencyWindow,
                             SessionWindow, SortWindow, TimeLengthWindow)
    if isinstance(wproc, SessionLatencyWindow):
        return kw.MODE_LATENCY, wproc.capacity, dict(
            t=wproc.gap_ms, lat=wproc.latency_ms), None
    k11 = {SessionWindow: (kw.MODE_SESSION, "capacity", "gap_ms"),
           LengthWindow: (kw.MODE_LENGTH, "length", None),
           TimeWindow: (kw.MODE_TIME, "capacity", "time_ms"),
           LengthBatchWindow: (kw.MODE_BATCH, "length", None),
           TimeBatchWindow: (kw.MODE_TBATCH, "capacity", "time_ms")}
    for cls, (mode, cap, t) in k11.items():
        if isinstance(wproc, cls):
            return mode, getattr(wproc, cap), dict(
                t=getattr(wproc, t) if t else 0, lat=0), None
    if isinstance(wproc, ExternalTimeWindow):
        return kw.MODE_EXT, wproc.capacity, dict(prm=ExtParams(
            t=wproc.time_ms, ts_pos=wproc.ts_pos)), None
    if isinstance(wproc, TimeLengthWindow):
        return kw.MODE_TLEN, wproc.capacity, dict(prm=ExtParams(
            t=wproc.time_ms, length=wproc.length)), None
    if isinstance(wproc, DelayWindow):
        return kw.MODE_DELAY, wproc.capacity, dict(prm=ExtParams(
            t=wproc.time_ms)), None
    if isinstance(wproc, ExternalTimeBatchWindow):
        return kw.MODE_XBATCH, wproc.capacity, dict(prm=ExtParams(
            t=wproc.time_ms, ts_pos=wproc.ts_pos)), {"start": wproc.start}
    if isinstance(wproc, ChunkBatchWindow):
        return kw.MODE_CHUNK, wproc.capacity, dict(prm=ExtParams()), None
    if isinstance(wproc, CronWindow):
        return kw.MODE_CRON, wproc.capacity, dict(prm=ExtParams()), None
    if isinstance(wproc, SortWindow):
        return kw.MODE_SORT, wproc.capacity, dict(prm=ExtParams(
            length=wproc.length, key_pos=wproc.key_pos,
            desc=wproc.descending)), None
    if isinstance(wproc, HoppingWindow):
        return kw.MODE_HOP, wproc.capacity, dict(prm=ExtParams(
            win=wproc.win_ms, hop=wproc.hop_ms)), None
    if isinstance(wproc, FrequentWindow):
        return kw.MODE_FREQ, wproc.n, dict(prm=FreqParams(
            n=wproc.n, key_pos=tuple(wproc.key_positions))), None
    if isinstance(wproc, ExpressionWindow):
        prm = wproc.params()
        return (kw.MODE_EXPRB if prm.batch else kw.MODE_EXPR,
                wproc.capacity, dict(prm=prm), None)
    raise CompileError(f"query {name!r}: the keyed form of a "
                       f"{wproc.name!r} window is not yet ported (ROADMAP "
                       f"B12)")
