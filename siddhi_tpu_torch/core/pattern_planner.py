"""Planner for pattern queries (PyTorch port of
`siddhi_tpu/core/pattern_planner.py`).

Each pattern query compiles to one step per input stream.  The host groups
incoming events by partition key into a [Kb, E] selection, and the step does
the sequential-per-key NFA advance over the packed state blobs.

A non-partitioned simple chain (`core/pattern_block.py`
`block_eligible`) runs the block NFA, every other plan the per-key scan
step.  On a CUDA device the block step is kernel K8
(`kernels/block_nfa.py`) and the scan step the `pattern_step` kernel
(`kernels/pattern_step.py`: its flagship mode or its general mode); a plan
past one of the kernel's stated limits raises at plan time, naming it.  On
the CPU the steps are the plain PyTorch functions (`make_block_step`, and
`make_step` below), which are also the kernels' references.  A plan with
absent atoms also gets a timer step (`tstep`): one tick with no event over
the whole slab at `now`, which fires the absent deadlines that have
passed.

On a mesh (`mesh`, a `sharding.ShardMesh`; B8, the JAX package's
`_shard_step` / `_shard_fused_step`) a partitioned plan keeps one packed
state per shard, `ShardedState`: shard d holds the key rows of the
slots `s % n == d` at local row `s // n`, its own selector slabs and its
own replica of the scalar counters.  `ShardedStep` runs the plan's gather
step once per shard on the shard's [Kb, E] block (`ShardRouter.group`),
then kernel K32 (`kernels/shard_merge.py`) sums the headers, takes the
least wake and re-replicates the scalars (old + the sum of the shards'
changes).  The rows stay per shard, concatenated shard by shard: the JAX
package's `P('shard')` order.  `ShardedTimer` runs the timer step once per
shard and interleaves the rows as the JAX package's timer over the whole
[W, C] slab (state-row order) gives them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..query_api.definition import StreamDefinition
from ..query_api.expression import Variable, walk
from ..query_api.query import Query, StateInputStream
from . import event as ev
from .executor import CompileError
from .pattern import PatternExec, PatternSpec, PatternState, last_filled, \
    linearize, oh_take
from .pattern_block import block_eligible, make_block_step
from .selector import SelectorExec
from ..sharding import ShardedState, on_device
from .window import NO_WAKEUP, UNCAPPED_SENTINEL, Rows

# test hook: force the scan path even for block-eligible specs (tests
# compare the two implementations on the same input)
_FORCE_SCAN = False


def state_leaves(st: PatternState) -> List[torch.Tensor]:
    """PatternState leaves in the reference's pytree order: the named fields
    in order, then the captures by sorted key, each as (ts, *cols)."""
    out = [st.active, st.pos, st.count, st.lmask, st.start_ts, st.entry_ts,
           st.seed_on, st.done, st.dropped]
    for ck in sorted(st.caps):
        ts, cols = st.caps[ck]
        out.append(ts)
        out.extend(cols)
    return out


class StatePacker:
    """Pack the per-key state into two blobs, one int32 (int32, float32
    bit-cast and bool leaves) and one int64, stored [W, K] with the key axis
    MINOR, plus the scalar leaves.  The row layout is the reference's, so a
    state blob moves between the two packages unchanged."""

    def __init__(self, example: PatternState):
        self._caps_layout = [(ck, len(example.caps[ck][1]))
                             for ck in sorted(example.caps)]
        self.recs = []   # (kind, dtype, head shape, offset, width)
        self.w32 = 0
        self.w64 = 0
        self.n_scalars = 0
        for leaf in state_leaves(example):
            if leaf.dim() == 0:
                self.recs.append(("scalar", leaf.dtype, (), self.n_scalars, 0))
                self.n_scalars += 1
                continue
            head = tuple(leaf.shape[:-1])
            width = 1
            for d in head:
                width *= d
            if leaf.dtype == torch.int64:
                self.recs.append(("i64", leaf.dtype, head, self.w64, width))
                self.w64 += width
            else:
                self.recs.append(("i32", leaf.dtype, head, self.w32, width))
                self.w32 += width

    def pack(self, state: PatternState):
        parts32, parts64, scal = [], [], []
        K = state.active.shape[-1]
        for leaf, (kind, dtype, head, off, width) in zip(
                state_leaves(state), self.recs):
            if kind == "scalar":
                scal.append(leaf)
                continue
            flat = leaf.reshape(width, K)
            if kind == "i64":
                parts64.append(flat)
            elif dtype == torch.float32:
                parts32.append(flat.contiguous().view(torch.int32))
            else:
                parts32.append(flat.to(torch.int32))
        dev = state.active.device
        b32 = torch.cat(parts32, dim=0) if parts32 else \
            torch.zeros((0, K), dtype=torch.int32, device=dev)
        b64 = torch.cat(parts64, dim=0) if parts64 else \
            torch.zeros((0, K), dtype=torch.int64, device=dev)
        return b32, b64, tuple(scal)

    def unpack(self, b32, b64, scalars) -> PatternState:
        leaves = []
        K = b32.shape[1]
        for kind, dtype, head, off, width in self.recs:
            if kind == "scalar":
                leaves.append(scalars[off])
                continue
            if kind == "i64":
                leaf = b64[off:off + width].reshape(head + (K,))
            else:
                flat = b32[off:off + width]
                if dtype == torch.float32:
                    flat = flat.contiguous().view(torch.float32)
                leaf = flat.reshape(head + (K,))
                if dtype == torch.bool:
                    leaf = leaf != 0
                elif dtype != torch.float32:
                    leaf = leaf.to(dtype)
            leaves.append(leaf)
        it = iter(leaves)
        fields = [next(it) for _ in range(9)]
        caps = {}
        for ck, ncols in self._caps_layout:
            ts = next(it)
            caps[ck] = (ts, tuple(next(it) for _ in range(ncols)))
        return PatternState(*fields, caps=caps)


@dataclasses.dataclass
class PlannedPatternQuery:
    name: str
    spec: PatternSpec
    exec: PatternExec
    in_schemas: Dict[str, ev.Schema]
    out_schema: ev.Schema
    output_target: str
    output_event_type: str
    # stream_id -> step; the four names mirror the reference's dispatch
    # table (gather/dense slot access x raw-i64/ts-delta wire)
    steps: Dict[str, Callable]
    init_state: Callable                # (K) -> (packed state, sel_state)
    key_capacity: int
    slots: int
    packer: StatePacker
    partition_positions: Optional[Dict[str, List[int]]] = None
    # range partitions: stream id -> staged batch -> ([label ids], mask)
    partition_key_fns: Optional[Dict[str, Callable]] = None
    dense_steps: Optional[Dict[str, Callable]] = None
    steps_w: Optional[Dict[str, Callable]] = None
    dense_steps_w: Optional[Dict[str, Callable]] = None
    # False when the per-key emission cap is an implicit default: overflow
    # then grows the cap instead of dropping rows
    emit_explicit: bool = True
    selector_exec: Any = None
    compact_rows: int = 8
    device: Any = None
    # (packed, sel_state, now) -> (packed', sel_state', out, wake); only
    # plans with absent atoms have one
    timer_step: Optional[Callable] = None
    # True when the plan runs the block NFA (non-partitioned simple chain)
    block: bool = False
    # the shard mesh of a partitioned plan deployed on one (B8): `steps`
    # and `timer_step` are then `ShardedStep` / `ShardedTimer` over a
    # `ShardedState`, and `shard_fused_steps` the @fuse entry (K
    # stacked batches, each shard walking them in order)
    mesh: Any = None
    shard_fused_steps: Optional[Dict[str, Callable]] = None


def plan_pattern_query(
    query: Query,
    name: str,
    schemas: Dict[str, ev.Schema],
    interner: ev.StringInterner,
    key_capacity: int = 1,
    slots: int = 8,
    count_cap: int = 8,
    partition_positions: Optional[Dict[str, List[int]]] = None,
    compact_rows_override: Optional[int] = None,
    device: Optional[torch.device] = None,
    in_col0_types: Optional[Dict[str, str]] = None,
    partition_key_fns: Optional[Dict[str, Callable]] = None,
    mesh=None,
) -> PlannedPatternQuery:
    from ..kernels.pattern_step import KernelPlan, PatternStep, TimerStep

    device = device if device is not None else torch.device("cpu")
    sis = query.input_stream
    if not isinstance(sis, StateInputStream):
        raise CompileError(f"query {name!r} is not a pattern query")
    # per-key emission row cap; only partitioned queries compact by default
    compact_rows = compact_rows_override or (
        8 if partition_positions else UNCAPPED_SENTINEL)
    emit_explicit = False
    for ann in query.annotations:
        if ann.name.lower() == "emit":
            compact_rows = int(ann.element("rows", compact_rows))
            emit_explicit = True
    spec = linearize(sis, count_cap=count_cap)
    for sid in spec.stream_ids:
        if sid not in schemas:
            raise CompileError(f"undefined stream {sid!r} in pattern")
    # a top-level pattern is not sharded, in either package
    mesh = mesh if partition_positions else None
    use_block = partition_positions is None and block_eligible(spec) \
        and not _FORCE_SCAN
    pexec = PatternExec(spec, schemas, interner, slots=slots,
                        emit_refs=_used_refs(query, spec), device=device,
                        in_col0_types=in_col0_types)

    out_target = query.output_stream.target_id if query.output_stream else ""
    # aggregators over pattern matches: the group slots are the partition
    # keys (a top-level plan's rows all take slot 0), as the reference's
    sel = SelectorExec(query.selector, pexec.scope,
                       schemas[spec.stream_ids[0]],
                       key_capacity if partition_positions else 64,
                       out_target or name)
    if sel.bank.pair_sources:
        raise CompileError(
            "distinctCount/unionSet in pattern queries lands in a later "
            "phase")

    out_def = StreamDefinition(out_target or f"#{name}.out")
    for n, t in zip(sel.out_names, sel.out_types):
        out_def.attribute(n, t)
    out_schema = ev.Schema(out_def, interner)

    packer = StatePacker(PatternExec(
        spec, schemas, interner, slots=slots).init_state(1))
    has_wake = spec.has_absent

    def make_step(stream_id: str, dense: bool = False):
        schema = schemas[stream_id]

        def step(packed, sel_state, raw_cols, raw_ts, sel_idx, key_ref, now,
                 in_tabs=None):
            # raw_cols/raw_ts are the UNGROUPED batch [B]; sel_idx [Kb,E]
            # holds batch indices (-1 = padding).  The blobs update in place.
            b32, b64, scalars = packed
            B = raw_ts.shape[0]
            K = b32.shape[1]
            csel = torch.clamp(sel_idx, 0, B - 1).long()
            cols = tuple(c[csel].to(d)
                         for c, d in zip(raw_cols, schema.dtypes))
            ts = raw_ts[csel]
            valid = sel_idx >= 0
            ord_ = csel
            Kb, E = ts.shape
            if dense:
                # the batch's slots are the contiguous range
                # [key_lo, key_lo+Kb); the runtime guarantees it fits
                key_lo = int(key_ref)
                if key_lo < 0 or key_lo + Kb > K:
                    raise ValueError(
                        f"dense step range [{key_lo}, {key_lo + Kb}) "
                        f"exceeds key capacity {K}")
                key_idx = key_lo + torch.arange(Kb, dtype=torch.int32,
                                                device=b32.device)
                sub32 = b32[:, key_lo:key_lo + Kb]
                sub64 = b64[:, key_lo:key_lo + Kb]
            else:
                # padding rows (index >= K) read the last column, as a
                # clamped gather does, and are masked out on write
                key_idx = key_ref
                gi = torch.clamp(key_idx, 0, K - 1).long()
                sub32, sub64 = b32[:, gi], b64[:, gi]
            sub = packer.unpack(sub32, sub64, scalars)

            emits = []
            for e in range(E):
                now_k = torch.where(valid[:, e], ts[:, e], now)
                sub, emit = pexec.tick(sub, stream_id,
                                       tuple(c[:, e] for c in cols),
                                       ts[:, e], valid[:, e], now_k,
                                       in_tabs)
                emits.append(emit)
            emits = _stack_emits(emits)

            nb32, nb64, nscal = packer.pack(sub)
            if dense:
                b32[:, key_lo:key_lo + Kb] = nb32
                b64[:, key_lo:key_lo + Kb] = nb64
            else:
                keep = (key_idx >= 0) & (key_idx < K)
                wi = key_idx[keep].long()
                b32[:, wi] = nb32[:, keep]
                b64[:, wi] = nb64[:, keep]

            sel_state, out = _emit_matches(
                sel, spec, emits, ord_, sel_state, now,
                key_idx=key_idx, compact_rows=compact_rows)
            wake = absent_wake(spec, sub) if has_wake else NO_WAKEUP
            return (b32, b64, nscal), sel_state, out, wake

        return step

    def wire_ts(body):
        """ts-delta wire variant: the host ships (base i64 scalar, delta i32
        [B]) instead of an 8-byte-per-event timestamp column."""
        def wrapped(packed, sel_state, raw_cols, ts_base, ts_delta,
                    sel_idx, key_ref, now, in_tabs=None):
            raw_ts = int(ts_base) + ts_delta.to(torch.int64)
            return body(packed, sel_state, raw_cols, raw_ts, sel_idx,
                        key_ref, now, in_tabs)
        return wrapped

    if use_block:
        from ..kernels.block_nfa import BlockPlan, BlockStep
        block_plans = {}
        if device.type == "cuda":
            block_plans = {sid: BlockPlan(pexec, sel, packer, sid,
                                          compact_rows)
                           for sid in spec.stream_ids}

        def block_variant(wire: bool):
            return {sid: BlockStep(
                (wire_ts if wire else (lambda b: b))(make_block_step(
                    spec, pexec, sel, schemas, packer, sid, compact_rows)),
                block_plans.get(sid), wire=wire)
                for sid in spec.stream_ids}

        steps, steps_w = block_variant(False), block_variant(True)
        dense_steps = dense_steps_w = None
    else:
        kernel_plans = {}
        if device.type == "cuda":
            kernel_plans = {sid: KernelPlan(pexec, sel, packer, sid,
                                            compact_rows)
                            for sid in spec.stream_ids}

        def variant(dense: bool, wire: bool):
            return {sid: PatternStep(
                (wire_ts if wire else (lambda b: b))(make_step(sid, dense)),
                kernel_plans.get(sid), dense=dense, wire=wire)
                for sid in spec.stream_ids}

        steps, dense_steps = variant(False, False), variant(True, False)
        steps_w, dense_steps_w = variant(False, True), variant(True, True)

    timer_step = None
    if spec.has_absent:
        any_sid = spec.stream_ids[0]
        schema0 = schemas[any_sid]

        def tstep(packed, sel_state, now, in_tabs=None):
            """One tick with an invalid event at ts = now over the whole
            slab, then the emission (the reference's default cap of 8 rows
            per key) and the wake over the whole slab."""
            b32, b64, scalars = packed
            dev = b32.device
            pstate = packer.unpack(b32, b64, scalars)
            K = pstate.active.shape[-1]
            zero_cols = tuple(
                torch.full((K,), ev.default_value(t), dtype=d, device=dev)
                for t, d in zip(schema0.types, schema0.dtypes))
            ts_e = torch.full((K,), int(now), dtype=torch.int64, device=dev)
            valid_e = torch.zeros((K,), dtype=torch.bool, device=dev)
            st, emit = pexec.tick(pstate, any_sid, zero_cols, ts_e, valid_e,
                                  ts_e, in_tabs)
            emits = _stack_emits([emit])                 # E = 1
            ord_ = torch.zeros((K, 1), dtype=torch.int64, device=dev)
            sel_state, out = _emit_matches(sel, spec, emits, ord_,
                                           sel_state, now)
            nb32, nb64, nscal = packer.pack(st)
            b32.copy_(nb32)
            b64.copy_(nb64)
            return (b32, b64, nscal), sel_state, out, absent_wake(spec, st)

        timer_plan = None
        if device.type == "cuda":
            timer_plan = KernelPlan(pexec, sel, packer, any_sid, 8)
        timer_step = TimerStep(tstep, timer_plan)

    def init_state(K: int):
        return packer.pack(pexec.init_state(K)), sel.init_state()

    shard_fused_steps = None
    if mesh is not None:
        if spec.has_absent and sel.bank.specs:
            # the JAX timer step aggregates every key's timer rows into
            # global group slot 0; per-shard timer launches would not
            raise NotImplementedError(
                f"query {name!r}: a pattern with absent atoms and "
                f"aggregators on a mesh is not ported")
        gather = steps
        steps = {sid: ShardedStep(st, mesh) for sid, st in gather.items()}
        shard_fused_steps = {sid: ShardedStep(st, mesh, fused=True)
                             for sid, st in gather.items()}
        steps_w = dense_steps = dense_steps_w = None
        if timer_step is not None:
            timer_step = ShardedTimer(timer_step, mesh)
        unsharded_init = init_state

        def init_state(K: int):                       # noqa: F811
            n = mesh.n
            if K % n:
                raise ValueError(f"key capacity {K} is not divisible by "
                                 f"{n} shards")
            return ShardedState(
                tuple(on_device(unsharded_init(K // n), d)
                      for d in mesh.devices))

    return PlannedPatternQuery(
        name=name, spec=spec, exec=pexec,
        in_schemas={sid: schemas[sid] for sid in spec.stream_ids},
        out_schema=out_schema,
        output_target=out_target,
        output_event_type=(query.output_stream.output_event_type
                           if query.output_stream and
                           query.output_stream.output_event_type
                           else "CURRENT_EVENTS"),
        steps=steps, dense_steps=dense_steps,
        steps_w=steps_w, dense_steps_w=dense_steps_w,
        timer_step=timer_step, block=use_block, init_state=init_state,
        key_capacity=key_capacity, slots=slots,
        packer=packer, partition_positions=partition_positions,
        partition_key_fns=partition_key_fns,
        emit_explicit=emit_explicit, selector_exec=sel,
        compact_rows=compact_rows, device=device, mesh=mesh,
        shard_fused_steps=shard_fused_steps)


# ---------------------------------------------------------------------------
# B8: the pattern step over a mesh of shards
# ---------------------------------------------------------------------------

def merge_pattern_out(outs, wakes, mesh, kb: int = 0):
    """The merged output of n shards' pattern steps: the header words
    summed and the wakes' least (K32's header mode), the rows concatenated
    shard by shard on the first device, or, given the shards' key rows
    `kb` (the timer step), each shard's [R, kb] rows side by side, the
    JAX timer's state-row order over the whole [W, C] slab."""
    from ..kernels.shard_merge import merge_header
    dev = mesh.first
    hdr = merge_header([torch.stack([o[0], o[1], torch.as_tensor(
        w, dtype=torch.int64, device=o[0].device)]) for o, w in
        zip(outs, wakes)], min_words=(2,))

    def cat(xs):
        xs = [x.to(dev) for x in xs]
        if not kb:
            return torch.cat(xs)
        return torch.cat([x.reshape(-1, kb) for x in xs], 1).reshape(-1)

    rows = [cat([o[j] for o in outs]) for j in (2, 3, 4)]
    cols = tuple(cat([o[5][c] for o in outs])
                 for c in range(len(outs[0][5])))
    return (hdr[0], hdr[1], *rows, cols), hdr[2]


def _merge_scalars(olds, packs, mesh):
    """Re-replicate the scalar counters: old + the sum of the shards'
    changes (K32's unmasked delta mode), one copy per shard."""
    from ..kernels.shard_merge import merge_delta
    n_scal = len(packs[0][2])
    merged = [merge_delta(olds[i], [p[2][i] for p in packs], masked=False)
              for i in range(n_scal)]
    return [(b32, b64, tuple(m.to(d).clone() for m in merged))
            for (b32, b64, _), d in zip(packs, mesh.devices)]


def absent_wake(spec: PatternSpec, st: PatternState):
    """The earliest pending absent deadline of the state's keys (the
    reference's next wakeup): standalone `not X for t` atoms and the timed
    absent sides of logical pairs whose wait has not elapsed."""
    wake = torch.full((), NO_WAKEUP, dtype=torch.int64,
                      device=st.active.device)
    for a in spec.atoms:
        if a.absent:
            at_pos = st.active & (st.pos == a.pos)
            dl = st.entry_ts + a.waiting_time
        elif a.partner is not None and a.partner.absent and \
                a.partner.waiting_time is not None:
            at_pos = st.active & (st.pos == a.pos) & ((st.lmask & 2) == 0)
            dl = st.entry_ts + a.partner.waiting_time
        else:
            continue
        wake = torch.minimum(wake, torch.min(torch.where(at_pos, dl,
                                                         NO_WAKEUP)))
    return wake


def _stack_emits(emits: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in emits[0].items():
        if isinstance(v, tuple):
            ts = torch.stack([e[k][0] for e in emits])
            cols = tuple(torch.stack([e[k][1][j] for e in emits])
                         for j in range(len(v[1])))
            out[k] = (ts, cols)
        else:
            out[k] = torch.stack([e[k] for e in emits])
    return out


def _used_refs(query: Query, spec: PatternSpec) -> set:
    """Refs whose captures the selector can touch (emission pruning)."""
    refs = {a.ref for a in spec.all_atoms() if not a.absent}
    sel = query.selector
    if sel.is_select_all:
        return refs      # select * touches everything
    used = set()
    exprs = [oa.expression for oa in sel.selection_list]
    if sel.having_expression is not None:
        exprs.append(sel.having_expression)
    exprs.extend(sel.group_by_list)
    exprs.extend(ob.variable for ob in sel.order_by_list)
    unqualified = False
    for e in exprs:
        for node in walk(e):
            if isinstance(node, Variable):
                if node.stream_id is not None and node.stream_id in refs:
                    used.add(node.stream_id)
                elif node.stream_id is None:
                    unqualified = True
    if unqualified:
        return refs
    return used


def _emit_matches(sel: SelectorExec, spec: PatternSpec, emits, ord_,
                  sel_state, now, key_idx=None, compact_rows: int = 8):
    """Flatten the emissions [E,P+1,K] into selector Rows + env, project,
    then compact the selector's OUTPUT rows per key to [R,K] by rank
    (a one-hot contraction over the EP axis).  Valid rows beyond R matches
    per key per batch are counted in the out[1] dropped scalar."""
    mask = emits["mask"]                       # [E,P+1,K]
    E, P1, K = mask.shape
    EP = E * P1
    B = EP * K
    dev = mask.device

    def flat(x):
        return x.reshape(B)

    rows_ts = flat(emits["ts"])
    slot_rank = torch.arange(P1, dtype=torch.int64, device=dev)[None, :, None]
    seq = flat(ord_.T[:, None, :].to(torch.int64) * (P1 + 1) + slot_rank)

    env: Dict[str, Any] = {"__ts__": rows_ts, "__now__": now}
    for a in spec.all_atoms():
        if a.absent or a.ckey not in emits:
            continue
        cap_ts, cap_cols = emits[a.ckey]       # [E,P+1,D,K]
        D = cap_ts.shape[2]
        env[a.ref] = tuple(c[:, :, 0, :].reshape(B) for c in cap_cols)
        for i in range(D):
            env[f"{a.ref}@{i}"] = tuple(
                c[:, :, i, :].reshape(B) for c in cap_cols)
        last_oh = last_filled(cap_ts, 2)                    # [E,P+1,D,K]
        env[f"{a.ref}@-1"] = tuple(
            flat(oh_take(c, last_oh, 2)) for c in cap_cols)

    if key_idx is not None:
        gslot = flat(torch.broadcast_to(key_idx[None, None, :].to(
            torch.int32), mask.shape)).clamp(min=0)
    else:
        gslot = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows = Rows(ts=rows_ts,
                kind=torch.full((B,), ev.CURRENT, dtype=torch.int32,
                                device=dev),
                valid=flat(mask), seq=seq, gslot=gslot, cols=())
    sel_state, out = sel.process(sel_state, rows, env)
    return sel_state, cut_per_key(out, EP, K, compact_rows)


def cut_per_key(out, EP: int, K: int, compact_rows: int):
    """The selector's output rows [EP * K] (row = ep * K + k) cut per key to
    its first R = min(compact_rows, EP) valid rows, [R, K], by rank (a
    one-hot contraction over the EP axis); returns (n_valid, n_dropped, ts,
    kind, valid, cols) with the rows past R counted in n_dropped."""
    ots, okind, ovalid, ocols = out
    dev = ovalid.device
    R = min(compact_rows, EP)
    if R < EP:
        v2 = ovalid.reshape(EP, K)
        rank = torch.cumsum(v2.to(torch.int32), dim=0,
                            dtype=torch.int32) - 1
        keep_oh = (torch.arange(R, dtype=torch.int32, device=dev)
                   [:, None, None] == rank[None]) & v2[None]  # [R,EP,K]
        cmask = torch.any(keep_oh, dim=1)      # [R,K]
        n_valid = torch.sum(cmask.to(torch.int64))
        n_dropped = torch.sum(v2.to(torch.int64)) - n_valid

        def cmp(x):                            # [B] -> [R*K]
            return oh_take(x.reshape(EP, K)[None], keep_oh, 1).reshape(R * K)

        out = (cmp(ots), cmp(okind), cmask.reshape(R * K),
               tuple(cmp(c) for c in ocols))
    else:
        n_valid = torch.sum(ovalid.to(torch.int64))
        n_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    # leading scalars: valid-row count and overflow count
    return (n_valid, n_dropped) + out


class ShardedStep:
    """One stream's pattern step on a mesh (B8 `_shard_step`; with `fused`,
    `_shard_fused_step`): `(state, raw_cols, raw_ts, sel [n, Kb, E],
    key_idx [n, Kb], now, in_tabs=None) -> (state', out, wake)`, the
    grouping from `ShardRouter.group` (host arrays).  Each shard runs the
    plan's gather step (the `pattern_step` kernel on a card, its plain
    version on the CPU) on its own block; K32 combines the headers, the
    scalar counters and the wakes.  The fused form takes K stacked
    batches (`raw_cols` [K][B] ..., `sel` [K, n, Kb, E], `key_idx` [K, n,
    Kb], `nows`) and returns one (out, wake) per batch: each batch merges
    as the JAX package's scan body does."""

    def __init__(self, step, mesh, fused: bool = False):
        self.step = step
        self.mesh = mesh
        self.fused = fused

    def __call__(self, state, raw_cols, raw_ts, sel, key_idx, now,
                 in_tabs=None):
        if not self.fused:
            return self._one(state, raw_cols, raw_ts, sel, key_idx, now,
                             in_tabs)
        outs = []
        for s, t in enumerate(now):
            state, out, wake = self._one(
                state, tuple(c[s] for c in raw_cols), raw_ts[s], sel[s],
                key_idx[s], t, in_tabs)
            outs.append((out, wake))
        return state, outs

    def _one(self, state, raw_cols, raw_ts, sel, key_idx, now, in_tabs):
        mesh = self.mesh
        # the replicated scalars before the step (the kernel moves them in
        # place); the batch's columns copied once to each distinct device
        olds = tuple(x.clone() for x in state[0][0][2])
        batch_on = {}
        packs, sels, outs, wakes = [], [], [], []
        for d, dev in enumerate(mesh.devices):
            packed, sel_state = state[d]
            if dev not in batch_on:
                batch_on[dev] = on_device((raw_cols, raw_ts), dev)
            cols, ts = batch_on[dev]
            sd = torch.from_numpy(np.ascontiguousarray(sel[d])).to(dev)
            kd = torch.from_numpy(np.ascontiguousarray(key_idx[d])).to(dev)
            packed, sel_state, out, wake = self.step(
                packed, sel_state, cols, ts, sd, kd, now, in_tabs=in_tabs)
            packs.append(packed)
            sels.append(sel_state)
            outs.append(out)
            wakes.append(wake)
        packs = _merge_scalars(olds, packs, mesh)
        out, wake = merge_pattern_out(outs, wakes, mesh)
        return ShardedState(zip(packs, sels)), out, wake


class ShardedTimer:
    """The timer step of a sharded plan: one timer launch per shard over
    the shard's [W, C / n] slab; the rows interleave into the JAX timer's
    state-row order, and K32 merges the headers, scalars and wakes."""

    def __init__(self, timer, mesh):
        self.timer = timer
        self.mesh = mesh

    def __call__(self, state, now, in_tabs=None):
        mesh = self.mesh
        packs, sels, outs, wakes = [], [], [], []
        olds = tuple(x.clone() for x in state[0][0][2])
        for d in range(mesh.n):
            packed, sel_state = state[d]
            packed, sel_state, out, wake = self.timer(
                packed, sel_state, now, in_tabs=in_tabs)
            packs.append(packed)
            sels.append(sel_state)
            outs.append(out)
            wakes.append(wake)
        packs = _merge_scalars(olds, packs, mesh)
        out, wake = merge_pattern_out(outs, wakes, mesh,
                                      kb=packs[0][0].shape[1])
        return ShardedState(zip(packs, sels)), out, wake
