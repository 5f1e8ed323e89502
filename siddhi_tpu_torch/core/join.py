"""Stream-stream and stream-table join queries (port of
`siddhi_tpu/core/join.py`).

Reference behaviour (what): each CURRENT or EXPIRED row one side's window
emits probes the other side's window, or the table on the other side;
matched pairs are emitted, and for the outer side(s) of a left / right /
full outer join the rows that match nothing are emitted with the other
side null; `unidirectional` restricts which side triggers.  A table side
never triggers; its stream side may have no window (`NoWindow`).

How the port runs a step (a batch arriving on side X), on CUDA one kernel
per stage and on the CPU each kernel's plain version:
  1. X's filters (before its window) and the compaction of its arrivals:
     K1 `filter_compact`;
  2. X's window: K5 `length_window` or K2 `time_window`, each a ring in
     add_seq order (a bucketed side's ring carries the key-slot column
     last), or none (K1's compaction; on the table fast path the batch
     row index rides as the last column);
  3. on the bucket path (an equality conjunct and no side filters), the
     other side's lane table: K6 `join_lanes`;
  4. the probe, the ON and having conditions and the cut to the emission
     cap: K7 `join_probe`, which writes the index rows and [n_valid,
     n_current, n_dropped]; against a table it scans the valid rows
     (grid) or, on the table fast path, the host's [B, K] index
     candidates (`JoinQueryRuntime._table_probe` in `core/runtime.py`);
  5. the torch projection: gathers of the columns by the index rows, the
     in-band nulls of unmatched rows, the select expressions; with group
     by or aggregators the joined rows' composed group slots (each
     side's slot rides its window) and K4 `group_agg` first.
The step returns the output rows and one header, i64[6] = [n_valid,
n_current, n_dropped, lane overflow, wake, rows a time side's expire bound
missed], which the runtime fetches once.

Ported from the reference (line numbers of `siddhi_tpu/core/join.py`):
`JoinSide`, `PlannedJoinQuery`, `_mk_side` (with its table side and
windowless stream side, :189-241), `plan_join_query` (:34-705, with its
table mode), `make_step` (:445, with its table branches) and
`_make_feed_only` (:708), `_retention_rows`, `_lane_bucket_count`,
`_conjunct_count`, `_norm_key_cols` (:748-805), `_TrackSide` and
`JoinKeyTracker` (:808-922, host numpy, copied); `_bucket_lanes` (:775)
is K6.  The join parts of `siddhi_tpu/core/plan_facts.py` are copied
here, where only the join uses them: `window_handler` (:133),
`join_equi_pairs` (:351), `JOIN_LANE_K_MIN` (:396), `join_fastpath`
(:399) and `table_probe_attrs_of` (:468).

A named-window side (reference :202-218) probes the window's contents
(`NamedWindowRuntime.current_buffer`, a copy gathered on the device) and
triggers on the rows the window publishes (a `PassAllWindow`, K1 keeping
EXPIRED rows); an aggregation side (:195-201) probes the buckets of its
`per` duration `within` the range (`AggregationRuntime.device_view`, the
reference's `_aggregation_view`).  Both take the grid path of K7's table
mode.

Not ported, raising at plan time: `in Table` in the ON condition, select
or having (B-probe), distinctCount / unionSet (B14), `@fuse` /
`@async` / `@pipeline` / `@serve` (A12, raised by the runtime), mesh
placement (A14) and the restore path (A13).  On CUDA a join whose
conditions or columns do not fit the kernels raises NotImplementedError
here.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..query_api.definition import StreamDefinition
from ..query_api.expression import AttributeFunction, In, walk
from ..query_api.query import Filter, JoinInputStream, Query, \
    SingleInputStream, Window
from . import event as ev
from .executor import AGGREGATOR_NAMES, CompileError, CompiledExpr, Scope, \
    compile_expression
from .keyslots import SlotAllocator
from .selector import SelectorExec, _substitute_aliases
from .window import NO_WAKEUP, NoWindow, PassAllWindow, Rows, \
    WindowProcessor, create_window

# A-B kill switch: the parity tests plan one runtime with the fast path
# off to hold the bucket path against the grid path.  Consulted once at
# plan time; never flipped on a live runtime.
FASTPATH_ENABLED = True

JSLOT_COL = "#jslot"
BIX_COL = "#bix"

# lane width floor for the bucketed join probe; host occupancy tracking
# grows it in power-of-two steps (JoinKeyTracker)
JOIN_LANE_K_MIN = 8


# ---------------------------------------------------------------------------
# plan facts (siddhi_tpu/core/plan_facts.py)
# ---------------------------------------------------------------------------

def window_handler(sis) -> Optional[Window]:
    for h in getattr(sis, "stream_handlers", ()):
        if isinstance(h, Window):
            return h
    return None


def join_equi_pairs(jis) -> List[Tuple[object, object, object]]:
    """Top-level `==` conjuncts of a join ON-condition comparing one
    side-qualified attribute from each side: [(Compare node, left
    Variable, right Variable)], the left side's variable first whatever
    the written order."""
    from ..query_api import expression as ex
    on = getattr(jis, "on_compare", None)
    if on is None:
        return []
    ls, rs = jis.left_input_stream, jis.right_input_stream
    left_keys = {ls.stream_reference_id or ls.stream_id, ls.stream_id}
    right_keys = {rs.stream_reference_id or rs.stream_id, rs.stream_id}

    def conjuncts(e):
        if isinstance(e, ex.And):
            yield from conjuncts(e.left)
            yield from conjuncts(e.right)
        else:
            yield e

    def side_of(v):
        if v.stream_id in left_keys:
            return "left"
        if v.stream_id in right_keys:
            return "right"
        return None

    out: List[Tuple[object, object, object]] = []
    for c in conjuncts(on):
        if not isinstance(c, ex.Compare) or c.operator != "==":
            continue
        if not (isinstance(c.left, ex.Variable) and
                isinstance(c.right, ex.Variable)):
            continue
        sides = (side_of(c.left), side_of(c.right))
        if sides == ("left", "right"):
            out.append((c, c.left, c.right))
        elif sides == ("right", "left"):
            out.append((c, c.right, c.left))
    return out


def join_fastpath(jis, side_kind, table_probe_attrs=None
                  ) -> Tuple[Optional[str], List, Optional[str]]:
    """Equi-join fast-path decision: (mode, pairs, reason).

    mode 'bucket' — both sides are stream windows: key slots ride the
    window buffers and the step probes only same-bucket pairs.
    mode 'table' — one side is an indexed table and the trigger side is
    a windowless stream: the table's AttributeIndex / primary-key hash
    answers candidates on the host.  mode None + reason — an equality
    conjunct exists but the fast path cannot apply.  mode None + reason
    None — no equality conjunct.

    `side_kind(sid)` -> 'stream' | 'table' | 'named_window' |
    'aggregation'; `table_probe_attrs(sid)` -> attribute names
    probe-able through a single-column @PrimaryKey or an @Index (table
    mode only).  A named-window or aggregation side takes neither path:
    its rows come from a shared buffer the join carries no key slots
    through."""
    pairs = join_equi_pairs(jis)
    if not pairs:
        return None, [], None
    sides = {}
    for label, sis in (("left", jis.left_input_stream),
                       ("right", jis.right_input_stream)):
        sides[label] = (sis, side_kind(sis.stream_id))
    kinds = {label: k for label, (_, k) in sides.items()}
    for label, (sis, kind) in sides.items():
        if kind in ("named_window", "aggregation"):
            return None, pairs, (
                f"{label} side {sis.stream_id!r} is a {kind} — its rows "
                f"are probed from a shared buffer the join cannot carry "
                f"key slots through")
    if kinds["left"] == "stream" and kinds["right"] == "stream":
        for label, (sis, _) in sides.items():
            if any(isinstance(h, Filter) for h in sis.stream_handlers):
                return None, pairs, (
                    f"{label} side {sis.stream_id!r} has a stream filter "
                    f"— host key-retention tracking would under-count "
                    f"the window and could free live key buckets")
        return "bucket", pairs, None
    # stream-table: the stream side triggers, the table answers probes
    t_label = "left" if kinds["left"] == "table" else "right"
    s_label = "right" if t_label == "left" else "left"
    t_sis = sides[t_label][0]
    s_sis = sides[s_label][0]
    if kinds[s_label] != "stream":
        return None, pairs, "cannot join two table-like sides"
    if window_handler(s_sis) is not None:
        return None, pairs, (
            f"windowed stream side {s_sis.stream_id!r} joining table "
            f"{t_sis.stream_id!r} — buffered rows cannot re-probe the "
            f"table index at step time")
    probe_attrs = set(table_probe_attrs(t_sis.stream_id)) \
        if table_probe_attrs is not None else set()
    usable = []
    for c, lv, rv in pairs:
        t_var = lv if t_label == "left" else rv
        if t_var.attribute_name in probe_attrs:
            usable.append((c, lv, rv))
    if not usable:
        attrs = ", ".join(
            repr((lv if t_label == "left" else rv).attribute_name)
            for _, lv, rv in pairs)
        return None, pairs, (
            f"table {t_sis.stream_id!r} has no single-column @PrimaryKey "
            f"or @Index on join key {attrs} — equality probes stay "
            f"linear scans")
    return "table", usable, None


def table_probe_attrs_of(tdef) -> List[str]:
    """Attribute names of a TableDefinition probe-able by hash: a
    single-column @PrimaryKey plus every @Index attribute."""
    out: List[str] = []
    pk = tdef.get_annotation("PrimaryKey")
    if pk is not None:
        names = pk.positional_elements()
        if len(names) == 1:
            out.append(names[0])
    idx = tdef.get_annotation("Index")
    if idx is not None:
        out.extend(n for n in idx.positional_elements() if n not in out)
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinSide:
    stream_id: str
    key: str                      # scope key (alias or stream id)
    schema: ev.Schema             # the stream's (or table's) columns
    window: Optional[WindowProcessor]   # over win_schema; None: a table
    win_schema: ev.Schema         # + the key-slot column on the bucket
    #                               path, the batch-row column on the
    #                               table fast path
    is_table: bool = False        # a table-like side: a table, an
    #                               aggregation or a named window
    pre_filters: List[CompiledExpr] = dataclasses.field(default_factory=list)
    fspec: Any = None             # kernels.filter_compact.FilterSpec
    is_aggregation: bool = False
    # a named window side probes the window's contents and triggers on
    # the rows the window publishes (its `window` is a PassAllWindow)
    is_named_window: bool = False


@dataclasses.dataclass
class PlannedJoinQuery:
    name: str
    left: JoinSide
    right: JoinSide
    join_type: str
    trigger: str
    out_schema: ev.Schema
    output_target: str
    output_event_type: str
    selector_exec: SelectorExec
    step_left: Optional[Callable]
    step_right: Optional[Callable]
    init_state: Callable
    needs_timer: bool
    device: torch.device
    # emission cap: None = the reference's per-step default max(2R, 1024);
    # grows (runtime) unless the user's @emit(rows='N') set it
    compact_rows: Optional[int] = None
    emit_explicit: bool = False
    # equi-join fast path
    fastpath: Optional[str] = None
    fastpath_reason: Optional[str] = None
    key_left: List[int] = dataclasses.field(default_factory=list)
    key_right: List[int] = dataclasses.field(default_factory=list)
    key_dtypes: List[Any] = dataclasses.field(default_factory=list)
    residual: bool = False
    lane_k: int = 0              # candidate lane width (bucket mode)
    lane_buckets: Tuple[int, int] = (0, 0)
    ring_caps: Tuple[int, int] = (0, 0)
    join_key_allocator: Optional[SlotAllocator] = None
    # table mode: which side is the table and the probe columns
    table_is_left: bool = False
    table_pos: int = -1          # indexed table column
    stream_key_pos: int = -1     # stream-side key column
    # (left, right) kernels.join_probe.ProbeSpec of each triggering side
    probe_specs: Tuple[Any, Any] = (None, None)
    # group by and aggregators: each side's group attributes, slot
    # allocator and slot count (the joined row's slot composes the two)
    aggregates: bool = False
    # the tables the side filters' `in` probes read
    in_deps: List[str] = dataclasses.field(default_factory=list)
    group_positions: Tuple[List[int], List[int]] = ([], [])
    group_allocators: Tuple[Any, Any] = (None, None)
    group_slots: Tuple[int, int] = (0, 0)
    # an aggregation side's `within` [start, end) and `per` duration
    within_range: Optional[Tuple[int, int]] = None
    per_duration: Optional[str] = None


def _probe_schema(schema: ev.Schema, col: str = JSLOT_COL) -> ev.Schema:
    """A fast-path side's window schema: the stream's columns plus one INT
    column riding the window.  On the bucket path it carries the key's
    bucket slot, so an EXPIRED row keeps the slot it was bucketed under at
    arrival; on the table fast path the batch row index, so a compacted
    trigger row finds the host's candidates of its batch row."""
    d = StreamDefinition(f"{schema.id}{col}")
    for n, t in zip(schema.names, schema.types):
        d.attribute(n, t)
    d.attribute(col, "INT")
    return ev.Schema(d, schema.interner)


def _mk_side(sis: SingleInputStream, schemas, tables, batch_capacity,
             scope: Scope, window_capacity_hint: int,
             extra_col: Optional[str], aggregations=None,
             named_windows=None) -> JoinSide:
    sid = sis.stream_id
    key = sis.stream_reference_id or sid
    if aggregations and sid in aggregations:
        # the aggregation's buckets, read at each step (reference
        # :195-201)
        schema = aggregations[sid].make_schema()
        scope.add_source(key, schema, alias=None)
        return JoinSide(sid, key, schema, None, schema, is_table=True,
                        is_aggregation=True)
    if named_windows and sid in named_windows:
        # probes the window's contents and triggers on what it publishes
        # (reference :202-218; Window.java:145-184)
        nw = named_windows[sid]
        if nw.current_buffer() is None:
            raise CompileError(
                f"named window {sid!r} ({nw.wproc.name}) does not expose a "
                f"probe-able buffer for joins")
        schema = nw.schema
        scope.add_source(key, schema, alias=None)
        return JoinSide(sid, key, schema,
                        PassAllWindow(schema, [], batch_capacity), schema,
                        is_table=True, is_named_window=True)
    if sid in tables:
        schema = tables[sid].schema
        scope.add_source(key, schema, alias=None)
        return JoinSide(sid, key, schema, None, schema, is_table=True)
    if sid not in schemas:
        raise CompileError(f"undefined stream {sid!r}")
    schema = schemas[sid]
    scope.add_source(key, schema, alias=None)
    win_schema = _probe_schema(schema, extra_col) if extra_col else schema
    wh = window_handler(sis)
    if wh is None:
        # windowless stream side: valid when probing a table
        return JoinSide(sid, key, schema,
                        NoWindow(win_schema, [], batch_capacity), win_schema)
    win = create_window((wh.namespace + ":" if wh.namespace else "") +
                        wh.name, win_schema, wh.parameters, batch_capacity,
                        capacity_hint=window_capacity_hint)
    if win.name not in ("length", "time"):
        raise CompileError(f"join windows must be sliding (length/time), "
                           f"got {win.name!r}")
    return JoinSide(sid, key, schema, win, win_schema)


def _retention_rows(win: Optional[WindowProcessor]) -> int:
    """Upper bound on rows a join window retains: length windows keep
    exactly `length`; time windows drop-oldest above `capacity`."""
    if win is None:
        return 0
    n = getattr(win, "length", None)
    if n is None:
        n = getattr(win, "capacity", None)
    return int(n if n is not None else win.batch_capacity)


def _lane_bucket_count(ring: int) -> int:
    """Power-of-two lane-table rows for a buffer bound: about 2 buckets per
    resident row."""
    return max(64, min(1 << 17, 1 << (2 * max(ring, 1) - 1).bit_length()))


def _conjunct_count(on) -> int:
    from ..query_api.expression import And
    if on is None:
        return 0
    if isinstance(on, And):
        return _conjunct_count(on.left) + _conjunct_count(on.right)
    return 1


def _reference_rows(win: WindowProcessor, B: int) -> int:
    """The reference's window output size R for a batch of capacity B:
    B without a window, 2B for a length window, B + C for a time window of
    capacity C.  The implicit emission cap max(2R, 1024) is computed from
    it."""
    if isinstance(win, (NoWindow, PassAllWindow)):
        return B
    if win.name == "length":
        return 2 * B
    return B + win.capacity


def _kernel_subset(name: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"query {name!r} is outside the CUDA kernels' subset: {why}")


def plan_join_query(query: Query, name: str, schemas: Dict[str, ev.Schema],
                    interner, batch_capacity: int = 512,
                    window_capacity_hint: int = 512,
                    device: Optional[torch.device] = None,
                    tables: Optional[Dict[str, Any]] = None,
                    in_cols: Optional[Dict[str, str]] = None,
                    aggregations=None, named_windows=None
                    ) -> PlannedJoinQuery:
    from ..kernels.filter_bytecode import AND, InKeys, compile_filter
    from ..kernels.filter_compact import FilterSpec
    from ..kernels.join_probe import ProbeSpec
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    cuda = device.type == "cuda"
    jis = query.input_stream
    if not isinstance(jis, JoinInputStream):
        raise CompileError(f"query {name!r} is not a join")
    tables = tables or {}

    def side_kind(sid: str) -> str:
        if aggregations and sid in aggregations:
            return "aggregation"
        if named_windows and sid in named_windows:
            return "named_window"
        return "table" if sid in tables else "stream"

    fp_mode, fp_pairs, fp_reason = join_fastpath(
        jis, side_kind,
        lambda sid: table_probe_attrs_of(tables[sid].definition))
    if not FASTPATH_ENABLED and fp_mode is not None:
        fp_mode, fp_reason = None, "fast path disabled (A-B comparison)"
    bucket = fp_mode == "bucket"
    extra_col = JSLOT_COL if bucket else \
        BIX_COL if fp_mode == "table" else None

    scope = Scope(device)
    scope.interner = interner
    left = _mk_side(jis.left_input_stream, schemas, tables, batch_capacity,
                    scope, window_capacity_hint, extra_col, aggregations,
                    named_windows)
    right = _mk_side(jis.right_input_stream, schemas, tables,
                     batch_capacity, scope, window_capacity_hint, extra_col,
                     aggregations, named_windows)
    if left.is_table and right.is_table and \
            not (left.is_named_window or right.is_named_window):
        raise CompileError("cannot join two tables in a streaming query")
    within_range = per_duration = None
    if left.is_aggregation or right.is_aggregation:
        from .aggregation import parse_per, parse_within
        within_range = parse_within(jis.within)
        per_duration = parse_per(jis.per)
    if not left.is_table and not right.is_table and (
            isinstance(left.window, NoWindow) or
            isinstance(right.window, NoWindow)):
        raise CompileError("stream-stream joins need a window on each side")
    if cuda:
        from ..kernels.filter_compact import MAX_COLS
        for s in (left, right):
            if len(s.win_schema.types) > MAX_COLS:
                raise _kernel_subset(name, f"side {s.stream_id!r} has "
                                     f"{len(s.win_schema.types)} columns "
                                     f"(the kernels take {MAX_COLS})")

    # side filters (before the window): K1.  A table's or an aggregation's
    # filters are compiled, as the reference compiles them, and never
    # applied: those sides do not step.
    for side, sis in ((left, jis.left_input_stream),
                      (right, jis.right_input_stream)):
        fscope = Scope(device)
        fscope.interner = interner
        fscope.add_source(side.key, side.schema)
        code = [] if cuda and (not side.is_table or
                               side.is_named_window) else None
        ik = InKeys(dict(in_cols or {}))
        for h in sis.stream_handlers:
            if isinstance(h, Filter):
                c = compile_expression(h.expression, fscope)
                if c.type != "BOOL":
                    raise CompileError("filter expression must be boolean")
                side.pre_filters.append(c)
                if code is not None:
                    try:
                        code += compile_filter(h.expression, fscope,
                                               side.key, {}, in_keys=ik)
                    except CompileError as exc:
                        raise _kernel_subset(name, str(exc)) from exc
                    if len(side.pre_filters) > 1:
                        code.append(AND)
        side.fspec = FilterSpec(side.win_schema.types, side.pre_filters,
                                code, side.key, ik.keys)
    # a side's filters probe tables through K1; the reference ships no
    # probe into its join step, so `in` elsewhere in a join fails there at
    # the first event, and here at plan time
    rest = [jis.on_compare, query.selector.having_expression] + [
        oa.expression for oa in query.selector.selection_list]
    if any(isinstance(n, In) for e in rest if e is not None
           for n in walk(e)):
        raise CompileError(
            f"query {name!r}: `in Table` in a join's ON condition, select "
            f"or having is not ported (ROADMAP B-probe)")

    on = None
    if jis.on_compare is not None:
        on = compile_expression(jis.on_compare, scope)
        if on.type != "BOOL":
            raise CompileError("join condition must be boolean")

    # ---- equi-join fast-path plan details ----------------------------------
    key_left: List[int] = []
    key_right: List[int] = []
    key_dtypes: List[Any] = []
    lane_k = 0
    lane_buckets = (0, 0)
    ring_caps = (0, 0)
    jk_alloc = None
    table_is_left = False
    table_pos = stream_key_pos = -1
    n_keys = len(fp_pairs) if fp_mode is not None else 0
    if fp_mode == "table":
        tside, sside = (left, right) if left.is_table else (right, left)
        table_is_left = left.is_table
        _c, lv, rv = fp_pairs[0]
        t_var, s_var = (lv, rv) if table_is_left else (rv, lv)
        table_pos = tside.schema.position(t_var.attribute_name)
        stream_key_pos = sside.schema.position(s_var.attribute_name)
        n_keys = 1
    if bucket:
        for _c, lv, rv in fp_pairs:
            lp = left.schema.position(lv.attribute_name)
            rp = right.schema.position(rv.attribute_name)
            key_left.append(lp)
            key_right.append(rp)
            # both sides hash the promoted encoding, so any two values the
            # compiled `==` calls equal land in one bucket
            key_dtypes.append(np.promote_types(
                ev.np_dtype(left.schema.types[lp]),
                ev.np_dtype(right.schema.types[rp])))
        ring_caps = (_retention_rows(left.window),
                     _retention_rows(right.window))
        lane_buckets = (_lane_bucket_count(ring_caps[0]),
                        _lane_bucket_count(ring_caps[1]))
        auto_k = 1 << (max(1, min(max(ring_caps), 16)) - 1).bit_length()
        lane_k = max(JOIN_LANE_K_MIN, auto_k)
        jk_alloc = SlotAllocator(
            ring_caps[0] + ring_caps[1] + 2 * max(batch_capacity, 8192),
            name=f"{name}:joinkey")
    n_conj = _conjunct_count(jis.on_compare)
    fp_residual = fp_mode is not None and n_conj > n_keys

    # ---- selector: projection and having -----------------------------------
    selector = query.selector
    uses_agg = any(
        isinstance(n, AttributeFunction) and not n.namespace and
        n.name in AGGREGATOR_NAMES
        for e in [oa.expression for oa in selector.selection_list] +
        ([selector.having_expression]
         if selector.having_expression is not None else [])
        for n in walk(e))
    # group by in joins (reference `siddhi_tpu/core/join.py:389-418`):
    # group attributes resolve to per-side slots at ingestion; the joined
    # row's slot is gl * (Kr + 1) + gr, an unmatched outer row taking the
    # other side's null group K_other.  The selector (K4, sort mode) then
    # aggregates over the joined rows, and having runs after it.
    aggregates = bool(selector.group_by_list) or uses_agg
    gl_pos: List[int] = []
    gr_pos: List[int] = []
    for v in selector.group_by_list:
        key, pos, _ = scope.resolve(v)
        side = left if key == left.key else right if key == right.key \
            else None
        if side is None:
            raise CompileError(
                f"cannot resolve group-by attribute {v.attribute_name!r} "
                f"to a join side")
        if side.is_table:
            raise CompileError(
                "join group-by attributes must come from stream sides")
        (gl_pos if side is left else gr_pos).append(pos)
    if gl_pos and gr_pos:
        Kl = Kr = 63
    elif gl_pos:
        Kl, Kr = 2047, 0
    elif gr_pos:
        Kl, Kr = 0, 2047
    else:
        Kl = Kr = 0
    having = having_expr = None
    if selector.having_expression is not None and not aggregates:
        # having may name select aliases: substitute the projected
        # expressions (as the selector does) into a copy
        alias_map = {oa.rename: oa.expression
                     for oa in selector.selection_list if oa.rename}
        having_expr = _substitute_aliases(
            copy.deepcopy(selector.having_expression), alias_map, scope)
        having = compile_expression(having_expr, scope)
        if having.type != "BOOL":
            raise CompileError("having expression must be boolean")
    proj_selector = copy.copy(selector)
    if not aggregates:
        proj_selector.having_expression = None
    out_target = query.output_stream.target_id if query.output_stream \
        else ""
    sel = SelectorExec(proj_selector, scope, left.schema,
                       max((Kl + 1) * (Kr + 1), 64), out_target or name)
    if sel.bank.pair_sources:
        # reference join.py:421-423
        raise CompileError(
            "distinctCount/unionSet in join queries lands in a later phase "
            "(ROADMAP B14)")
    if cuda:
        from ..kernels.group_agg import MAX_SPECS
        if len(sel.bank.specs) > MAX_SPECS:
            raise _kernel_subset(name, f"{len(sel.bank.specs)} accumulator "
                                 f"columns (group_agg takes {MAX_SPECS})")
    out_def = StreamDefinition(out_target or f"#{name}.out")
    for n, t in zip(sel.out_names, sel.out_types):
        out_def.attribute(n, t)
    out_schema = ev.Schema(out_def, interner)

    jt = jis.type
    trigger = jis.trigger
    emit_ann = query.get_annotation("emit")
    emit_explicit = emit_ann is not None
    emit_rows = int(emit_ann.element("rows", 0)) or None \
        if emit_explicit else None

    plan = PlannedJoinQuery(
        name=name, left=left, right=right, join_type=jt, trigger=trigger,
        out_schema=out_schema, output_target=out_target,
        output_event_type=(query.output_stream.output_event_type
                           if query.output_stream and
                           query.output_stream.output_event_type
                           else "CURRENT_EVENTS"),
        selector_exec=sel, step_left=None, step_right=None,
        # (left window, right window), and with aggregators a box holding
        # the selector's state, which each step replaces
        init_state=lambda: tuple(
            s.window.init_state(device) if s.window is not None else None
            for s in (left, right)) + (
                ([sel.init_state()],) if aggregates else ()),
        needs_timer=any(s.window is not None and s.window.needs_timer
                        for s in (left, right)),
        device=device, compact_rows=emit_rows, emit_explicit=emit_explicit,
        fastpath=fp_mode, fastpath_reason=fp_reason, key_left=key_left, key_right=key_right, key_dtypes=key_dtypes,
        residual=fp_residual, lane_k=lane_k, lane_buckets=lane_buckets,
        ring_caps=ring_caps, join_key_allocator=jk_alloc,
        table_is_left=table_is_left, table_pos=table_pos,
        stream_key_pos=stream_key_pos, aggregates=aggregates,
        in_deps=list(in_cols or {}),
        group_positions=(gl_pos, gr_pos),
        group_allocators=(
            SlotAllocator(Kl, name=f"{name}:gl") if gl_pos else None,
            SlotAllocator(Kr, name=f"{name}:gr") if gr_pos else None),
        group_slots=(Kl, Kr), within_range=within_range,
        per_duration=per_duration)

    def probe_spec(this: JoinSide, other: JoinSide, this_is_left: bool):
        emit_unmatched = (
            (jt == "LEFT_OUTER_JOIN" and this_is_left) or
            (jt == "RIGHT_OUTER_JOIN" and not this_is_left) or
            jt == "FULL_OUTER_JOIN")
        on_code = having_code = None
        if cuda:
            try:
                on_code = [] if jis.on_compare is None else compile_filter(
                    jis.on_compare, scope, this.key, {}, other.key)
                if having_expr is not None:
                    having_code = compile_filter(having_expr, scope,
                                                 this.key, {}, other.key)
            except CompileError as exc:
                raise _kernel_subset(name, str(exc)) from exc
        table = None if not (other.is_table or _empty_other(this, other)) \
            else "index" if fp_mode == "table" else "grid"
        return ProbeSpec(this.key, other.key, this.win_schema.types,
                         other.win_schema.types, on, having, on_code,
                         having_code, emit_unmatched, bucket, table)

    # a table or aggregation side never triggers, a named window side
    # does (reference :657-663); a stream side that does not trigger still
    # keeps its window
    def triggers(side: JoinSide, which: str) -> bool:
        return (not side.is_table or side.is_named_window) and \
            trigger in ("ALL_EVENTS", which)
    specs = (probe_spec(left, right, True) if triggers(left, "LEFT")
             else None,
             probe_spec(right, left, False) if triggers(right, "RIGHT")
             else None)
    plan.probe_specs = specs
    for is_left, this, other, spec in ((True, left, right, specs[0]),
                                       (False, right, left, specs[1])):
        step = _make_step(plan, this, other, is_left, spec) \
            if spec is not None else None if this.is_table else \
            _make_feed_only(plan, this, is_left)
        if is_left:
            plan.step_left = step
        else:
            plan.step_right = step
    return plan


def _empty_other(this: JoinSide, other: JoinSide) -> bool:
    """A named window's rows probing a windowless stream side, which holds
    no rows: they probe an empty table.  (The reference probes the
    stream side's pass-through state there and fails at every row the
    window publishes.)"""
    return this.is_named_window and isinstance(other.window, NoWindow)


def _header(wake, dev) -> torch.Tensor:
    """[0, 0, 0, 0, wake, missed]: the probe writes words 0-2, the lane
    build word 3, a time window the last two."""
    if wake is None:
        return torch.tensor([0, 0, 0, 0, NO_WAKEUP, 0], dtype=torch.int64,
                            device=dev)
    h = torch.zeros(6, dtype=torch.int64, device=dev)
    h[4:6].copy_(wake)
    return h


def side_cols(batch, extra):
    """The columns a side's window sees: the batch's, then the key-slot
    column (bucket path) or the batch row index (table fast path)."""
    return tuple(batch.cols) + ((extra,) if extra is not None else ())


def _advance(side: JoinSide, state, batch, gslot, extra, now: int, facts,
             in_tabs=None, pre=None):
    """The side's filters and window over one batch (K1, then K5 or K2);
    the key-slot column rides the window on the bucket path, the batch
    row index on the table fast path (`extra`).  `pre` (a `Prefiltered`
    spec) carries the batch's rows K29 already filtered."""
    rows = Rows(ts=batch.ts, kind=batch.kind, valid=batch.valid, seq=None,
                gslot=gslot, cols=side_cols(batch, extra))
    _, wout = side.window.process(
        state, rows, side.fspec.bind(in_tabs) if pre is None else pre, now,
        facts)
    return wout


def _make_step(plan: PlannedJoinQuery, this: JoinSide, other: JoinSide,
               this_is_left: bool, spec):
    """Step for a batch arriving on `this` side (reference `make_step`,
    `siddhi_tpu/core/join.py:445`).  `probe` is the batch's key-slot
    column on the bucket path and its [B, K] table candidates on the
    table fast path; `table` is a table other side's (cols, ts, valid)."""
    from ..kernels.join_lanes import join_lanes
    from ..kernels import join_probe as k7
    bucket = plan.fastpath == "bucket"
    table_probe = plan.fastpath == "table"
    nbl_other = (plan.lane_buckets[1] if this_is_left
                 else plan.lane_buckets[0]) if bucket else 0
    Q_grid = _retention_rows(other.window)
    sel = plan.selector_exec
    used = sel.used_columns()
    o_types = other.schema.types
    Kl, Kr = plan.group_slots
    K_other = Kr if this_is_left else Kl
    bix: Dict[Tuple[int, Any], torch.Tensor] = {}
    empty_other = _empty_other(this, other)

    def step(state, batch, gslot, probe, now: int, facts, table=None,
             in_tabs=None, pre=None):
        this_state = state[0 if this_is_left else 1]
        other_state = state[1 if this_is_left else 0]
        B = batch.ts.shape[0]
        dev = batch.ts.device
        extra = probe
        if table_probe:
            # the batch row index rides the window to the probe
            extra = bix.get((B, dev))
            if extra is None:
                extra = bix[(B, dev)] = torch.arange(B, dtype=torch.int32,
                                                      device=dev)
        wout = _advance(this, this_state, batch, gslot, extra, now, facts,
                        in_tabs, pre)
        trig = wout.rows
        header = _header(wout.next_wakeup, dev)
        R = _reference_rows(this.window, B)
        if empty_other:
            table = (tuple(torch.zeros(1, dtype=ev.dtype_of(t), device=dev)
                           for t in o_types),
                     torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.zeros(1, dtype=torch.bool, device=dev))
        if other.is_table or empty_other:
            o_cols, _, o_valid = table
            o_meta = None
            Q = probe.shape[1] if table_probe else o_valid.shape[0]
        else:
            o_cols, o_meta, o_valid = other_state.cols, other_state.meta, \
                None
            Q = plan.lane_k if bucket else Q_grid
        N = R * Q + (R if spec.emit_unmatched else 0)
        # aggregates read every joined row: an implicit cap is the whole
        # grid (the reference aggregates before its cut)
        cap = min(N, plan.compact_rows if plan.compact_rows is not None
                  else N if plan.aggregates else max(2 * R, 1024))
        if trig.ts.shape[0] == 0:
            # a TIMER step that expired nothing: no trigger rows
            return _no_rows(sel, cap, dev), header
        lanes = None
        if bucket:
            lanes = join_lanes(other_state.cols[-1], other_state.meta,
                               nbl_other, plan.lane_k, header[3:4])
        li, ri, onull, ovalid = k7.join_probe(
            spec, trig, o_cols, o_meta, lanes, nbl_other, cap, header[0:3],
            o_valid, probe if table_probe else None)
        # the torch projection: gathers by the index rows, the in-band null
        # of unmatched rows, the select expressions
        lil, ril = li.to(torch.int64), ri.to(torch.int64)
        this_cols = tuple(
            c[lil] if (this.key, j) in used else None
            for j, c in enumerate(trig.cols[:len(this.schema.types)]))
        other_cols = tuple(
            torch.where(onull, ev.null_value(t), c[ril])
            if (other.key, j) in used else None
            for j, (c, t) in enumerate(zip(o_cols, o_types)))
        ts, kind = trig.ts[lil], trig.kind[lil]
        env = {this.key: this_cols, other.key: other_cols, "__ts__": ts,
               "__now__": now, "__kind__": kind}
        gslot = None
        if plan.aggregates:
            tg = trig.gslot[lil].to(torch.int64)
            og = torch.full_like(tg, K_other) \
                if other.is_table or empty_other else \
                torch.where(onull, K_other,
                            other_state.gslot[ril].to(torch.int64))
            gslot = (tg * (Kr + 1) + og if this_is_left
                     else og * (Kr + 1) + tg).to(torch.int32)
        rows = Rows(ts=ts, kind=kind, valid=ovalid, seq=None, gslot=gslot,
                    cols=())
        if plan.aggregates:
            box = state[2]
            box[0], out = sel.process(box[0], rows, env)
        else:
            _, out = sel.process((), rows, env)
        return out, header

    return step


def _no_rows(sel: SelectorExec, cap: int, dev):
    """An output block of `cap` rows none of which is valid."""
    def z(d):
        return torch.zeros(cap, dtype=d, device=dev)
    return (z(torch.int64), z(torch.int32), z(torch.bool),
            tuple(z(ev.dtype_of(t)) for t in sel.out_types))


def _make_feed_only(plan: PlannedJoinQuery, side: JoinSide, is_left: bool):
    """A side that does not trigger (`unidirectional` on the other side)
    still keeps its window (reference `_make_feed_only`,
    `siddhi_tpu/core/join.py:708`): K1 and K5 / K2, no probe."""

    def step(state, batch, gslot, probe, now: int, facts, table=None,
             in_tabs=None, pre=None):
        extra = probe
        if plan.fastpath == "table":
            extra = torch.arange(batch.ts.shape[0], dtype=torch.int32,
                                 device=batch.ts.device)
        wout = _advance(side, state[0 if is_left else 1], batch, gslot,
                        extra, now, facts, in_tabs, pre)
        return None, _header(wout.next_wakeup, batch.ts.device)

    return step


# ---------------------------------------------------------------------------
# the host's key-retention mirror (equi-join fast path)
# ---------------------------------------------------------------------------

def _norm_key_cols(staged_cols, positions, dtypes) -> List[np.ndarray]:
    """Key columns normalized to the promoted compare dtype so both sides
    of `L.a == R.b` hash identically (float -0.0 folds into +0.0)."""
    out = []
    for pos, dt in zip(positions, dtypes):
        c = np.asarray(staged_cols[pos]).astype(dt, copy=False)
        if np.issubdtype(dt, np.floating):
            c = c + np.dtype(dt).type(0.0)
        out.append(np.ascontiguousarray(c))
    return out


class _TrackSide:
    """One side's retention ring: slot ids of the last `cap` admitted
    arrivals, plus per-lane (slot % nbl) occupancy counts."""

    __slots__ = ("cap", "nbl", "ring", "head", "n", "lane")

    def __init__(self, cap: int, nbl: int):
        self.cap = max(1, int(cap))
        self.nbl = max(1, int(nbl))
        self.ring = np.full(self.cap, -1, np.int64)
        self.head = 0
        self.n = 0
        self.lane = np.zeros(self.nbl, np.int64)

    def oldest(self, k: int) -> np.ndarray:
        idx = (self.head + np.arange(k)) % self.cap
        return self.ring[idx]

    def pop(self, k: int) -> None:
        self.head = (self.head + k) % self.cap
        self.n -= k

    def push(self, arr: np.ndarray) -> None:
        idx = (self.head + self.n + np.arange(arr.size)) % self.cap
        self.ring[idx] = arr
        self.n += arr.size


class JoinKeyTracker:
    """Host mirror of per-key window retention for the bucketed equi-join
    fast path (reference `siddhi_tpu/core/join.py:832`).

    Each side's ring holds the key slots of the last `cap` admitted
    arrivals, a superset of the rows alive in that side's window.  So the
    largest same-lane occupancy across both rings never under-counts the
    windows (the planned lane width covers every candidate), and a key
    slot recycles only when neither ring retains it."""

    def __init__(self, alloc: SlotAllocator, ring_caps, lane_buckets):
        self.alloc = alloc
        self.sides = (
            _TrackSide(ring_caps[0], lane_buckets[0]),
            _TrackSide(ring_caps[1], lane_buckets[1]),
        )
        self.refs = np.zeros(alloc.capacity, np.int64)

    def needed_k(self) -> int:
        return max(int(s.lane.max(initial=0)) for s in self.sides)

    def _evict(self, s: _TrackSide, incoming: int, dead: set) -> None:
        k = min(max(s.n + incoming - s.cap, 0), s.n)
        if k <= 0:
            return
        old = s.oldest(k)
        s.pop(k)
        np.subtract.at(self.refs, old, 1)
        np.subtract.at(s.lane, old % s.nbl, 1)
        for sl in np.unique(old):
            if self.refs[sl] <= 0:
                dead.add(int(sl))

    def track(self, is_left: bool, key_cols, valid) -> np.ndarray:
        """Allocate bucket slots for one batch and fold it into the side's
        ring.  Evicts before allocating so the allocator's capacity bound
        holds transiently, and purges any slot neither ring retains."""
        s = self.sides[0 if is_left else 1]
        nv = int(valid.sum())
        dead: set = set()
        if nv:
            self._evict(s, min(nv, s.cap), dead)
        slots = self.alloc.slots_for(key_cols, valid)
        ins = slots[valid].astype(np.int64)
        skipped = None
        if ins.size > s.cap:
            # a batch larger than the window: only its last `cap` rows
            # survive the step's own eviction
            skipped, ins = ins[:-s.cap], ins[-s.cap:]
        if ins.size:
            np.add.at(self.refs, ins, 1)
            np.add.at(s.lane, ins % s.nbl, 1)
            s.push(ins)
        if skipped is not None:
            dead.update(int(x) for x in np.unique(skipped))
        gone = [d for d in dead if self.refs[d] <= 0]
        if gone:
            self.alloc.purge(gone)
        return slots
