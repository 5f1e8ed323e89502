"""Incremental time-granularity aggregation (port of
`siddhi_tpu/core/aggregation.py`).

Reference behaviour (what): `define aggregation A from S select g,
avg(x) as ax ... group by g aggregate by ts every sec...year` keeps
running aggregates per (group, bucket) of each duration from seconds to
years; avg decomposes into a sum and a non-null count; reads join a
duration's buckets `within` a time range `per` a duration, or read them
on demand.  Any bucket, past or present, is updatable, so out-of-order
events need no special path; buckets older than their duration's
retention are purged on a timer.

How the port runs a send: kernel K27 `agg_base` (`kernels/agg_base.py`)
evaluates, one thread per row, the input's filters and each base
aggregation's value in f64 (the in-band null replaced by the base's
identity); the keep mask comes back to the host, which truncates the
aggregate-by times to each duration's buckets and resolves (group bits,
bucket) keys to slots per duration through the duration's
`SlotAllocator`; kernel K28 `agg_merge` (`kernels/agg_merge.py`) then
merges the send's values into every duration's slab in one launch, in
row order per slot.  The slabs are one f64 [D, n_base, capacity] tensor
on the device.  Reads gather a duration's live slots on the device
(`_local_rows`, `device_view`), in the allocator's mapping order, and
finalize the outputs.

Ported from the reference (line numbers of
`siddhi_tpu/core/aggregation.py`): `normalize_duration`,
`truncate_buckets` (:65-93), `parse_within`, `parse_per` (:95-176),
`parse_time_ms` (:234), the retention defaults, `_BaseAgg`,
`_Output.finalize` (:328-360), `_DurationStore` (:247-302),
`AggregationRuntime` with `_decompose`, `_add_base`, `_count_nonnull`
(:529-646), `process_staged` (:648-674), `on_timer`, `purge_old`
(:683-711), `_local_rows`, `snapshot_rows` and `make_schema`
(:720-774); `step` (:483-506) is K27 and `merge` (:510-525) is K28.

Not ported: `@store` backing tables and shardId reads (ROADMAP A15;
`@store` raises at plan time; `_merge_rows` merges only store rows),
custom `ns:fn` incremental aggregators (A4, raising at plan time),
snapshots, restore and incremental persistence (A13: the `stores`
property and `snapshot_delta`; the port's runtime has no snapshot yet)
and mesh placement (A14).
"""
from __future__ import annotations

import calendar
import datetime
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..query_api.expression import Constant, Variable
from . import event as ev
from .executor import CompileError, Scope, compile_expression

DURATION_MS = {
    "SECONDS": 1000,
    "MINUTES": 60_000,
    "HOURS": 3_600_000,
    "DAYS": 86_400_000,
    # MONTHS / YEARS are calendar-based
}

_DUR_ALIASES = {
    "sec": "SECONDS", "second": "SECONDS", "seconds": "SECONDS",
    "min": "MINUTES", "minute": "MINUTES", "minutes": "MINUTES",
    "hour": "HOURS", "hours": "HOURS",
    "day": "DAYS", "days": "DAYS",
    "month": "MONTHS", "months": "MONTHS",
    "year": "YEARS", "years": "YEARS",
}


def normalize_duration(name: str) -> str:
    d = _DUR_ALIASES.get(name.strip().lower())
    if d is None:
        raise CompileError(f"unknown aggregation duration {name!r}")
    return d


def truncate_buckets(ts_ms: np.ndarray, duration: str) -> np.ndarray:
    """Bucket start per timestamp (calendar months and years through a
    conversion per distinct timestamp, in UTC)."""
    if duration in DURATION_MS:
        d = DURATION_MS[duration]
        return (ts_ms // d) * d
    uniq, inv = np.unique(ts_ms, return_inverse=True)
    outs = np.empty_like(uniq)
    for i, t in enumerate(uniq):
        dt = datetime.datetime.fromtimestamp(t / 1000.0,
                                             datetime.timezone.utc)
        if duration == "MONTHS":
            dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        else:  # YEARS
            dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                            microsecond=0)
        outs[i] = int(calendar.timegm(dt.timetuple()) * 1000)
    return outs[inv]


_DATE_FIELDS = ("year", "month", "day", "hour", "minute", "second")


def _parse_date_string(s: str) -> Tuple[int, Optional[str]]:
    """`yyyy-MM-dd HH:mm:ss` (components optional from the right, or `**`
    wildcards) -> (epoch ms of its start, the first wildcard field or
    None)."""
    s = s.strip()
    m = re.match(
        r"^(\d{4}|\*\*)(?:-(\d{1,2}|\*\*))?(?:-(\d{1,2}|\*\*))?"
        r"(?:[ T](\d{1,2}|\*\*))?(?::(\d{1,2}|\*\*))?(?::(\d{1,2}|\*\*))?",
        s)
    if not m or m.group(1) == "**":
        raise CompileError(f"cannot parse within-time {s!r}")
    vals = []
    wildcard = None
    for i, g in enumerate(m.groups()):
        if g is None or g == "**":
            if wildcard is None:
                wildcard = _DATE_FIELDS[i]
            vals.append(None)
        else:
            if wildcard is not None:
                raise CompileError(f"non-wildcard after wildcard in {s!r}")
            vals.append(int(g))
    dt = datetime.datetime(vals[0], vals[1] or 1, vals[2] or 1, vals[3] or 0,
                           vals[4] or 0, vals[5] or 0)
    return int(calendar.timegm(dt.timetuple()) * 1000), wildcard


def _advance(dt_ms: int, field: str) -> int:
    dt = datetime.datetime.fromtimestamp(dt_ms / 1000.0,
                                         datetime.timezone.utc)
    if field == "year":
        dt = dt.replace(year=dt.year + 1)
    elif field == "month":
        dt = dt.replace(year=dt.year + (dt.month == 12),
                        month=dt.month % 12 + 1)
    else:
        delta = {"day": 86_400, "hour": 3_600, "minute": 60, "second": 1}
        return dt_ms + delta[field] * 1000
    return int(calendar.timegm(dt.timetuple()) * 1000)


def _bound_of(expr) -> Tuple[int, Optional[str]]:
    if isinstance(expr, Constant):
        if expr.type in ("LONG", "INT"):
            return int(expr.value), None
        if expr.type == "STRING":
            return _parse_date_string(str(expr.value))
    raise CompileError(
        "within bounds must be time-string or epoch-ms constants")


def parse_within(within) -> Tuple[int, int]:
    """within '2020-01-01 ...' [, '2020-02-01 ...'] -> [start, end) ms."""
    if within is None:
        raise CompileError("aggregation reads need a `within` clause")
    if isinstance(within, tuple):
        s, _ = _bound_of(within[0])
        e, _ = _bound_of(within[1])
        return s, e
    s, wildcard = _bound_of(within)
    if wildcard is None:
        # one full timestamp: that instant's smallest covered unit
        return s, _advance(s, "second")
    return s, _advance(s, {"month": "year", "day": "month", "hour": "day",
                           "minute": "hour", "second": "minute"}[wildcard])


def parse_per(per) -> str:
    if per is None:
        raise CompileError("aggregation reads need a `per` duration")
    if isinstance(per, Constant) and per.type == "STRING":
        return normalize_duration(str(per.value))
    if isinstance(per, Variable):
        return normalize_duration(per.attribute_name)
    raise CompileError("per must be a duration name")


# base modes: what K27 computes for a base (kernels/agg_base.py)
ONE, NONNULL, VALUE = range(3)


class _BaseAgg:
    """One base (decomposed) aggregation: its merge kind ('sum', 'count',
    'min', 'max'), its argument (a compiled expression, None for
    `count()`) and its mode: ONE (count() adds 1.0), NONNULL (a non-null
    count adds 1.0 for each non-null argument) or VALUE (the argument in
    f64, a null giving the identity)."""

    def __init__(self, kind: str, src, mode: int, expr=None):
        self.kind = kind
        self.src = src
        self.mode = mode
        self.expr = expr    # the argument's query_api expression

    def identity(self) -> float:
        if self.kind == "min":
            return np.inf
        if self.kind == "max":
            return -np.inf
        return 0.0


# retention defaults (reference IncrementalDataPurger.java:307); None keeps
# a duration's buckets forever
_DEFAULT_RETENTION_MS = {
    "SECONDS": 120_000,
    "MINUTES": 24 * 3_600_000,
    "HOURS": 30 * 86_400_000,
    "DAYS": 366 * 86_400_000,
    "MONTHS": None,
    "YEARS": None,
}

_TIME_UNITS_MS = {
    "ms": 1, "millisec": 1, "millisecond": 1, "milliseconds": 1,
    "sec": 1000, "second": 1000, "seconds": 1000,
    "week": 7 * 86_400_000, "weeks": 7 * 86_400_000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "month": 30 * 86_400_000, "months": 30 * 86_400_000,
    "year": 365 * 86_400_000, "years": 365 * 86_400_000,
}


def parse_time_ms(s: str) -> Optional[int]:
    """'120 sec' / '24 hours' / 'all' -> milliseconds (None: unbounded)."""
    s = str(s).strip().lower()
    if s == "all":
        return None
    parts = s.split()
    if len(parts) == 2 and parts[1] in _TIME_UNITS_MS:
        return int(float(parts[0]) * _TIME_UNITS_MS[parts[1]])
    if s.isdigit():
        return int(s)
    raise CompileError(f"cannot parse time value {s!r}")


class _DurationStore:
    """One duration's buckets: the [n_base, capacity] slab of running base
    values (a view into the aggregation's [D, n_base, capacity] tensor)
    and the allocator resolving (group bits..., bucket) keys to slots."""

    def __init__(self, agg_name: str, dur: str, slab: torch.Tensor,
                 identities: torch.Tensor, capacity: int):
        from .keyslots import SlotAllocator
        self.dur = dur
        self.alloc = SlotAllocator(capacity, f"{agg_name}:{dur}")
        self.slab = slab
        self.identities = identities                  # [n_base] f64

    def decode_keys(self) -> Tuple[np.ndarray, np.ndarray]:
        """(slots [n], key words [n, ng + 1] int64) of the live slots, in
        the allocator's mapping order (ascending slot, as its `snapshot()`
        lists them), read from its arrays without building the mapping."""
        a = self.alloc
        with a._lock:
            if a._arena is None:
                return np.zeros((0,), np.int64), np.zeros((0, 1), np.int64)
            slots = np.nonzero(a._used)[0].astype(np.int64)
            words = np.ascontiguousarray(a._arena[slots]).view(np.int64)
        if not len(slots):
            return slots, np.zeros((0, 1), np.int64)
        return slots, words.reshape(len(slots), -1)

    def reset_slots(self, slots: np.ndarray) -> None:
        if not len(slots):
            return
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(
            self.slab.device)
        self.slab[:, idx] = self.identities[:, None]


def _null_of(attr_type: str) -> float:
    """The output type's in-band null as float64."""
    return float(ev.null_value(attr_type))


class _Output:
    """One declared output attribute and how it finalizes from the base
    values."""

    def __init__(self, name: str, attr_type: str, kind: str,
                 base_idx: Tuple[int, ...], group_pos: int = -1):
        self.name = name
        self.type = attr_type
        self.kind = kind  # 'group' | 'sum' | 'count' | 'min' | 'max' | 'avg'
        self.base_idx = base_idx
        self.group_pos = group_pos

    def finalize(self, base: torch.Tensor) -> torch.Tensor:
        """base: f64 [n_rows, n_base] -> the f64 [n_rows] output column.  A
        bucket whose inputs were all null gives the output type's null."""
        nullv = torch.tensor(_null_of(self.type), dtype=torch.float64,
                             device=base.device)
        if self.kind == "avg":
            s, c = base[:, self.base_idx[0]], base[:, self.base_idx[1]]
            return torch.where(c > 0, s / torch.clamp(c, min=1), nullv)
        col = base[:, self.base_idx[0]]
        if self.kind in ("sum", "min", "max") and len(self.base_idx) > 1:
            # the paired non-null count decides emptiness, so legitimate
            # +-inf data is not read as an empty bucket
            return torch.where(base[:, self.base_idx[1]] > 0, col, nullv)
        return col


class AggregationRuntime:
    """Host and device runtime of one `define aggregation`."""

    def __init__(self, adef, app):
        from ..kernels.agg_base import BaseSpec
        from ..kernels.filter_bytecode import AND, compile_filter
        from ..query_api.query import Filter
        self.definition = adef
        self.app = app
        self.name = f"aggregation {adef.id}"
        self.device = app.device
        cuda = self.device.type == "cuda"
        sis = adef.basic_single_input_stream
        self.input_stream_id = sis.unique_stream_id
        schema = app.schemas.get(self.input_stream_id)
        if schema is None:
            raise CompileError(
                f"aggregation {adef.id!r}: undefined stream "
                f"{self.input_stream_id!r}")
        self.in_schema = schema
        self._qlock = threading.RLock()

        scope = Scope(self.device)
        scope.interner = app.interner
        scope.add_source(self.input_stream_id, schema,
                         alias=sis.stream_reference_id)
        self._scope = scope

        # filters on the input stream (K27 evaluates them as bytecode)
        self._filters = []
        fcode = [] if cuda else None
        for h in sis.stream_handlers:
            if not isinstance(h, Filter):
                raise CompileError("aggregation input supports filters only")
            c = compile_expression(h.expression, scope)
            if c.type != "BOOL":
                raise CompileError("aggregation filter must be boolean")
            self._filters.append(c)
            if fcode is not None:
                fcode += compile_filter(h.expression, scope,
                                        self.input_stream_id, {}) + \
                    ([AND] if fcode else [])

        self.group_names = [v.attribute_name
                            for v in (adef.selector.group_by_list or [])]
        self.group_positions = [schema.position(n) for n in self.group_names]
        self.group_types = [schema.types[p] for p in self.group_positions]
        self.ts_pos = -1
        if adef.aggregate_attribute is not None:
            self.ts_pos = schema.position(
                adef.aggregate_attribute.attribute_name)

        self.base: List[_BaseAgg] = []
        self.outputs: List[_Output] = []
        self._arg_cache: Dict[str, object] = {}
        self._decompose(adef.selector, scope)

        self.durations = [normalize_duration(d) for d in adef.time_periods] \
            or ["SECONDS"]
        self._identities = np.array([b.identity() for b in self.base],
                                    np.float64)
        cap_ann = adef.get_annotation("capacity")
        self.bucket_capacity = int(cap_ann.element("buckets")) \
            if cap_ann is not None and cap_ann.element("buckets") else 1 << 16
        ident = torch.from_numpy(self._identities).to(self.device)
        self.slabs = ident[None, :, None].repeat(
            len(self.durations), 1, self.bucket_capacity).contiguous()
        self._dstores: Dict[str, _DurationStore] = {
            d: _DurationStore(adef.id, d, self.slabs[i], ident,
                              self.bucket_capacity)
            for i, d in enumerate(self.durations)}

        # retention per duration, overridable with
        # @retentionPeriod(sec='120 sec', min='24 hours', ..., or 'all')
        self.retention_ms: Dict[str, Optional[int]] = {
            d: _DEFAULT_RETENTION_MS[d] for d in self.durations}
        ret_ann = adef.get_annotation("retentionPeriod")
        if ret_ann is not None:
            alias = {"sec": "SECONDS", "min": "MINUTES", "hours": "HOURS",
                     "days": "DAYS", "months": "MONTHS", "years": "YEARS"}
            for k, dur in alias.items():
                v = ret_ann.element(k)
                if v is not None and dur in self.retention_ms:
                    self.retention_ms[dur] = parse_time_ms(v)
        # @purge(enable='true'|'false', interval='10 sec')
        purge_ann = adef.get_annotation("purge")
        self.purge_enabled = True
        self.purge_interval_ms = 15_000
        if purge_ann is not None:
            if purge_ann.element("enable") is not None:
                self.purge_enabled = str(
                    purge_ann.element("enable")).lower() == "true"
            if purge_ann.element("interval") is not None:
                iv = parse_time_ms(purge_ann.element("interval"))
                if not iv or iv <= 0:
                    raise CompileError(
                        f"@purge interval must be a positive time value, "
                        f"got {purge_ann.element('interval')!r}")
                self.purge_interval_ms = iv

        self.spec = BaseSpec.build(schema.types, self.input_stream_id,
                                   self._filters, fcode, self.base, scope)
        self.kinds = [b.kind for b in self.base]

    # -- construction ---------------------------------------------------------
    def _decompose(self, selector, scope: Scope) -> None:
        from ..query_api.expression import AttributeFunction as Function
        from .selector import _expr_fingerprint
        sel_list = selector.selection_list
        if not sel_list:
            raise CompileError("aggregation needs an explicit select list")
        for oa in sel_list:
            e = oa.expression
            name = oa.rename or (
                e.attribute_name if isinstance(e, Variable) else None)
            if name is None:
                raise CompileError("aggregation outputs need names (use `as`)")
            if isinstance(e, Variable):
                if e.attribute_name not in self.group_names:
                    raise CompileError(
                        f"aggregation projection {e.attribute_name!r} must "
                        f"be a group-by attribute or an aggregate")
                gpos = self.group_names.index(e.attribute_name)
                self.outputs.append(_Output(
                    name, self.group_types[gpos], "group", (), gpos))
                continue
            if not isinstance(e, Function):
                raise CompileError(
                    "aggregation selections must be group attrs or "
                    "sum/count/min/max/avg aggregates")
            if e.namespace:
                raise CompileError(
                    f"custom incremental aggregator {e.namespace}:{e.name} "
                    f"is not yet ported (ROADMAP A4)")
            fn = e.name
            if fn == "count":
                i = self._add_base("count", None, ONE)
                self.outputs.append(_Output(name, "LONG", "count", (i,)))
                continue
            if fn not in ("sum", "avg", "min", "max"):
                raise CompileError(
                    f"aggregator {fn!r} not supported in incremental "
                    f"aggregations (reference supports "
                    f"sum/count/avg/min/max/distinctCount)")
            if len(e.parameters) != 1:
                raise CompileError(f"{fn}() takes one argument")
            # one compiled argument per distinct expression, so avg / sum /
            # min / max of one expression share their slab rows
            akey = _expr_fingerprint(e.parameters[0])
            c = self._arg_cache.get(akey)
            if c is None:
                c = compile_expression(e.parameters[0], scope)
                self._arg_cache[akey] = c
            arg = e.parameters[0]
            if c.type not in ("INT", "LONG", "FLOAT", "DOUBLE"):
                raise CompileError(f"{fn}() needs a numeric argument")
            is_int = c.type in ("INT", "LONG")
            if fn == "sum":
                i = self._add_base("sum", c, VALUE, arg)
                ci = self._add_base("count", c, NONNULL, arg)
                self.outputs.append(_Output(
                    name, "LONG" if is_int else "DOUBLE", "sum", (i, ci)))
            elif fn in ("min", "max"):
                i = self._add_base(fn, c, VALUE, arg)
                ci = self._add_base("count", c, NONNULL, arg)
                self.outputs.append(_Output(name, c.type, fn, (i, ci)))
            else:  # avg: sum + non-null count
                si = self._add_base("sum", c, VALUE, arg)
                ci = self._add_base("count", c, NONNULL, arg)
                self.outputs.append(_Output(name, "DOUBLE", "avg", (si, ci)))

    def _add_base(self, kind: str, src, mode: int, expr=None) -> int:
        """The base of (kind, argument, mode), shared when it exists (avg
        and sum of one expression share the sum and the count)."""
        for i, b in enumerate(self.base):
            if b.kind == kind and b.src is src and b.mode == mode:
                return i
        self.base.append(_BaseAgg(kind, src, mode, expr))
        return len(self.base) - 1

    # -- ingestion ------------------------------------------------------------
    def process_staged(self, staged: ev.StagedBatch, now: int) -> None:
        """Merge a batch into every duration's slab (K27, the host's slot
        resolution per duration, K28)."""
        from ..kernels.agg_base import agg_base
        from ..kernels.agg_merge import agg_merge
        batch = staged.to_device(self.in_schema, self.device)
        keep_d, vals = agg_base(self.spec, batch, now)
        keep = keep_d.cpu().numpy()
        if not keep.any():
            return
        ts = (staged.cols[self.ts_pos].astype(np.int64)
              if self.ts_pos >= 0 else staged.ts)
        gcols = [self._bits(staged.cols[p]) for p in self.group_positions]
        with self._qlock:
            slots = np.empty((len(self.durations), keep.shape[0]), np.int32)
            for d, dur in enumerate(self.durations):
                buckets = truncate_buckets(ts, dur)
                slots[d] = self._dstores[dur].alloc.slots_for(
                    gcols + [buckets], valid=keep)
            agg_merge(self.slabs, torch.from_numpy(slots).to(self.device),
                      vals, self.kinds)

    @staticmethod
    def _bits(col: np.ndarray) -> np.ndarray:
        """Lossless int64 encoding of a key column (floats by bit view)."""
        if col.dtype in (np.float32, np.float64):
            return col.astype(np.float64).view(np.int64)
        return col.astype(np.int64)

    # -- purging (reference IncrementalDataPurger.java:307) -------------------
    def on_timer(self, now: int) -> None:
        if self.purge_enabled:
            self.purge_old(now)
        self.app._scheduler.notify_at(now + self.purge_interval_ms, self)

    def purge_old(self, now: int) -> None:
        """Free the buckets past their duration's retention; their slots
        recycle through the allocator's free list."""
        with self._qlock:
            for dur in self.durations:
                ret = self.retention_ms.get(dur)
                if ret is None:
                    continue
                ds = self._dstores[dur]
                slots, words = ds.decode_keys()
                if not len(slots):
                    continue
                old = words[:, -1] < (now - ret)
                if old.any():
                    doomed = slots[old]
                    ds.alloc.purge(doomed.tolist())
                    ds.reset_slots(doomed)

    # -- reads ----------------------------------------------------------------
    @property
    def out_names(self) -> List[str]:
        return ["AGG_TIMESTAMP"] + [o.name for o in self.outputs]

    @property
    def out_types(self) -> List[str]:
        return ["LONG"] + [o.type for o in self.outputs]

    def make_schema(self) -> ev.Schema:
        from ..query_api.definition import StreamDefinition
        sdef = StreamDefinition(self.definition.id)
        for n, t in zip(self.out_names, self.out_types):
            sdef.attribute(n, t)
        return ev.Schema(sdef, self.app.interner)

    def _local_rows(self, per: str, within=None
                    ) -> Tuple[np.ndarray, torch.Tensor]:
        """(keys [n, ng + 1] int64, group bits then bucket; base f64
        [n, n_base] on the device) of the duration's live buckets within
        [start, end), in mapping order: only those slots move."""
        ds = self._dstores[per]
        with self._qlock:
            slots, words = ds.decode_keys()
            if within is not None and len(slots):
                s, e = within
                m = (words[:, -1] >= s) & (words[:, -1] < e)
                slots, words = slots[m], words[m]
            if not len(slots):
                return (np.zeros((0, len(self.group_positions) + 1),
                                 np.int64),
                        torch.zeros((0, len(self.base)), dtype=torch.float64,
                                    device=self.device))
            idx = torch.from_numpy(slots).to(self.device)
            return words, ds.slab[:, idx].T

    def _duration(self, per: str) -> str:
        per = normalize_duration(per)
        if per not in self._dstores:
            raise CompileError(
                f"aggregation {self.definition.id!r} has no duration "
                f"{per!r}; declared: {self.durations}")
        return per

    def device_rows(self, per: str, within: Optional[Tuple[int, int]]
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(bucket ts [n], output columns in their device dtypes) of
        duration `per` within [start, end), on the device."""
        keys, base = self._local_rows(self._duration(per), within)
        dev = self.device
        kt = torch.from_numpy(keys).to(dev)
        ts = kt[:, -1].contiguous() if len(keys) else \
            torch.zeros((0,), dtype=torch.int64, device=dev)
        cols: List[torch.Tensor] = [ts]
        for o in self.outputs:
            if o.kind == "group":
                bits = kt[:, o.group_pos].contiguous()
                if o.type in ("FLOAT", "DOUBLE"):
                    cols.append(bits.view(torch.float64).to(
                        ev.dtype_of(o.type)))
                else:
                    cols.append(bits.to(ev.dtype_of(o.type)))
            else:
                # numpy's astype: an integer truncates toward zero
                cols.append(o.finalize(base).to(ev.dtype_of(o.type)))
        return ts, cols

    def snapshot_rows(self, per: str, within: Optional[Tuple[int, int]]
                      ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(bucket_ts [n], out_cols) of duration `per` within [start, end)
        as numpy (reference `snapshot_rows`, :739)."""
        ts, cols = self.device_rows(per, within)
        return ts.cpu().numpy(), [c.cpu().numpy() for c in cols]

    def device_view(self, per: str, within):
        """The join's table view of the buckets (reference
        `_aggregation_view`, `siddhi_tpu/core/runtime.py:1356`): the output
        columns padded to the staging bucket size, the bucket ts and the
        valid flags, on the device."""
        ts, cols = self.device_rows(per, within)
        n = ts.shape[0]
        cap = ev.bucket_size(max(n, 1))

        def pad(c):
            out = torch.zeros(cap, dtype=c.dtype, device=c.device)
            out[:n] = c
            return out
        valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        valid[:n] = True
        return tuple(pad(c) for c in cols), pad(ts), valid
