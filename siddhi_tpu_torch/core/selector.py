"""Query selector: projection, group-by aggregation and having (port of
`siddhi_tpu/core/selector.py`).

Rows arrive seq-ordered with a group slot per row (resolved on the host,
`core/keyslots.py`).  Running aggregate values -- the reference's "value
after this event's update" -- come from segmented scans over signed
contributions (+1 CURRENT, -1 EXPIRED) within (group slot, reset epoch)
segments, with the carry state injected at segment heads: kernel K4
(`kernels/group_agg.py`).  Contributions, the aggregators' result
functions (avg's divide, null rules), having and the projection stay
compiled torch expressions over the scan results.

Ported aggregators: sum, avg, count, min, max, minForever, maxForever,
stdDev, and, or, distinctCount and unionSet (whose SET value only
`sizeOfSet` reads); order by / limit / offset (kernel K13,
`kernels/order_limit.py`).  Extension aggregators raise `CompileError`.

distinctCount (reference `_distinct_spec`,
`siddhi_tpu/core/selector.py:294`): each (group, value) pair of a row has
a pair slot, resolved on the host (`__pslot__<j>` in the env).  A refcount
column scans over the pair slots (K4 over 8K slots), and its 0 <-> 1
transitions feed the distinct count as +1 / -1 contributions to a second
scan over the group slots (K4 again); the refcounts' per-row results stay
on the device between the two passes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Set, Tuple

import torch

from ..exceptions import CompileError
from ..query_api.expression import (
    Add,
    And,
    AttributeFunction,
    Compare,
    Constant,
    Divide,
    Expression,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    Variable,
    walk,
)
from ..query_api.query import OutputAttribute, Selector
from . import event as ev
from .executor import AGGREGATOR_NAMES, CompiledExpr, Scope, \
    compile_expression
from .window import Rows

_INT_RANGE = {torch.int32: (-(2 ** 31), 2 ** 31 - 1),
              torch.int64: (-(2 ** 63), 2 ** 63 - 1)}


@dataclasses.dataclass
class _AggSpec:
    """One physical accumulator column (a scan over signed contributions)."""

    key: str                      # dedupe key
    op: int                       # group_agg.OP_ADD / OP_MIN / OP_MAX
    init: Any                     # identity scalar
    dtype: torch.dtype
    # vals_fn(env, sign) -> [B] contribution per row
    vals_fn: Callable
    # a distinctCount refcount: scans over pair slots of source j, K_override
    # of them
    slot_src: Any = None
    K_override: Any = None


def _full(x, v, dtype):
    return torch.full(x.shape, v, dtype=dtype, device=x.device)


class AggregatorBank:
    """All aggregator calls of a query as scan columns plus per-slot carry
    state [K]."""

    # True when every (slot, epoch) segment of the rows is one run (keyed
    # windows grouped by the partition key alone): group_agg's run mode
    runs = False

    def __init__(self, group_slots: int, device):
        self.K = group_slots
        self.device = device
        self.specs: List[_AggSpec] = []
        self._index: Dict[str, int] = {}
        # distinctCount / unionSet arguments, one pair-slot source each
        self.pair_sources: List[Variable] = []

    def _add(self, spec: _AggSpec) -> int:
        if spec.key in self._index:
            return self._index[spec.key]
        self._index[spec.key] = len(self.specs)
        self.specs.append(spec)
        return len(self.specs) - 1

    def init_state(self):
        return tuple(torch.full((s.K_override or self.K,), s.init,
                                dtype=s.dtype, device=self.device)
                     for s in self.specs)

    # -- aggregator compilation ----------------------------------------------
    def compile_call(self, fn_expr: AttributeFunction, scope: Scope,
                     expr_key: str) -> Tuple[str, Callable]:
        """Returns (result_type, result_fn(scan_results) -> column)."""
        from ..kernels.group_agg import OP_ADD, OP_MAX, OP_MIN
        name = fn_expr.name
        if fn_expr.namespace or name not in AGGREGATOR_NAMES:
            full = f"{fn_expr.namespace}:{name}" if fn_expr.namespace \
                else name
            raise CompileError(f"aggregator {full!r} is not yet ported "
                               f"(ROADMAP B14)")
        if name == "distinctCount":
            orig = fn_expr.parameters[0]
            if not isinstance(orig, Variable):
                raise CompileError(
                    "distinctCount needs a plain attribute argument")
            i_dc = self._distinct_spec(orig, expr_key)
            return "LONG", (lambda res, _i=i_dc: res[_i])
        if name == "unionSet":
            # sizeOfSet(unionSet(createSet(x))) is the distinct count: the
            # SET pseudo-value carries it (reference :149-160)
            inner = fn_expr.parameters[0]
            if not (isinstance(inner, AttributeFunction) and
                    not inner.namespace and inner.name == "createSet" and
                    len(inner.parameters) == 1 and
                    isinstance(inner.parameters[0], Variable)):
                raise CompileError(
                    "unionSet expects createSet(<attribute>) in this build")
            i_dc = self._distinct_spec(inner.parameters[0], expr_key)
            return "SET", (lambda res, _i=i_dc: res[_i])
        args = [compile_expression(p, scope) for p in fn_expr.parameters]
        i64, f32 = torch.int64, torch.float32

        def fvals(c: CompiledExpr, dtype):
            # null arguments contribute nothing (reference: every
            # aggregator executor skips null inputs)
            def vals(env, sign):
                v = c.fn(env)
                contrib = v.to(dtype) * sign.to(dtype)
                return torch.where(ev.null_mask(v, c.type),
                                   _full(contrib, 0, dtype), contrib)
            return vals

        def fcount_nonnull(c: CompiledExpr):
            def vals(env, sign):
                v = c.fn(env)
                return torch.where(ev.null_mask(v, c.type),
                                   _full(sign, 0, i64), sign.to(i64))
            return vals

        if name in ("sum", "avg", "stdDev"):
            (a,) = args
            out_t = "LONG" if (name == "sum" and a.type in ("INT", "LONG")) \
                else "DOUBLE"
            acc = ev.dtype_of(out_t)
            i_sum = self._add(_AggSpec(f"sum:{expr_key}", OP_ADD, 0, acc,
                                       fvals(a, acc)))
            i_cnt = self._add(_AggSpec(f"cnt:{expr_key}", OP_ADD, 0, i64,
                                       fcount_nonnull(a)))
            if name == "sum":
                # null until the first non-null value arrives (and again
                # when the window retracts every contribution)
                def fsum(res, _s=i_sum, _c=i_cnt, _t=out_t):
                    return torch.where(res[_c] != 0, res[_s],
                                       _full(res[_s], ev.null_value(_t),
                                             res[_s].dtype))
                return out_t, fsum
            if name == "avg":
                def favg(res, _s=i_sum, _c=i_cnt):
                    c = res[_c]
                    return torch.where(
                        c != 0, res[_s].to(f32) / c.to(f32),
                        _full(c, float("nan"), f32))
                return "DOUBLE", favg

            def sqvals(env, sign, _a=a):
                v0 = _a.fn(env)
                v = v0.to(f32)
                return torch.where(ev.null_mask(v0, _a.type),
                                   _full(v, 0.0, f32), v * v * sign.to(f32))
            i_sq = self._add(_AggSpec(f"sumsq:{expr_key}", OP_ADD, 0, f32,
                                      sqvals))

            def fstd(res, _s=i_sum, _c=i_cnt, _q=i_sq):
                c = torch.clamp(res[_c], min=1).to(f32)
                m = res[_s].to(f32) / c
                var = torch.clamp(res[_q] / c - m * m, min=0.0)
                return torch.where(res[_c] != 0, torch.sqrt(var),
                                   _full(c, float("nan"), f32))
            return "DOUBLE", fstd

        if name == "count":
            i_cnt = self._add(_AggSpec(
                f"count:{expr_key}", OP_ADD, 0, i64,
                lambda env, sign: sign.to(i64)))
            return "LONG", (lambda res, _i=i_cnt: res[_i])

        if name in ("min", "max", "minForever", "maxForever"):
            (a,) = args
            if a.type not in ("INT", "LONG", "FLOAT", "DOUBLE"):
                raise CompileError(f"{name}() needs a numeric argument")
            dtype = ev.dtype_of(a.type)
            is_min = name.startswith("min")
            if dtype == f32:
                ident = float("inf") if is_min else float("-inf")
            else:
                lo, hi = _INT_RANGE[dtype]
                ident = hi if is_min else lo

            def vals(env, sign, _a=a, _id=ident, _d=dtype):
                v0 = _a.fn(env)
                v = v0.to(_d)
                # only CURRENT rows contribute; null inputs contribute the
                # identity (reference: MinMax aggregators skip nulls)
                hit = torch.logical_and(
                    sign > 0, torch.logical_not(ev.null_mask(v0, _a.type)))
                return torch.where(hit, v, _full(v, _id, _d))
            i = self._add(_AggSpec(f"{name}:{expr_key}",
                                   OP_MIN if is_min else OP_MAX, ident,
                                   dtype, vals))

            def seen_vals(env, sign, _a=a):
                v = _a.fn(env)
                hit = torch.logical_and(
                    sign > 0, torch.logical_not(ev.null_mask(v, _a.type)))
                return hit.to(i64)
            i_seen = self._add(_AggSpec(f"seen:{expr_key}", OP_ADD, 0, i64,
                                        seen_vals))

            def fminmax(res, _i=i, _s=i_seen, _t=a.type, _d=dtype):
                return torch.where(res[_s] > 0, res[_i],
                                   _full(res[_i], ev.null_value(_t), _d))
            return a.type, fminmax

        if name in ("and", "or"):
            (a,) = args
            want = name == "or"   # or: count trues; and: count falses

            def bvals(env, sign, _a=a, _w=want):
                v = _a.fn(env).to(torch.bool)
                hit = v if _w else torch.logical_not(v)
                return torch.where(hit, sign.to(i64), _full(sign, 0, i64))
            i = self._add(_AggSpec(f"{name}:{expr_key}", OP_ADD, 0, i64,
                                   bvals))
            if want:
                return "BOOL", (lambda res, _i=i: res[_i] > 0)
            return "BOOL", (lambda res, _i=i: res[_i] == 0)

        raise CompileError(f"aggregator {name!r} is not yet ported "
                           f"(ROADMAP B14)")

    def _distinct_spec(self, var: Variable, expr_key: str) -> int:
        """Exact distinct count (reference: DistinctCountAttribute-
        AggregatorExecutor's per-value refcount map): a refcount column over
        the pair slots of `var`, then a count column fed by its 0 <-> 1
        transitions.  The refcount spec comes first, so its results exist
        when the count's contributions read them."""
        from ..kernels.group_agg import OP_ADD
        i64 = torch.int64
        j = len(self.pair_sources)
        self.pair_sources.append(var)
        i_ref = self._add(_AggSpec(
            f"ref:{expr_key}", OP_ADD, 0, i64,
            lambda env, sign: sign.to(i64), slot_src=j,
            K_override=self.K * 8))

        def dvals(env, sign, _r=i_ref):
            r = env["__scanres__"][_r]
            up = torch.logical_and(sign > 0, r == 1)
            down = torch.logical_and(sign < 0, r == 0)
            return up.to(i64) - down.to(i64)
        return self._add(_AggSpec(f"dc:{expr_key}", OP_ADD, 0, i64, dvals))

    # -- runtime -------------------------------------------------------------
    def process(self, state, rows: Rows, env) -> Tuple[Any, Tuple]:
        """Returns (new_state, per-row running values per spec): the
        refcount specs first, one K4 pass per pair-slot source, then one
        pass of the others over the group slots."""
        if not self.specs:
            return state, ()
        cur = torch.logical_and(rows.valid, rows.kind == ev.CURRENT)
        exp = torch.logical_and(rows.valid, rows.kind == ev.EXPIRED)
        sign = cur.to(torch.int32) - exp.to(torch.int32)
        env = dict(env)
        results = [None] * len(self.specs)
        env["__scanres__"] = results
        new_state = list(state)
        for j in range(len(self.pair_sources)):
            self._scan([i for i, s in enumerate(self.specs)
                        if s.slot_src == j], state, new_state, results, env,
                       sign, rows, env[f"__pslot__{j}"], False, True)
        self._scan([i for i, s in enumerate(self.specs)
                    if s.slot_src is None], state, new_state, results, env,
                   sign, rows, rows.gslot, self.runs)
        return tuple(new_state), tuple(results)

    def _scan(self, idx, state, new_state, results, env, sign, rows, slots,
              runs, pair=False) -> None:
        """One K4 pass of the specs at `idx` over `slots`."""
        from ..kernels.group_agg import ScanSpec, group_agg_scan
        if not idx:
            return
        vals = []
        for i in idx:
            s = self.specs[i]
            v = s.vals_fn(env, sign)
            vals.append(torch.where(sign != 0, v.to(s.dtype),
                                    _full(v, s.init, s.dtype)))
        specs = [ScanSpec(self.specs[i].op, self.specs[i].dtype,
                          self.specs[i].init) for i in idx]
        ns, res = group_agg_scan(specs, [state[i] for i in idx], vals, sign,
                                 rows.kind, rows.valid,
                                 slots.to(torch.int32).contiguous(),
                                 runs=runs, pair=pair)
        for i, a, r in zip(idx, ns, res):
            new_state[i], results[i] = a, r


# ---------------------------------------------------------------------------
# Selector executor
# ---------------------------------------------------------------------------

def _rewrite_aggregators(expr: Expression, found: List[AttributeFunction],
                         prefix: str) -> Expression:
    """Replace aggregator calls with bound pseudo-variables __agg<i>."""
    if isinstance(expr, AttributeFunction):
        if not expr.namespace and expr.name in AGGREGATOR_NAMES:
            found.append(expr)
            return Variable(f"{prefix}{len(found) - 1}")
        return AttributeFunction(expr.namespace, expr.name, [
            _rewrite_aggregators(p, found, prefix) for p in expr.parameters])
    if isinstance(expr, (Add, Subtract, Multiply, Divide, Mod)):
        return type(expr)(_rewrite_aggregators(expr.left, found, prefix),
                          _rewrite_aggregators(expr.right, found, prefix))
    if isinstance(expr, Compare):
        return Compare(_rewrite_aggregators(expr.left, found, prefix),
                       expr.operator,
                       _rewrite_aggregators(expr.right, found, prefix))
    if isinstance(expr, (And, Or)):
        return type(expr)(_rewrite_aggregators(expr.left, found, prefix),
                          _rewrite_aggregators(expr.right, found, prefix))
    if isinstance(expr, Not):
        return Not(_rewrite_aggregators(expr.expression, found, prefix))
    if isinstance(expr, IsNull) and expr.expression is not None:
        return IsNull(_rewrite_aggregators(expr.expression, found, prefix))
    return expr


def _substitute_aliases(e: Expression, alias_map, scope) -> Expression:
    """Replace unqualified Variables naming a select alias with the aliased
    expression, unless the name also resolves to a real input attribute
    (input attributes win)."""
    if isinstance(e, Variable) and e.stream_id is None and \
            e.attribute_name in alias_map:
        try:
            scope.resolve(e)
            return e
        except CompileError:
            return alias_map[e.attribute_name]
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, Expression):
            setattr(e, f, _substitute_aliases(v, alias_map, scope))
        elif isinstance(v, list):
            setattr(e, f, [
                _substitute_aliases(x, alias_map, scope)
                if isinstance(x, Expression) else x for x in v])
    return e


def _expr_fingerprint(e: Expression) -> str:
    if isinstance(e, Variable):
        return f"v:{e.stream_id}.{e.attribute_name}[{e.stream_index}]"
    if isinstance(e, Constant):
        return f"c:{e.value}"
    if isinstance(e, AttributeFunction):
        inner = ",".join(_expr_fingerprint(p) for p in e.parameters)
        return f"f:{e.namespace}:{e.name}({inner})"
    if isinstance(e, Compare):
        return (f"({_expr_fingerprint(e.left)}{e.operator}"
                f"{_expr_fingerprint(e.right)})")
    if isinstance(e, (Add, Subtract, Multiply, Divide, Mod, And, Or)):
        return (f"({_expr_fingerprint(e.left)}{type(e).__name__}"
                f"{_expr_fingerprint(e.right)})")
    if isinstance(e, Not):
        return f"!({_expr_fingerprint(e.expression)})"
    return repr(e)


def _projection_scope(names, types, interner, device) -> Scope:
    """Scope over the projected output columns (for order by)."""
    from ..query_api.definition import StreamDefinition
    d = StreamDefinition("__out__")
    for n, t in zip(names, types):
        d.attribute(n, t)
    s = Scope(device)
    s.interner = interner
    s.add_source("__out__", ev.Schema(d, interner))
    return s


def _compile_with_pseudo(expr: Expression, scope: Scope,
                         agg_results: List[Tuple[str, Callable]]
                         ) -> CompiledExpr:
    """Compile an expression whose __agg<i> variables read the scan
    results from env['__aggscan__']."""
    for i, (t, fn) in enumerate(agg_results):
        scope.bind(f"__agg{i}", CompiledExpr(
            fn=lambda env, _f=fn: _f(env["__aggscan__"]), type=t))
    return compile_expression(expr, scope)


class SelectorExec:
    """Compiled select clause over ordered Rows."""

    def __init__(self, selector: Selector, scope: Scope,
                 in_schema: ev.Schema, group_slots: int = 4096,
                 out_stream_id: str = ""):
        self.selector = selector
        self.scope = scope
        self.group_by_positions: List[int] = []
        for v in selector.group_by_list:
            _, pos, _ = scope.resolve(v)
            self.group_by_positions.append(pos)
        self.bank = AggregatorBank(group_slots, scope.device)
        self._agg_calls: List[AttributeFunction] = []
        sel_list = selector.selection_list or [
            OutputAttribute(None, Variable(n)) for n in in_schema.names]
        self.out_names: List[str] = [oa.name for oa in sel_list]
        self._exprs = [oa.expression for oa in sel_list]
        proj = [_rewrite_aggregators(oa.expression, self._agg_calls,
                                     "__agg") for oa in sel_list]
        self._agg_results: List[Tuple[str, Callable]] = []
        self._compile_calls(scope, out_stream_id, "")
        self._compiled: List[CompiledExpr] = [
            _compile_with_pseudo(e, scope, self._agg_results) for e in proj]
        self.out_types = [c.type for c in self._compiled]
        if "SET" in self.out_types:
            raise CompileError(
                "set values cannot materialize in columnar outputs; wrap "
                "with sizeOfSet(...)")

        self.having = None
        if selector.having_expression is not None:
            # having may reference select aliases: substitute them with the
            # projected expression before aggregator rewriting
            alias_map = {oa.rename: oa.expression for oa in sel_list
                         if oa.rename}
            hre = _substitute_aliases(selector.having_expression, alias_map,
                                      scope)
            hre = _rewrite_aggregators(hre, self._agg_calls, "__agg")
            self._compile_calls(scope, out_stream_id, "h")
            self.having = _compile_with_pseudo(hre, scope,
                                               self._agg_results)

        # order by: keys are projected output columns (reference
        # `_projection_scope`, `siddhi_tpu/core/selector.py:638`)
        self._order_by: List[Tuple[CompiledExpr, str]] = []
        if selector.order_by_list:
            pscope = _projection_scope(self.out_names, self.out_types,
                                       scope.interner, scope.device)
            for ob in selector.order_by_list:
                self._order_by.append(
                    (compile_expression(ob.variable, pscope), ob.order))
        self.ordered = bool(self._order_by) or selector.limit is not None \
            or selector.offset is not None

    def _compile_calls(self, scope, out_stream_id, tag) -> None:
        while len(self._agg_results) < len(self._agg_calls):
            i = len(self._agg_results)
            call = self._agg_calls[i]
            ekey = f"{out_stream_id}:{tag}{i}:{_expr_fingerprint(call)}"
            t, fn = self.bank.compile_call(call, scope, ekey)
            self._agg_results.append((t, fn))
            scope.bind(f"__agg{i}", CompiledExpr(fn=None, type=t))

    @property
    def has_aggregation(self) -> bool:
        return bool(self.bank.specs)

    def init_state(self):
        return self.bank.init_state()

    def used_columns(self) -> Set[Tuple[str, int]]:
        """(scope key, column position) of every source column the
        projection reads."""
        used = set()
        for e in self._exprs:
            for node in walk(e):
                if isinstance(node, Variable):
                    key, pos, _ = self.scope.resolve(node)
                    used.add((key, pos))
        return used

    def process(self, state, rows: Rows, env: Dict[str, Any]):
        """Returns (state', (ts, kind, valid, out_cols))."""
        new_state, scans = self.bank.process(state, rows, env)
        env = dict(env)
        env["__aggscan__"] = scans
        shape = rows.ts.shape
        out_cols = tuple(
            torch.broadcast_to(c.fn(env), shape).to(ev.dtype_of(c.type))
            for c in self._compiled)
        valid = torch.logical_and(
            rows.valid,
            torch.logical_or(rows.kind == ev.CURRENT,
                             rows.kind == ev.EXPIRED))
        if self.having is not None:
            valid = torch.logical_and(valid, self.having.fn(env))
        if self.ordered:
            return new_state, self._order_limit(rows.ts, rows.kind, valid,
                                                out_cols)
        return new_state, (rows.ts, rows.kind, valid, out_cols)

    def _order_limit(self, ts, kind, valid, out_cols):
        """order by / limit / offset over every valid CURRENT and EXPIRED
        row of the step (reference `_order_limit`,
        `siddhi_tpu/core/selector.py:545`): kernel K13."""
        from ..kernels.order_limit import order_limit
        env = {"__out__": out_cols}
        keys = [(c.fn(env), order == "DESC") for c, order in self._order_by]
        return order_limit(keys, self.selector.offset or 0,
                           self.selector.limit, ts, kind, valid, out_cols)
