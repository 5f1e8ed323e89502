"""On-demand (store) queries over tables, named windows and aggregations
(port of `siddhi_tpu/core/ondemand.py`).

Reference behaviour (what): `runtime.query("from T on cond select ...")`
runs at once against the table's current contents and returns Event[]:
FIND with an `on` condition (through an @Index / @PrimaryKey probe when
one conjunct allows it, the full condition re-checking each candidate),
the projection, group by / having / order by / limit over the found rows;
and the on-demand writes insert, delete, update and update or insert,
which go through the table's own write paths (kernels K9 and K10).

How the port runs it: a FIND fetches the table's columns to the host
once and reduces them there with numpy, as the reference does; the
condition and the projections are the executor's torch expressions over
host tensors.  A named window's store is its contents
(`current_buffer`), an aggregation's the buckets of the `per` duration
`within` the range (`snapshot_rows`), both read as a table's rows are.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..query_api.expression import AttributeFunction, Variable
from . import event as ev
from .executor import CompileError, Scope, compile_expression

_AGG_FNS = ("sum", "count", "avg", "min", "max", "distinctCount")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_scope(interner) -> Scope:
    scope = Scope(torch.device("cpu"))
    scope.interner = interner
    return scope


def _store_rows(rt, store_id: str, within, per):
    """-> (schema, host cols, valid mask) of a table, a named window's
    contents or an aggregation's buckets of the `per` duration `within`
    the range (reference `_store_rows`, `siddhi_tpu/core/ondemand.py:
    26-49`)."""
    if store_id in rt.tables:
        t = rt.tables[store_id]
        with t._lock:
            rows = t.all_rows_batch()
            return (t.schema, [_host(c) for c in rows.cols],
                    _host(rows.valid))
    if store_id in rt.named_windows:
        nw = rt.named_windows[store_id]
        with nw._qlock:
            buf = nw.current_buffer()
        if buf is None:
            raise CompileError(
                f"window type {nw.wproc.name!r} does not expose contents "
                f"for on-demand queries")
        cols, _, alive = buf
        return nw.schema, [_host(c) for c in cols], _host(alive)
    if store_id in rt.aggregations:
        from .aggregation import parse_per, parse_within
        agg = rt.aggregations[store_id]
        rng = parse_within(within) if within is not None else None
        if per is None:
            raise CompileError("aggregation on-demand query needs `per`")
        ts, cols = agg.snapshot_rows(parse_per(per), rng)
        return (agg.make_schema(), [np.asarray(c) for c in cols],
                np.ones((ts.shape[0],), np.bool_))
    raise CompileError(f"no table/window/aggregation named {store_id!r}")


class OnDemandPlanMemo:
    """Per-query compile cache so a repeated on-demand query does no
    re-planning.  Keys are id(expr) of AST nodes: valid because the memo
    lives in the same LRU entry as the parsed AST, so the nodes stay alive
    and their ids stable.  `plans` counts compile / plan events."""

    def __init__(self):
        self.exprs = {}
        self.table_plans = {}
        self.selections = {}
        self.plans = 0

    def split_selection(self, selector, schema):
        # cached so `select *`'s synthesized Variables keep stable ids
        k = id(selector)
        if k not in self.selections:
            self.selections[k] = _split_selection(selector, schema)
        return self.selections[k]

    def compile(self, expr, scope):
        c = self.exprs.get(id(expr))
        if c is None:
            c = compile_expression(expr, scope)
            self.exprs[id(expr)] = c
            self.plans += 1
        return c

    def plan_condition(self, table, cond_expr, scope, key):
        k = id(cond_expr)
        if k not in self.table_plans:
            self.table_plans[k] = table.plan_condition(
                cond_expr, scope, table_id=key, unqualified_is_table=True)
            self.plans += 1
        return self.table_plans[k]


class _NoMemo:
    """Uncached plans for an OnDemandQuery object passed directly."""

    plans = 0

    def split_selection(self, selector, schema):
        return _split_selection(selector, schema)

    def compile(self, expr, scope):
        return compile_expression(expr, scope)

    def plan_condition(self, table, cond_expr, scope, key):
        return table.plan_condition(cond_expr, scope, table_id=key,
                                    unqualified_is_table=True)


def _split_selection(selector, schema) -> Tuple[list, bool]:
    """[(name, expr, agg_fn_or_None)] for each output."""
    out = []
    has_agg = False
    sel_list = selector.selection_list
    if not sel_list:  # select *
        return ([(n, Variable(n), None) for n in schema.names], False)
    for oa in sel_list:
        e = oa.expression
        name = oa.rename or (e.attribute_name if isinstance(e, Variable)
                             else "expr")
        if isinstance(e, AttributeFunction) and not e.namespace and \
                e.name in _AGG_FNS:
            has_agg = True
            out.append((name, e, e.name))
        else:
            out.append((name, e, None))
    return out, has_agg


def _eval(c, env) -> np.ndarray:
    return _host(c.fn(env))


def execute_on_demand(rt, oq, memo=None) -> List[ev.Event]:
    """Entry point used by SiddhiAppRuntime.query()."""
    if memo is None:
        memo = _NoMemo()
    if oq.type == "INSERT" and oq.input_store is None:
        return _insert_constant(rt, oq)
    store = oq.input_store
    schema, cols, valid = _store_rows(rt, store.store_id, store.within,
                                      store.per)
    key = store.alias if getattr(store, "alias", None) else store.store_id

    scope = _host_scope(rt.interner)
    scope.add_source(key, schema)

    env = {key: tuple(torch.from_numpy(c) for c in cols),
           "__ts__": torch.zeros(valid.shape, dtype=torch.int64),
           "__now__": rt.timestamp_millis()}
    mask = valid.copy()
    if store.on_condition is not None:
        c = memo.compile(store.on_condition, scope)
        if c.type != "BOOL":
            raise CompileError("on-condition must be boolean")
        table = rt.tables.get(store.store_id)
        sel = (_indexed_row_mask(table, store.on_condition, key, scope, env,
                                 mask, c, memo)
               if table is not None else None)
        if sel is not None:
            mask &= sel
        else:
            if table is not None:
                table.index_stats["dense"] += 1
            mask &= np.broadcast_to(_eval(c, env).astype(bool), mask.shape)

    if oq.type == "FIND":
        return _find(rt, oq, scope, schema, env, mask, key, memo)

    # write ops route the found rows through the table-op machinery
    sel_events = _find(rt, oq, scope, schema, env, mask, key, memo)
    tgt = oq.output_stream.target_id
    if tgt not in rt.tables:
        if oq.type == "INSERT":
            raise CompileError(f"no table named {tgt!r}")
        raise CompileError(f"on-demand {oq.type} target must be a table")
    _apply_write(rt, oq, sel_events, schema)
    return sel_events


def _indexed_row_mask(table, cond_expr, key, scope, env, valid,
                      compiled_full, memo):
    """Index-aware on-demand condition: a row mask, or None when the
    condition has no usable indexed conjunct.  The probe only narrows: the
    full condition re-evaluates on the candidate rows (the same contract
    as TableRuntime._match)."""
    tc = memo.plan_condition(table, cond_expr, scope, key)
    plan = tc.plan
    if plan is None:
        return None
    rv = _eval(memo.compile(plan.rhs, scope), env)
    val = rv.reshape(-1)[0]
    with table._lock:
        if plan.kind == "eq":
            cand, ok = table._probe_candidates(plan.pos, np.asarray([val]))
            rows = cand[0][ok[0]].astype(np.int64)
        else:
            rows = table.indexes[plan.pos].rows_range(
                _host(table.valid), plan.op, val)
    mask = np.zeros(valid.shape, bool)
    rows = rows[rows < valid.shape[0]]
    mask[rows] = True
    mask &= valid
    if mask.any():
        ridx = np.nonzero(mask)[0]
        t_ridx = torch.from_numpy(ridx)
        env_sub = dict(env)
        env_sub[key] = tuple(cc[t_ridx] for cc in env[key])
        env_sub["__ts__"] = env["__ts__"][t_ridx]
        rmask = _eval(compiled_full, env_sub)
        mask[ridx] &= np.broadcast_to(rmask.astype(bool), ridx.shape)
    table.index_stats["indexed"] += 1
    return mask


def _result_schema(names, types, interner):
    from ..query_api.definition import StreamDefinition
    sdef = StreamDefinition("#ondemand")
    for n, t in zip(names, types):
        sdef.attribute(n, t)
    return ev.Schema(sdef, interner)


def _find(rt, oq, scope, schema, env, mask, key, memo) -> List[ev.Event]:
    sel = oq.selector
    items, has_agg = memo.split_selection(sel, schema)

    gb_names = [v.attribute_name for v in (sel.group_by_list or [])]
    gb_pos = [schema.position(n) for n in gb_names]

    idx = np.nonzero(mask)[0]
    gcols = [_host(env[key][p])[idx] for p in gb_pos]
    if gb_pos:
        stacked = np.stack([c.view(np.int64) if c.dtype.kind == "f"
                            else c.astype(np.int64) for c in gcols])
        uniq, inv = np.unique(stacked, axis=1, return_inverse=True)
        inv = inv.reshape(-1)
        n_groups = uniq.shape[1]
    else:
        inv = np.zeros((idx.size,), np.int64)
        n_groups = 1 if (has_agg and idx.size) or not has_agg else 0

    out_cols = []
    out_names = []
    out_types = []
    for name, expr, agg in items:
        out_names.append(name)
        if agg is None:
            c = memo.compile(expr, scope)
            raw = _eval(c, env)
            if raw.ndim == 0:
                raw = np.broadcast_to(raw, mask.shape)
            vals = raw[idx] if idx.size else \
                np.zeros((0,), ev.np_dtype(c.type))
            out_types.append(c.type)
            if has_agg or gb_pos:
                # per-group representative (first row of group)
                rep = np.zeros((n_groups,), vals.dtype if idx.size else
                               ev.np_dtype(c.type))
                if idx.size:
                    first = {}
                    for r, g in enumerate(inv):
                        if g not in first:
                            first[g] = r
                    for g, r in first.items():
                        rep[g] = vals[r]
                out_cols.append(rep)
            else:
                out_cols.append(vals)
            continue
        # aggregate (null inputs skipped, empty aggregates return null)
        if agg == "count":
            vals = np.ones((idx.size,), np.float64)
            nul = np.zeros((idx.size,), bool)
            out_types.append("LONG")
        else:
            c = memo.compile(expr.parameters[0], scope)
            raw_t = _eval(c, env)
            if raw_t.ndim == 0:
                raw_t = np.broadcast_to(raw_t, mask.shape)
            rv = raw_t[idx] if idx.size else \
                np.zeros((0,), ev.np_dtype(c.type))
            nul = np.asarray(ev.null_mask(rv, c.type))
            vals = rv.astype(np.float64)
            out_types.append("DOUBLE" if agg in ("avg",) else
                             ("LONG" if c.type in ("INT", "LONG") and
                              agg in ("sum", "min", "max") else c.type
                              if agg in ("min", "max") else "DOUBLE"))
        out_t = out_types[-1]
        nullv = float(ev.null_value(out_t)) if out_t != "LONG" \
            else float(ev.NULL_LONG)
        nonnull = np.zeros((max(n_groups, 1),), np.float64)
        np.add.at(nonnull, inv, (~nul).astype(np.float64))
        acc = np.zeros((max(n_groups, 1),), np.float64)
        if agg in ("sum", "count"):
            np.add.at(acc, inv, np.where(nul, 0.0, vals))
            if agg == "sum":
                acc = np.where(nonnull > 0, acc, nullv)
        elif agg == "avg":
            cnt = np.zeros_like(acc)
            np.add.at(acc, inv, np.where(nul, 0.0, vals))
            np.add.at(cnt, inv, (~nul).astype(np.float64))
            acc = np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)
        elif agg == "min":
            acc[:] = np.inf
            np.minimum.at(acc, inv, np.where(nul, np.inf, vals))
            acc = np.where(nonnull > 0, acc, nullv)
        elif agg == "max":
            acc[:] = -np.inf
            np.maximum.at(acc, inv, np.where(nul, -np.inf, vals))
            acc = np.where(nonnull > 0, acc, nullv)
        elif agg == "distinctCount":
            acc = np.zeros((max(n_groups, 1),), np.float64)
            for g in range(n_groups):
                acc[g] = np.unique(vals[inv == g]).size
        out_cols.append(acc[:n_groups])

    res_schema = _result_schema(out_names, out_types, rt.interner)
    n_out = n_groups if (has_agg or gb_pos) else idx.size

    # having / order by / limit
    keep = np.ones((n_out,), bool)
    if sel.having_expression is not None:
        hscope = _host_scope(rt.interner)
        hscope.add_source("#out", res_schema)
        hc = memo.compile(sel.having_expression, hscope)
        henv = {"#out": tuple(torch.from_numpy(
            np.asarray(c).astype(ev.np_dtype(t)))
            for c, t in zip(out_cols, out_types))}
        keep &= np.broadcast_to(_eval(hc, henv).astype(bool),
                                (n_out,))
    sel_idx = np.nonzero(keep)[0]
    if sel.order_by_list:
        keys = []
        for ob in reversed(sel.order_by_list):
            p = out_names.index(ob.variable.attribute_name)
            col = np.asarray(out_cols[p])[sel_idx]
            keys.append(-col if ob.order == "DESC" else col)
        order = np.lexsort(keys)
        sel_idx = sel_idx[order]
    if sel.limit is not None:
        off = sel.offset or 0
        sel_idx = sel_idx[off:off + sel.limit]
    elif sel.offset:
        sel_idx = sel_idx[sel.offset:]

    now = rt.timestamp_millis()
    events = []
    for r in sel_idx:
        data = [res_schema.decode_value(t, c[r])
                for c, t in zip(out_cols, out_types)]
        events.append(ev.Event(now, data))
    return events


def _insert_constant(rt, oq) -> List[ev.Event]:
    """`select <constants> insert into T` form."""
    tgt = oq.output_stream.target_id
    if tgt not in rt.tables:
        raise CompileError(f"no table named {tgt!r}")
    table = rt.tables[tgt]
    scope = _host_scope(rt.interner)
    if not oq.selector.selection_list:
        raise CompileError("constant insert needs an explicit select list")
    env = {"__ts__": torch.zeros((1,), dtype=torch.int64),
           "__now__": rt.timestamp_millis()}
    data = []
    for oa in oq.selector.selection_list:
        c = compile_expression(oa.expression, scope)
        v = _eval(c, env)
        data.append(table.schema.decode_value(c.type, v.reshape(-1)[0]))
    e = ev.Event(rt.timestamp_millis(), data)
    staged = ev.pack_np(table.schema, [e])
    table.insert(staged.to_device(table.schema, table.device), staged)
    return [e]


def _apply_write(rt, oq, sel_events, store_schema) -> None:
    """UPDATE / DELETE / UPDATE_OR_INSERT / INSERT with a FROM store."""
    from ..query_api.definition import StreamDefinition
    from ..query_api.expression import Variable as V
    from ..query_api.query import DeleteStream, UpdateOrInsertStream
    out_stream = oq.output_stream
    tgt = out_stream.target_id
    table = rt.tables[tgt]
    # an output-events scope like the streaming table-op path's
    items, _ = _split_selection(oq.selector, store_schema)
    names = [n for n, _, _ in items]
    if not sel_events and oq.type != "INSERT":
        return
    # re-stage the selected events columnar (ints as LONG, floats as
    # DOUBLE: the write casts each column to the table's type)
    sdef = StreamDefinition("#sel")
    if sel_events:
        for n, v in zip(names, sel_events[0].data):
            t = ("STRING" if isinstance(v, str) else
                 "DOUBLE" if isinstance(v, float) else "LONG")
            sdef.attribute(n, t)
    sschema = ev.Schema(sdef, rt.interner)
    staged = ev.pack_np(sschema, sel_events)
    batch = staged.to_device(sschema, table.device)

    if oq.type == "INSERT":
        if len(table.schema.names) != len(names):
            raise CompileError("insert arity does not match table")
        tstaged = ev.pack_np(table.schema, sel_events)
        table.insert(tstaged.to_device(table.schema, table.device), tstaged)
        return

    cscope = Scope(table.device)
    cscope.interner = rt.interner
    cscope.add_source("#sel", sschema)
    cscope.add_source(tgt, table.schema, default=False)
    cond_expr = (out_stream.on_delete_expression
                 if isinstance(out_stream, DeleteStream)
                 else out_stream.on_update_expression)
    cond = table.plan_condition(cond_expr, cscope, other_key="#sel")
    set_fns = []
    us = getattr(out_stream, "update_set", None)
    if us is not None:
        for sa in us.set_attribute_list:
            pos = table.schema.position(sa.table_variable.attribute_name)
            e = compile_expression(sa.value_expression, cscope)
            set_fns.append((pos, e.fn))
    elif not isinstance(out_stream, DeleteStream):
        for n in table.schema.names:
            if n in sschema.names:
                e = compile_expression(V(n, stream_id="#sel"), cscope)
                set_fns.append((table.schema.position(n), e.fn))

    if isinstance(out_stream, DeleteStream):
        table.delete_where(cond, "#sel", batch)
    elif isinstance(out_stream, UpdateOrInsertStream):
        from .runtime import _check_upsert_arity
        _check_upsert_arity(table, sschema, "on-demand query")
        table.update_where(cond, "#sel", batch, set_fns, upsert=True,
                           staged=staged)
    else:
        table.update_where(cond, "#sel", batch, set_fns)
