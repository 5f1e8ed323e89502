"""Query selector, projection path (port of `SelectorExec` in
`siddhi_tpu/core/selector.py`).

A pure projection: each select expression compiles to a column function
over the input rows' environment, and a row stays valid when it is valid
and CURRENT or EXPIRED.  Aggregators, group by, having and order by /
limit / offset are not ported yet (ROADMAP B14) and raise `CompileError`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Set, Tuple

import torch

from ..exceptions import CompileError
from ..query_api.expression import AttributeFunction, Variable, walk
from ..query_api.query import OutputAttribute, Selector
from . import event as ev
from .executor import AGGREGATOR_NAMES, CompiledExpr, Scope, \
    compile_expression
from .window import Rows


class SelectorExec:
    """Compiled select clause (projection only) over Rows."""

    def __init__(self, selector: Selector, scope: Scope,
                 in_schema: ev.Schema):
        self.selector = selector
        self.scope = scope
        if selector.group_by_list:
            raise CompileError("group by is not yet ported (ROADMAP B14)")
        if selector.having_expression is not None:
            raise CompileError("having is not yet ported (ROADMAP B14)")
        if selector.order_by_list or selector.limit is not None or \
                selector.offset is not None:
            raise CompileError(
                "order by / limit / offset are not yet ported (ROADMAP B14)")
        sel_list = selector.selection_list or [
            OutputAttribute(None, Variable(n)) for n in in_schema.names]
        for oa in sel_list:
            for node in walk(oa.expression):
                if isinstance(node, AttributeFunction) and \
                        not node.namespace and node.name in AGGREGATOR_NAMES:
                    raise CompileError(
                        f"aggregator {node.name!r} is not yet ported "
                        f"(ROADMAP B14)")
        self.out_names: List[str] = [oa.name for oa in sel_list]
        self._exprs = [oa.expression for oa in sel_list]
        self._compiled: List[CompiledExpr] = [
            compile_expression(e, scope) for e in self._exprs]
        self.out_types = [c.type for c in self._compiled]

    def init_state(self):
        return ()

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
        """Returns (state, (ts, kind, valid, out_cols))."""
        shape = rows.ts.shape
        out_cols = tuple(
            torch.broadcast_to(c.fn(env), shape).to(ev.dtype_of(c.type))
            for c in self._compiled)
        valid = torch.logical_and(
            rows.valid,
            torch.logical_or(rows.kind == ev.CURRENT,
                             rows.kind == ev.EXPIRED))
        return state, (rows.ts, rows.kind, valid, out_cols)
