"""Expression compiler: SiddhiQL expression AST -> PyTorch column ops.

Port of `siddhi_tpu/core/executor.py`.  Each expression compiles once into
a function over a columnar environment (`env`: scope key -> tuple of column
tensors).  Filters become boolean masks, not control flow.

Semantics kept from the reference package, operator by operator:
  * arithmetic promotes by the Siddhi order INT < LONG < FLOAT < DOUBLE, and
    null in gives null out (the in-band null of the result type);
  * integer division truncates toward zero and a zero divisor gives 0;
  * comparisons promote like the reference's array library does (int32 and
    int64 meet in int64, any int and float32 meet in float32) and a null
    operand makes the comparison false;
  * constants are never null.

Of the function calls `coalesce` (reference:
`siddhi_tpu/core/executor.py:377`) and `sizeOfSet` over unionSet's SET
value are ported; `createSet` only inside unionSet; the other built-ins,
the extension SPI and script functions raise `CompileError`.  `x in
Table` reads the probe the step puts in the env
(`env["__in__:<table>"]`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    In,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    Variable,
)
from . import event as ev

# numeric promotion order (reference: ExpressionParser type dispatch)
_NUMERIC_ORDER = {"INT": 0, "LONG": 1, "FLOAT": 2, "DOUBLE": 3}
NUMERIC_TYPES = set(_NUMERIC_ORDER)

AGGREGATOR_NAMES = {
    "sum", "avg", "count", "min", "max", "distinctCount", "stdDev",
    "minForever", "maxForever", "and", "or", "unionSet",
}


def promote(t1: str, t2: str) -> str:
    if t1 not in _NUMERIC_ORDER or t2 not in _NUMERIC_ORDER:
        raise CompileError(f"cannot apply arithmetic to {t1}/{t2}")
    return max(t1, t2, key=lambda t: _NUMERIC_ORDER[t])


# dtype lattice of the comparison operands (bool < int32 < int64, and any
# int meets float32 in float32)
_CMP_RANK = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
             torch.float32: 3}


def compare_dtype(d1: torch.dtype, d2: torch.dtype) -> torch.dtype:
    """The dtype two comparison operands are cast to before comparing."""
    return d1 if _CMP_RANK[d1] >= _CMP_RANK[d2] else d2


@dataclasses.dataclass
class CompiledExpr:
    """fn(env) -> tensor; env maps scope keys to tuples of column tensors,
    plus '__ts__' timestamps and a '__now__' scalar."""

    fn: Callable[[Dict[str, Any]], Any]
    type: str                      # result attribute type
    is_constant: bool = False
    constant_value: Any = None


class Scope:
    """Resolves Variable nodes to (scope_key, column_position, type).

    `device` is where constants are materialised; `None`-qualified variables
    resolve through `default_keys` in order (ambiguity is an error)."""

    def __init__(self, device: Optional[torch.device] = None):
        self._sources: Dict[str, "ev.Schema"] = {}
        self._aliases: Dict[str, str] = {}
        self.default_keys: List[str] = []
        self.interner = None
        self.device = device if device is not None else torch.device("cpu")
        # pseudo-columns bound by the selector (aggregator outputs)
        self._bound: Dict[str, CompiledExpr] = {}

    def add_source(self, key: str, schema: "ev.Schema",
                   alias: Optional[str] = None, default: bool = True) -> None:
        self._sources[key] = schema
        if alias and alias != key:
            self._aliases[alias] = key
        if default:
            self.default_keys.append(key)

    def bind(self, name: str, compiled: CompiledExpr) -> None:
        self._bound[name] = compiled

    @property
    def bound_names(self) -> Dict[str, CompiledExpr]:
        return self._bound

    def schema(self, key: str) -> "ev.Schema":
        key = self._aliases.get(key, key)
        return self._sources[key]

    def resolve(self, var: Variable) -> Tuple[Optional[str], int, str]:
        if var.stream_id is not None:
            key = self._aliases.get(var.stream_id, var.stream_id)
            if key not in self._sources:
                raise CompileError(
                    f"unknown stream reference {var.stream_id!r} for "
                    f"attribute {var.attribute_name!r}")
            schema = self._sources[key]
            pos = schema.position(var.attribute_name)
            return key, pos, schema.types[pos]
        if var.attribute_name in self._bound:
            return None, -1, self._bound[var.attribute_name].type
        hits = []
        for key in self.default_keys:
            schema = self._sources[key]
            if var.attribute_name in schema.names:
                hits.append((key, schema))
        if not hits:
            raise CompileError(f"unknown attribute {var.attribute_name!r}")
        if len(set(k for k, _ in hits)) > 1:
            raise CompileError(
                f"ambiguous attribute {var.attribute_name!r} (in "
                f"{[k for k, _ in hits]})")
        key, schema = hits[0]
        pos = schema.position(var.attribute_name)
        return key, pos, schema.types[pos]


def maybe_null(c: CompiledExpr) -> bool:
    """Can this expression's column contain the reserved null value?"""
    return not c.is_constant and c.type in (
        "INT", "LONG", "FLOAT", "DOUBLE", "STRING", "OBJECT")


def _int_divide(a, b):
    """Java integer division: truncates toward zero; a zero divisor gives 0."""
    zero = b == 0
    q = torch.where(zero, torch.zeros_like(a), a)
    b = torch.where(zero, torch.ones_like(b), b)
    return torch.sign(q) * torch.sign(b) * (torch.abs(q) // torch.abs(b))


def _mod(a, b):
    """Floor modulo; an integer zero divisor gives 0, a float one NaN."""
    if a.dtype.is_floating_point:
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


_ARITH = {Add: torch.add, Subtract: torch.sub, Multiply: torch.mul,
          Mod: _mod}
_CMP = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
        "==": torch.eq, "!=": torch.ne}


def _as(x, dtype):
    return x.to(dtype)


def compile_expression(expr: Expression, scope: Scope) -> CompiledExpr:
    """Recursively compile an expression tree to a column function."""
    if isinstance(expr, Constant):
        if expr.type == "STRING":
            if scope.interner is None:
                raise CompileError("scope has no interner for string constant")
            value = scope.interner.intern(expr.value)
        else:
            value = expr.value
        const = torch.tensor(value, dtype=ev.dtype_of(expr.type),
                             device=scope.device)
        return CompiledExpr(lambda env, _v=const: _v, expr.type, True,
                            expr.value)

    if isinstance(expr, Variable):
        key, pos, t = scope.resolve(expr)
        if key is None:  # bound pseudo-column (aggregator output)
            inner = scope.bound_names[expr.attribute_name]
            return CompiledExpr(inner.fn, inner.type)
        if expr.stream_index is not None:
            # pattern count-state index: e1[2].attr / e1[last].attr resolve
            # through per-depth env entries provided by the pattern runtime
            idx = expr.stream_index if expr.stream_index >= 0 else -1
            k = f"{key}@{idx}"
        else:
            k = key
        return CompiledExpr(lambda env, _k=k, _p=pos: env[_k][_p], t)

    if isinstance(expr, (Add, Subtract, Multiply, Divide, Mod)):
        l = compile_expression(expr.left, scope)
        r = compile_expression(expr.right, scope)
        t = promote(l.type, r.type)
        dtype = ev.dtype_of(t)
        lnull, rnull = maybe_null(l), maybe_null(r)
        nv = torch.tensor(ev.null_value(t), dtype=dtype, device=scope.device)
        if isinstance(expr, Divide):
            op = _int_divide if t in ("INT", "LONG") else torch.div
        else:
            op = _ARITH[type(expr)]

        def fn(env, _l=l, _r=r, _op=op, _d=dtype, _nv=nv):
            a, b = _l.fn(env), _r.fn(env)
            out = _op(_as(a, _d), _as(b, _d))
            n = None
            if lnull:
                n = ev.null_mask(a, _l.type)
            if rnull:
                rn = ev.null_mask(b, _r.type)
                n = rn if n is None else torch.logical_or(n, rn)
            return torch.where(n, _nv, out) if n is not None else out
        return CompiledExpr(fn, t)

    if isinstance(expr, Compare):
        l = compile_expression(expr.left, scope)
        r = compile_expression(expr.right, scope)
        if l.type == "STRING" and r.type == "STRING":
            if expr.operator not in ("==", "!="):
                raise CompileError(
                    "string ordering comparisons are not supported on device")
        elif l.type != "BOOL" and r.type != "BOOL":
            promote(l.type, r.type)       # raises on non-numeric operands
        cd = compare_dtype(ev.dtype_of(l.type), ev.dtype_of(r.type))
        opf = _CMP[expr.operator]
        lnull, rnull = maybe_null(l), maybe_null(r)

        def fn(env, _l=l, _r=r, _op=opf, _cd=cd):
            a, b = _l.fn(env), _r.fn(env)
            out = _op(_as(a, _cd), _as(b, _cd))
            if lnull:
                out = torch.logical_and(
                    out, torch.logical_not(ev.null_mask(a, _l.type)))
            if rnull:
                out = torch.logical_and(
                    out, torch.logical_not(ev.null_mask(b, _r.type)))
            return out
        return CompiledExpr(fn, "BOOL")

    if isinstance(expr, (And, Or)):
        l = compile_expression(expr.left, scope)
        r = compile_expression(expr.right, scope)
        op = torch.logical_and if isinstance(expr, And) else torch.logical_or
        return CompiledExpr(
            lambda env, _l=l.fn, _r=r.fn, _op=op: _op(_l(env), _r(env)),
            "BOOL")

    if isinstance(expr, Not):
        inner = compile_expression(expr.expression, scope)
        return CompiledExpr(
            lambda env, _i=inner.fn: torch.logical_not(_i(env)), "BOOL")

    if isinstance(expr, IsNull):
        if expr.expression is None:
            raise CompileError(
                "stream-level is null only valid inside patterns")
        inner = compile_expression(expr.expression, scope)
        if maybe_null(inner):
            return CompiledExpr(
                lambda env, _i=inner.fn, _t=inner.type:
                ev.null_mask(_i(env), _t), "BOOL")
        return CompiledExpr(
            lambda env, _i=inner.fn: torch.zeros(
                _i(env).shape, dtype=torch.bool, device=scope.device),
            "BOOL")

    if isinstance(expr, In):
        # the step's env carries one probe per table dependency
        # (`kernels.in_probe.probe_env`), as the reference's does
        inner = compile_expression(expr.expression, scope)

        def fn(env, _i=inner.fn, _src=expr.source_id):
            return env["__in__:" + _src](_i(env))
        return CompiledExpr(fn, "BOOL")

    if isinstance(expr, AttributeFunction) and not expr.namespace and \
            expr.name == "coalesce" and expr.parameters:
        return _compile_coalesce(expr, scope)

    if isinstance(expr, AttributeFunction) and not expr.namespace and \
            expr.name in ("createSet", "sizeOfSet"):
        return _compile_set_fn(expr, scope)

    if isinstance(expr, AttributeFunction):
        full = f"{expr.namespace}:{expr.name}" if expr.namespace \
            else expr.name
        raise CompileError(
            f"function {full!r} is not yet ported (ROADMAP A4)")

    raise CompileError(f"cannot compile expression node {type(expr).__name__}")


def _null_cast(x, from_t: str, to_t: str):
    """astype that maps from_t's null onto to_t's (an int null cast to
    float becomes NaN, not -2.1e9)."""
    d = ev.dtype_of(to_t)
    out = x.to(d)
    if from_t == to_t or from_t not in NUMERIC_TYPES or \
            to_t not in NUMERIC_TYPES:
        return out
    return torch.where(ev.null_mask(x, from_t),
                       torch.tensor(ev.null_value(to_t), dtype=d,
                                    device=x.device), out)


def _compile_set_fn(expr: AttributeFunction, scope: Scope) -> CompiledExpr:
    """createSet / sizeOfSet (reference: siddhi_tpu/core/executor.py:433):
    a set exists only as unionSet's SET value, which carries the running
    distinct count, so sizeOfSet of it is that count."""
    if expr.name == "createSet":
        raise CompileError(
            "createSet is only valid inside unionSet(createSet(attr))")
    src = compile_expression(expr.parameters[0], scope)
    if src.type != "SET":
        raise CompileError(
            "sizeOfSet expects a set value "
            "(e.g. sizeOfSet(unionSet(createSet(attr))))")
    return CompiledExpr(src.fn, "LONG")


def _compile_coalesce(expr: AttributeFunction, scope: Scope) -> CompiledExpr:
    """coalesce(a, b, ...): the first argument that is not null
    (reference: siddhi_tpu/core/executor.py:377)."""
    compiled = [compile_expression(a, scope) for a in expr.parameters]
    t = compiled[0].type
    if t in ("STRING", "OBJECT"):
        def sfn(env, _c=compiled):
            out = _c[0].fn(env)
            for c in _c[1:]:
                out = torch.where(out == ev.NULL_ID, c.fn(env), out)
            return out
        return CompiledExpr(sfn, t)
    for c in compiled[1:]:
        t = promote(t, c.type)

    def fn(env, _c=compiled, _t=t):
        out = _null_cast(_c[0].fn(env), _c[0].type, _t)
        for c in _c[1:]:
            out = torch.where(ev.null_mask(out, _t),
                              _null_cast(c.fn(env), c.type, _t), out)
        return out
    return CompiledExpr(fn, t)
