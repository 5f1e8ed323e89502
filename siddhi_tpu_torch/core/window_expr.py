"""Expression windows (port of `siddhi_tpu/core/window_expr.py`):
`#window.expression(expr)` and `#window.expressionBatch(expr[,
include.triggering.event[, stream.current.event]])`.

Reference behaviour (CORE/query/processor/stream/window/
ExpressionWindowProcessor.java, ExpressionBatchWindowProcessor.java):
windows that shrink or grow as a boolean expression over their contents
holds, with `first` / `last` event references, `count()`, `sum` / `avg` /
`min` / `max` of a per-row expression and `eventTimestamp(first|last)`.

The expression is compiled once into a range program
(`compile_range_expr`): a typed postfix program that, for a newest index
`hi` of a window's combined array (its kept rows by age, then the step's
arrivals) and a candidate oldest index `j`, says whether the expression
holds over the range [j, hi].  The JAX package's range evaluator
(`_range_eval`, `:98-165`) defines what each node is:
  * `first.x` is the value at j; `last.x` and a bare `x` the value at hi
    (a float plus +0.0, as the reference's one-hot sum gives it);
  * `count()` is hi - j + 1 (int64); `eventTimestamp(first)` is ts[j],
    any other `eventTimestamp(..)` ts[hi];
  * `sum(e)` / `avg(e)` are P[hi] - P[j] + x[j] over the float64
    inclusive prefix P of the per-row values x of e (P[hi] plus +0.0);
    `avg` divides by max(count, 1);
  * `min(e)` / `max(e)` are the float64 extreme of x over [j, hi] (NaN if
    any is NaN, -0.0 below +0.0, as `jnp.minimum` / `jnp.maximum`);
  * an aggregate's argument is a per-row program of columns, constants
    and `+ - * % /`; `first` / `last` inside it raise.
Types follow JAX's promotion with weak constants (`jnp.asarray` of a
Python int is a weak int64, of a float a weak float64): an f32 column
against a float constant compares in f32, an int32 column plus an int
constant stays int32, int and float meet in the float (int64 + f32 is
f32), and a weak float with an int is float64.  `/` casts its left side
to float64; `%` is the floor modulo of `jnp.remainder` (an integer zero
divisor gives 0, a float one NaN).  A non-boolean result holds where it
is non-zero.  Nodes the reference does not evaluate raise `CompileError`
with its reasons; so does a string constant (the reference's
`jnp.asarray` cannot take one).

The windows (`ExpressionWindow`, `ExpressionBatchWindow`) run kernels K25
`expr_window` and K26 `expr_batch` (`kernels/expr_window.py`), at the top
level on a slab of one key row whose events are the whole batch, and
inside a partition per key (the planner's `kstep`).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

from ..exceptions import CompileError
from ..query_api.expression import (Add, And, AttributeFunction, Compare,
                                    Constant, Divide, Mod, Multiply, Not, Or,
                                    Subtract, Variable)
from . import event as ev
from .window import WindowOutput, WindowProcessor, one_key_row, slab_view

# value types (the first four are the filter bytecode's type codes)
T_I32, T_I64, T_F32, T_BOOL, T_F64 = range(5)
# the lane of the event timestamp in a window's combined array
TS_LANE = -2
# range program opcodes (`csrc/range_expr.cuh` mirrors them)
(R_CONST, R_FIRST, R_LAST, R_COUNT, R_AGG, R_CAST, R_ARITH, R_CMP, R_AND,
 R_OR, R_NOT, R_TRUTH, R_COL) = range(1, 14)
A_ADD, A_SUB, A_MUL, A_DIV, A_MOD = range(5)
CMP_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
AGG_SUM, AGG_AVG, AGG_MIN, AGG_MAX = range(4)
MAX_AGGS, MAX_LANES, MAX_PROG, MAX_STACK = 8, 16, 256, 16

# JAX's promotion lattice over (strong) bool, i32, i64, f32, f64 and the
# weak int64 'wi' / weak float64 'wf' of a Python constant (jax_enable_x64)
_ORDER = ("b", "i32", "i64", "f32", "f64", "wi", "wf")
_JOIN = {
    "i32": ("i32", "i32", "i64", "f32", "f64", "i32", "wf"),
    "i64": ("i64", "i64", "i64", "f32", "f64", "i64", "wf"),
    "f32": ("f32", "f32", "f32", "f32", "f64", "f32", "f32"),
    "f64": ("f64",) * 7,
    "b": ("b", "i32", "i64", "f32", "f64", "wi", "wf"),
    "wi": ("wi", "i32", "i64", "f32", "f64", "wi", "wf"),
    "wf": ("wf", "wf", "wf", "f32", "f64", "wf", "wf"),
}
_CODE = {"b": T_BOOL, "i32": T_I32, "i64": T_I64, "f32": T_F32,
         "f64": T_F64, "wi": T_I64, "wf": T_F64}
_OF_DTYPE = {"INT": "i32", "LONG": "i64", "FLOAT": "f32", "DOUBLE": "f32",
             "BOOL": "b", "STRING": "i32", "OBJECT": "i32"}


def join(a: str, b: str) -> str:
    """JAX's result type of a binary operation on types a and b."""
    return _JOIN[a][_ORDER.index(b)]


def const_words(value, t: int) -> Tuple[int, int]:
    """A constant of value type t as the (low, high) int32 words of its
    64-bit slot: an integer sign-extended, an f32's bits in the low word,
    an f64's bits."""
    if t == T_F64:
        bits = struct.unpack("<q", struct.pack("<d", float(value)))[0]
    elif t == T_F32:
        bits = struct.unpack("<i", struct.pack("<f", float(value)))[0]
    else:
        bits = int(value)
    bits &= (1 << 64) - 1
    lo, hi = bits & 0xFFFFFFFF, bits >> 32
    return (lo - (1 << 32) if lo >= 1 << 31 else lo,
            hi - (1 << 32) if hi >= 1 << 31 else hi)


@dataclasses.dataclass(frozen=True)
class RangeProgram:
    """A compiled window expression.  `code` is the postfix program over
    (hi, j); `lanes` the combined array's columns it reads (a column
    position, or TS_LANE) and `lane_types` their value types; `aggs` each
    aggregate's (kind, per-row program, the per-row value's type).  Each
    program is a tuple of int words:
      R_CONST t lo hi | R_FIRST lane t | R_LAST lane t | R_COL lane t |
      R_COUNT | R_AGG a | R_CAST from to | R_ARITH op t | R_CMP op t |
      R_AND | R_OR | R_NOT | R_TRUTH t
    (R_COL only in a per-row program; an operation's operands are already
    cast to its type t)."""

    code: Tuple[int, ...]
    lanes: Tuple[int, ...]
    lane_types: Tuple[int, ...]
    aggs: Tuple[Tuple[int, Tuple[int, ...], int], ...]


class _Compiler:
    def __init__(self, schema: ev.Schema):
        self.schema = schema
        self.lanes: List[int] = []
        self.lane_types: List[int] = []
        self.aggs: List[Tuple[int, Tuple[int, ...], int]] = []

    def lane(self, pos: int) -> Tuple[int, str]:
        if pos == TS_LANE:
            t = "i64"
        else:
            t = _OF_DTYPE[self.schema.types[pos].upper()]
        if pos not in self.lanes:
            if len(self.lanes) >= MAX_LANES:
                raise CompileError("window expression reads too many "
                                   "columns")
            self.lanes.append(pos)
            self.lane_types.append(_CODE[t])
        return self.lanes.index(pos), t

    def column(self, name: str) -> int:
        try:
            return self.schema.position(name)
        except (KeyError, ValueError) as exc:
            raise CompileError(f"window expression: unknown attribute "
                               f"{name!r}") from exc

    @staticmethod
    def const(expr: Constant):
        if expr.type == "STRING" or isinstance(expr.value, str):
            raise CompileError("window expression: string constants are "
                               "not supported")
        v = expr.value
        if isinstance(v, bool):
            t = "b"
        elif isinstance(v, int):
            t = "wi"
        elif isinstance(v, float):
            t = "wf"
        else:
            raise CompileError(f"window expression: constant {v!r}")
        return [R_CONST, _CODE[t], *const_words(v, _CODE[t])], t, v

    @staticmethod
    def cast(code, frm: str, to: str, value=None):
        """`code` (a value of type frm) converted to type `to`; a constant
        is folded."""
        a, b = _CODE[frm], _CODE[to]
        if a == b:
            return code
        if value is not None and code[0] == R_CONST:
            v = value
            if b in (T_F32, T_F64):
                v = float(v)
            elif b == T_BOOL:
                v = bool(v)
            else:
                v = int(v)
            return [R_CONST, b, *const_words(v, b)]
        return code + [R_CAST, a, b]

    def binary(self, expr, left, right):
        """An arithmetic node: (code, type) with JAX's promotion."""
        (lc, lt, lv), (rc, rt, rv) = left, right
        if isinstance(expr, Divide):
            lc, lt, lv = self.cast(lc, lt, "f64", lv), "f64", None
        t = join(lt, rt)
        if _CODE[t] == T_BOOL:
            raise CompileError("window expression: arithmetic on two "
                               "booleans")
        op = {Add: A_ADD, Subtract: A_SUB, Multiply: A_MUL, Divide: A_DIV,
              Mod: A_MOD}[type(expr)]
        code = (self.cast(lc, lt, t, lv) + self.cast(rc, rt, t, rv) +
                [R_ARITH, op, _CODE[t]])
        return code, t, None

    def col_eval(self, expr):
        """An aggregate's argument: a per-row program (`_col_eval`)."""
        if isinstance(expr, Constant):
            return self.const(expr)
        if isinstance(expr, Variable):
            if expr.stream_id is None:
                lane, t = self.lane(self.column(expr.attribute_name))
                return [R_COL, lane, _CODE[t]], t, None
            raise CompileError(
                "first/last references are not allowed inside "
                "window-expression aggregates")
        if isinstance(expr, (Add, Subtract, Multiply, Mod, Divide)):
            return self.binary(expr, self.col_eval(expr.left),
                               self.col_eval(expr.right))
        raise CompileError(
            f"unsupported aggregate argument in window expression: "
            f"{expr!r}")

    def range_eval(self, expr):
        """A node over (hi, j): (code, type, constant value or None)."""
        if isinstance(expr, Constant):
            return self.const(expr)
        if isinstance(expr, Variable):
            sid = expr.stream_id
            if sid not in ("first", "last", None):
                raise CompileError(
                    f"expression window reference {sid!r} (use "
                    f"first/last)")
            lane, t = self.lane(self.column(expr.attribute_name))
            op = R_FIRST if sid == "first" else R_LAST
            return [op, lane, _CODE[t]], t, None
        if isinstance(expr, AttributeFunction):
            nm = expr.name
            if nm == "count":
                return [R_COUNT], "i64", None
            if nm == "eventTimestamp":
                p = expr.parameters
                lane, _ = self.lane(TS_LANE)
                first = bool(p) and isinstance(p[0], Variable) and \
                    p[0].attribute_name == "first"
                return [R_FIRST if first else R_LAST, lane, T_I64], "i64", \
                    None
            if nm in ("sum", "avg", "min", "max"):
                if not expr.parameters:
                    raise CompileError(f"window expression: {nm}() takes "
                                       f"an argument")
                code, t, v = self.col_eval(expr.parameters[0])
                if len(self.aggs) >= MAX_AGGS:
                    raise CompileError("window expression has too many "
                                       "aggregates")
                kind = {"sum": AGG_SUM, "avg": AGG_AVG, "min": AGG_MIN,
                        "max": AGG_MAX}[nm]
                self.aggs.append((kind, tuple(code), _CODE[t]))
                return [R_AGG, len(self.aggs) - 1], "f64", None
            raise CompileError(f"unsupported function {nm!r} in window "
                               f"expression")
        if isinstance(expr, (Add, Subtract, Multiply, Divide, Mod)):
            return self.binary(expr, self.range_eval(expr.left),
                               self.range_eval(expr.right))
        if isinstance(expr, Compare):
            (lc, lt, lv), (rc, rt, rv) = (self.range_eval(expr.left),
                                          self.range_eval(expr.right))
            t = join(lt, rt)
            return (self.cast(lc, lt, t, lv) + self.cast(rc, rt, t, rv) +
                    [R_CMP, CMP_OPS[expr.operator], _CODE[t]]), "b", None
        if isinstance(expr, (And, Or)):
            lc = self.truth(self.range_eval(expr.left))
            rc = self.truth(self.range_eval(expr.right))
            return lc + rc + [R_AND if isinstance(expr, And) else R_OR], \
                "b", None
        if isinstance(expr, Not):
            return self.truth(self.range_eval(expr.expression)) + [R_NOT], \
                "b", None
        raise CompileError(f"unsupported node in window expression: "
                           f"{expr!r}")

    @staticmethod
    def truth(node):
        code, t, _ = node
        return code if t == "b" else code + [R_TRUTH, _CODE[t]]


def _depth(code) -> int:
    """The deepest stack a program takes."""
    sizes = {R_CONST: (4, 1), R_FIRST: (3, 1), R_LAST: (3, 1),
             R_COL: (3, 1), R_COUNT: (1, 1), R_AGG: (2, 1),
             R_CAST: (3, 0), R_ARITH: (3, -1), R_CMP: (3, -1),
             R_AND: (1, -1), R_OR: (1, -1), R_NOT: (1, 0),
             R_TRUTH: (2, 0)}
    pc = sp = top = 0
    while pc < len(code):
        n, d = sizes[code[pc]]
        sp += d
        top = max(top, sp)
        pc += n
    return top


def compile_range_expr(expr, schema: ev.Schema) -> RangeProgram:
    c = _Compiler(schema)
    code = c.truth(c.range_eval(expr))
    progs = [code] + [list(a[1]) for a in c.aggs]
    if sum(len(p) for p in progs) > MAX_PROG or \
            max(_depth(p) for p in progs) > MAX_STACK:
        raise CompileError("window expression is too long")
    return RangeProgram(tuple(code), tuple(c.lanes), tuple(c.lane_types),
                        tuple(c.aggs))


def _parse_expr_param(params):
    if not params or not isinstance(params[0], Constant) or \
            params[0].type != "STRING":
        raise CompileError(
            "expression window takes a constant string expression")
    from ..compiler.parser import Parser
    return Parser(str(params[0].value)).parse_expression()


class ExpressionWindow(WindowProcessor):
    """Sliding expression window (reference: ExpressionWindowProcessor):
    holds events while the expression over the window holds; an arrival
    that breaks it expires the oldest rows until it holds again (itself
    too, when it holds for no range), and at most C rows stay (the oldest
    beyond them expire), each eviction an EXPIRED row before the
    arrival's CURRENT row (kernel K25)."""

    # its kernel evaluates the filters itself
    prefilters = False
    name = "expression"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity)
        self.expr = _parse_expr_param(params)
        self.program = compile_range_expr(self.expr, schema)
        self.capacity = capacity_hint
        self._sel = {}

    def params(self):
        from ..kernels.expr_window import ExprParams
        return ExprParams(self.program)

    def fill_sources(self, state):
        """One key row of K25 / K26's slab: the run's rows, then (an
        expressionBatch) the previous batch's, C + 1 of them."""
        from ..kernels import fill_probe as fp
        out = [fp.count(state.count, 0, state.C)]
        if state.p_count is not None:
            out.append(fp.count(state.p_count, 0, state.p_ts.shape[1]))
        return out

    def init_state(self, device):
        from ..kernels.expr_window import empty_slab
        return empty_slab(self, 1, device)

    def current_buffer(self, state):
        """The window's rows (an expressionBatch's pending run) by
        add_seq."""
        return slab_view(state)

    def process(self, state, rows, fspec, now: int, facts):
        from ..kernels.expr_window import expr_window_step
        key_idx, sel = one_key_row(self._sel, rows.ts)
        out, wake = expr_window_step(state, fspec, rows.ts, rows.kind,
                                     rows.valid, rows.gslot, rows.cols,
                                     key_idx, sel, now, self.params())
        return state, WindowOutput(out, wake)


class ExpressionBatchWindow(ExpressionWindow):
    """Batch expression window (reference: ExpressionBatchWindowProcessor):
    collects events while the expression holds over the pending run (read
    at its first row); an arrival that breaks it, or a run longer than C,
    flushes the run CURRENT after the previous batch EXPIRED.  Options:
    include.triggering.event (the breaking arrival joins the flushed
    batch), stream.current.event (arrivals stream out CURRENT as they
    come, the expired batches after them).  No RESET rows (kernel K26)."""

    name = "expressionBatch"

    def __init__(self, schema, params, batch_capacity, capacity_hint=1024):
        super().__init__(schema, params, batch_capacity, capacity_hint)
        self.include_trigger = bool(params[1].value) if len(params) > 1 \
            and isinstance(params[1], Constant) else False
        self.stream_current = bool(params[2].value) if len(params) > 2 \
            and isinstance(params[2], Constant) else False

    def params(self):
        from ..kernels.expr_window import ExprParams
        return ExprParams(self.program, batch=True,
                          include_trigger=self.include_trigger,
                          stream_current=self.stream_current)


def register(window_types: dict) -> None:
    for cls in (ExpressionWindow, ExpressionBatchWindow):
        window_types[cls.name] = cls
