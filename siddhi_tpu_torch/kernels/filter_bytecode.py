"""Pattern filters as a small typed postfix bytecode for the CUDA kernel.

The kernel in `csrc/pattern_step.cu` is built once, not once per query, so a
query's filters reach it as data: a list of int32 words that each thread
interprets with a small stack.  `compile_filter` produces the words from the
`query_api` expression tree at plan time; `interpret` is a plain PyTorch
interpreter of the same words, vectorised over keys, so the CPU tests can
hold the bytecode against `core.executor.compile_expression`.

Values on the stack are typed (int32, int64, float32 or bool).  The typing,
promotion and in-band null rules are the executor's:
  * arithmetic casts both sides to the Siddhi-promoted type; a null operand
    gives the null of the result type; integer division truncates toward
    zero and a zero divisor gives 0;
  * comparisons cast both sides to the wider operand dtype and are false
    when a (non-constant) operand is null;
  * `is null` reads the in-band null of its operand's type.

Subset: constants, event-column, capture-column and other-row loads,
`+ - * /`, the six comparisons, and/or/not, `is null`, `coalesce(...)`,
and `x in Table` where the caller's kernel carries the probe's hash sets
(`in_keys`).
Anything else raises CompileError.  The other-row load is the join
probe's: in a join's ON condition one side is the row under evaluation
(`LOAD_EV`) and the other the candidate row it is paired with
(`LOAD_OTHER`), which reads as the null of each column's type when the
row is an outer join's unmatched row.

Word layout (operands follow the opcode):
  LOAD_EV col | LOAD_CAP atom col | CONST lo hi | ARITH op t lt rt lnk rnk |
  CMP op ct lt rt lnk rnk | AND | OR | NOT | ISNULL nk | LOAD_OTHER col |
  COALESCE t lt rt lnk rnk onk | IN set ct ot onk | LOAD_CAPD set col depth
LOAD_CAP reads depth 0 of a pattern atom's capture (depth-1 plans).
LOAD_CAPD reads capture set `set` (every non-absent atom of the pattern,
logical partners included, `kernels/pattern_step.py` numbers them) at a
depth: `e1[i]` is depth i, `e1` depth 0, and depth -1 is `e1[last]`, the
deepest filled depth (a float -0.0 read there comes out +0.0, as the
reference's one-hot take gives it).
IN pops a value of type ot, casts it to the compare type ct and pushes
whether it is in hash set `set` (`kernels/in_probe.py`: the first column of
a table under ct); an in-band null is looked up like any other value.
COALESCE pops b, a; casts each to t, a null operand (by its null kind) to
the null of t (null kind onk); and pushes a unless a is then null, else b
(`coalesce(x, y, z)` folds left, as the executor's `coalesce` does).
Type codes: 0 int32, 1 int64, 2 float32, 3 bool.  Null kinds: 0 never null,
1 INT_MIN, 2 LONG_MIN, 3 NaN, 4 the string/object id -1.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core import event as ev
from ..core.executor import CompileError, Scope, compare_dtype, maybe_null, \
    promote, CompiledExpr
from ..query_api.expression import (
    Add,
    And,
    AttributeFunction,
    Compare,
    Constant,
    Divide,
    In,
    IsNull,
    Multiply,
    Not,
    Or,
    Subtract,
    Variable,
)

LOAD_EV, LOAD_CAP, CONST, ARITH, CMP, AND, OR, NOT, ISNULL, LOAD_OTHER, \
    COALESCE, IN, LOAD_CAPD = range(1, 14)
T_I32, T_I64, T_F32, T_BOOL = range(4)
N_NONE, N_INT, N_LONG, N_NAN, N_ID = range(5)

_ARITH_OPS = {Add: 0, Subtract: 1, Multiply: 2, Divide: 3}
_CMP_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
_DTYPE_CODE = {torch.int32: T_I32, torch.int64: T_I64,
               torch.float32: T_F32, torch.bool: T_BOOL}
CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}


def type_code(attr_type: str) -> int:
    return _DTYPE_CODE[ev.dtype_of(attr_type)]


def null_kind(attr_type: str) -> int:
    t = attr_type.upper()
    return {"INT": N_INT, "LONG": N_LONG, "FLOAT": N_NAN, "DOUBLE": N_NAN,
            "STRING": N_ID, "OBJECT": N_ID}.get(t, N_NONE)


def _words(value, attr_type: str) -> Tuple[int, int]:
    """A constant as two int32 words (low, high) of its 64-bit slot."""
    code = type_code(attr_type)
    if code == T_F32:
        bits = struct.unpack("<i", struct.pack("<f", float(value)))[0]
        return bits, -1 if bits < 0 else 0
    v = int(value)
    if code == T_I32:
        v = struct.unpack("<i", struct.pack("<I", v & 0xFFFFFFFF))[0]
    lo = struct.unpack("<i", struct.pack("<I", v & 0xFFFFFFFF))[0]
    hi = struct.unpack("<i", struct.pack("<I", (v >> 32) & 0xFFFFFFFF))[0]
    return lo, hi


class InKeys:
    """The `x in Table` probes of a kernel plan: the (table, compare type)
    pair behind each hash set its OP_IN words index, in order.
    `col0_types` gives each probe-able table's first attribute type."""

    def __init__(self, col0_types: Dict[str, str]):
        self.col0_types = col0_types
        self.keys: List[Tuple[str, int]] = []

    def index(self, table: str, ct: int) -> int:
        if (table, ct) not in self.keys:
            self.keys.append((table, ct))
        return self.keys.index((table, ct))


def compile_filter(expr, scope: Scope, own_ref: str,
                   atom_of_ref: Dict[str, int],
                   other_ref: Optional[str] = None,
                   in_keys: Optional[InKeys] = None,
                   depths: Optional[Dict[int, int]] = None) -> List[int]:
    """Bytecode of one filter.  `scope` is the filter's scope (unqualified
    names bind to its own stream); `own_ref` loads come from the row under
    evaluation, `other_ref` loads (a join's other side) from the candidate
    row, every other ref from that pattern atom's capture in the slot under
    evaluation (`atom_of_ref`: ref -> atom).  With `depths` (capture set ->
    its depth D) `atom_of_ref` maps refs to capture sets and every capture
    load is an indexed LOAD_CAPD.  `in_keys` collects the plan's probes;
    without it `x in Table` is outside the subset."""
    code: List[int] = []
    global _IN_KEYS, _DEPTHS
    _IN_KEYS, _DEPTHS = in_keys, depths
    try:
        t = _emit(expr, scope, own_ref, atom_of_ref, code, other_ref)
    finally:
        _IN_KEYS = _DEPTHS = None
    if t.type != "BOOL":
        raise CompileError("filter must be boolean")
    return code


def compile_value(expr, scope: Scope, own_ref: str) -> Tuple[List[int],
                                                            int, int]:
    """Bytecode of one numeric value expression over the row's own columns
    (an aggregation's argument, kernel K27): (words, the result's type
    code, its null kind).  The kernel reads the top of the stack as the
    value instead of testing it."""
    code: List[int] = []
    t = _emit(expr, scope, own_ref, {}, code)
    if t.type not in ("INT", "LONG", "FLOAT", "DOUBLE"):
        raise CompileError(f"value expression of type {t.type} is not "
                           f"numeric")
    return code, type_code(t.type), null_kind(t.type)


def _emit(expr, scope, own_ref, atom_of_ref, code,
          other_ref=None) -> CompiledExpr:
    """Append expr's words; returns a CompiledExpr carrying its static type
    (and constness) for the caller's typing decisions."""
    if isinstance(expr, Constant):
        if expr.type == "STRING":
            value = scope.interner.intern(expr.value)
        else:
            value = expr.value
        if expr.type.upper() == "OBJECT":
            raise CompileError("object constants are outside the kernel "
                               "filter subset")
        code += [CONST, *_words(value, expr.type)]
        return CompiledExpr(None, expr.type, True, expr.value)

    if isinstance(expr, Variable):
        key, pos, t = scope.resolve(expr)
        own = key in (own_ref, other_ref) and expr.stream_index is None
        if _DEPTHS is not None and not own:
            si = atom_of_ref[key]
            d = expr.stream_index or 0
            d = d if d >= 0 else -1
            if d >= _DEPTHS[si]:
                raise CompileError(
                    f"{key}[{d}] is past the capture depth "
                    f"{_DEPTHS[si]} of {key!r}")
            code += [LOAD_CAPD, si, pos, d]
            return CompiledExpr(None, t)
        if expr.stream_index not in (None, 0, -1):
            raise CompileError("capture index beyond depth 1 is outside the "
                               "kernel filter subset")
        if key == own_ref and expr.stream_index is None:
            code += [LOAD_EV, pos]
        elif key == other_ref and expr.stream_index is None:
            code += [LOAD_OTHER, pos]
        else:
            code += [LOAD_CAP, atom_of_ref[key], pos]
        return CompiledExpr(None, t)

    if isinstance(expr, (Add, Subtract, Multiply, Divide)):
        l = _emit(expr.left, scope, own_ref, atom_of_ref, code, other_ref)
        r = _emit(expr.right, scope, own_ref, atom_of_ref, code, other_ref)
        t = promote(l.type, r.type)
        code += [ARITH, _ARITH_OPS[type(expr)], type_code(t),
                 type_code(l.type), type_code(r.type),
                 null_kind(l.type) if maybe_null(l) else N_NONE,
                 null_kind(r.type) if maybe_null(r) else N_NONE]
        return CompiledExpr(None, t)

    if isinstance(expr, Compare):
        l = _emit(expr.left, scope, own_ref, atom_of_ref, code, other_ref)
        r = _emit(expr.right, scope, own_ref, atom_of_ref, code, other_ref)
        if l.type == "STRING" and r.type == "STRING":
            if expr.operator not in ("==", "!="):
                raise CompileError(
                    "string ordering comparisons are not supported on device")
        elif l.type != "BOOL" and r.type != "BOOL":
            promote(l.type, r.type)
        cd = compare_dtype(ev.dtype_of(l.type), ev.dtype_of(r.type))
        code += [CMP, _CMP_OPS[expr.operator], _DTYPE_CODE[cd],
                 type_code(l.type), type_code(r.type),
                 null_kind(l.type) if maybe_null(l) else N_NONE,
                 null_kind(r.type) if maybe_null(r) else N_NONE]
        return CompiledExpr(None, "BOOL")

    if isinstance(expr, (And, Or)):
        _emit(expr.left, scope, own_ref, atom_of_ref, code, other_ref)
        _emit(expr.right, scope, own_ref, atom_of_ref, code, other_ref)
        code.append(AND if isinstance(expr, And) else OR)
        return CompiledExpr(None, "BOOL")

    if isinstance(expr, Not):
        _emit(expr.expression, scope, own_ref, atom_of_ref, code,
                      other_ref)
        code.append(NOT)
        return CompiledExpr(None, "BOOL")

    if isinstance(expr, IsNull) and expr.expression is not None:
        inner = _emit(expr.expression, scope, own_ref, atom_of_ref, code,
                      other_ref)
        code += [ISNULL, null_kind(inner.type) if maybe_null(inner)
                 else N_NONE]
        return CompiledExpr(None, "BOOL")

    if isinstance(expr, In):
        if _IN_KEYS is None or expr.source_id not in _IN_KEYS.col0_types:
            raise CompileError(
                "'in Table' here is outside the kernels' subset "
                "(ROADMAP B-probe)")
        inner = _emit(expr.expression, scope, own_ref, atom_of_ref, code,
                      other_ref)
        if inner.type in ("OBJECT",):
            raise CompileError("'in' over an object value is outside the "
                               "kernel filter subset")
        ct = _DTYPE_CODE[compare_dtype(
            ev.dtype_of(inner.type),
            ev.dtype_of(_IN_KEYS.col0_types[expr.source_id]))]
        code += [IN, _IN_KEYS.index(expr.source_id, ct), ct,
                 type_code(inner.type),
                 null_kind(inner.type) if maybe_null(inner) else N_NONE]
        return CompiledExpr(None, "BOOL")

    if isinstance(expr, AttributeFunction) and not expr.namespace and \
            expr.name == "coalesce" and expr.parameters:
        acc = _emit(expr.parameters[0], scope, own_ref, atom_of_ref, code,
                    other_ref)
        for a in expr.parameters[1:]:
            c = _emit(a, scope, own_ref, atom_of_ref, code, other_ref)
            if acc.type in ("STRING", "OBJECT"):
                if c.type != acc.type:
                    raise CompileError("coalesce of a string and another "
                                       "type is outside the kernel subset")
                t = acc.type
            else:
                t = promote(acc.type, c.type)
            # null kinds of the values, not of their constness: the
            # executor's coalesce tests every value for the in-band null
            code += [COALESCE, type_code(t), type_code(acc.type),
                     type_code(c.type), null_kind(acc.type),
                     null_kind(c.type), null_kind(t)]
            acc = CompiledExpr(None, t)
        return acc

    raise CompileError(
        f"{type(expr).__name__} is outside the kernel filter subset")


# ---------------------------------------------------------------------------
# plain PyTorch interpreter (the bytecode's reference)
# ---------------------------------------------------------------------------

def _is_null(v, nk: int):
    if nk == N_INT:
        return v == ev.NULL_INT
    if nk == N_LONG:
        return v == ev.NULL_LONG
    if nk == N_NAN:
        return torch.isnan(v)
    if nk == N_ID:
        return v == ev.NULL_ID
    return torch.zeros(v.shape, dtype=torch.bool, device=v.device)


def _int_div(a, b):
    zero = b == 0
    q = torch.where(zero, torch.zeros_like(a), a)
    b = torch.where(zero, torch.ones_like(b), b)
    return torch.sign(q) * torch.sign(b) * (torch.abs(q) // torch.abs(b))


_NULL_OF = {T_I32: ev.NULL_INT, T_I64: ev.NULL_LONG, T_F32: float("nan")}
_CMP_FNS = (torch.lt, torch.le, torch.gt, torch.ge, torch.eq, torch.ne)


_OP_LEN = {LOAD_EV: 2, LOAD_CAP: 3, CONST: 3, ARITH: 7, CMP: 7, AND: 1,
           OR: 1, NOT: 1, ISNULL: 2, LOAD_OTHER: 2, COALESCE: 7, IN: 5,
           LOAD_CAPD: 4}
_IN_KEYS: Optional[InKeys] = None
_DEPTHS: Optional[Dict[int, int]] = None


def cap_loads(code: List[int], with_depth: bool = False) -> List[Tuple]:
    """The distinct (atom or capture set, column) capture words the
    bytecode reads (LOAD_CAP and LOAD_CAPD), in order of first load; with
    `with_depth`, (set, column, depth) with LOAD_CAP at depth 0."""
    out: List[Tuple] = []
    pc = 0
    while pc < len(code):
        if code[pc] in (LOAD_CAP, LOAD_CAPD):
            x = (code[pc + 1], code[pc + 2])
            if with_depth:
                x += (code[pc + 3] if code[pc] == LOAD_CAPD else 0,)
            if x not in out:
                out.append(x)
        pc += _OP_LEN[code[pc]]
    return out


def interpret(code: List[int], load_ev: Callable[[int], torch.Tensor],
              load_cap: Callable[[int, int], torch.Tensor],
              load_other: Optional[Callable[[int], torch.Tensor]] = None,
              load_in: Optional[Callable[[int, torch.Tensor],
                                         torch.Tensor]] = None,
              load_capd: Optional[Callable[[int, int, int],
                                           torch.Tensor]] = None,
              value: bool = False) -> torch.Tensor:
    """Run bytecode over whole columns: `load_ev(col)`,
    `load_cap(atom, col)`, `load_capd(set, col, depth)` and
    `load_other(col)` return tensors of one shape (the keys, or the
    candidate pairs); `load_in(set, values)` is the probe of hash set
    `set` over values already in its compare type.  Returns the bool
    column."""
    stack: List[torch.Tensor] = []
    pc = 0
    while pc < len(code):
        op = code[pc]
        if op == LOAD_EV:
            stack.append(load_ev(code[pc + 1]))
            pc += 2
        elif op == LOAD_CAP:
            stack.append(load_cap(code[pc + 1], code[pc + 2]))
            pc += 3
        elif op == LOAD_CAPD:
            stack.append(load_capd(code[pc + 1], code[pc + 2], code[pc + 3]))
            pc += 4
        elif op == LOAD_OTHER:
            stack.append(load_other(code[pc + 1]))
            pc += 2
        elif op == COALESCE:
            t, lt, rt, lnk, rnk, onk = code[pc + 1:pc + 7]
            b, a = _typed(stack.pop(), rt), _typed(stack.pop(), lt)
            x, y = _null_cast(a, lnk, t, onk), _null_cast(b, rnk, t, onk)
            stack.append(torch.where(_is_null(x, onk), y, x))
            pc += 7
        elif op == CONST:
            lo, hi = code[pc + 1], code[pc + 2]
            v = (hi << 32) | (lo & 0xFFFFFFFF)
            stack.append(torch.tensor(v, dtype=torch.int64))
            pc += 3
        elif op in (ARITH, CMP):
            sub, t, lt, rt, lnk, rnk = code[pc + 1:pc + 7]
            b, a = _typed(stack.pop(), rt), _typed(stack.pop(), lt)
            d = CODE_DTYPE[t]
            x, y = a.to(d), b.to(d)
            if op == ARITH:
                if sub == 3:
                    out = _int_div(x, y) if t != T_F32 else torch.div(x, y)
                else:
                    out = (torch.add, torch.sub, torch.mul)[sub](x, y)
                n = _is_null(a, lnk) | _is_null(b, rnk)
                out = torch.where(n, torch.tensor(_NULL_OF[t], dtype=d), out)
            else:
                out = _CMP_FNS[sub](x, y) & ~_is_null(a, lnk) & \
                    ~_is_null(b, rnk)
            stack.append(out)
            pc += 7
        elif op in (AND, OR):
            b, a = stack.pop().bool(), stack.pop().bool()
            stack.append(a & b if op == AND else a | b)
            pc += 1
        elif op == NOT:
            stack.append(~stack.pop().bool())
            pc += 1
        elif op == ISNULL:
            v = stack.pop()
            stack.append(_is_null(v, code[pc + 1]))
            pc += 2
        elif op == IN:
            si, ct, ot = code[pc + 1:pc + 4]
            v = _typed(stack.pop(), ot).to(CODE_DTYPE[ct])
            stack.append(load_in(si, v))
            pc += 5
        else:
            raise ValueError(f"bad opcode {op} at {pc}")
    if len(stack) != 1:
        raise ValueError("bytecode left an unbalanced stack")
    return stack[0] if value else stack[0].bool()


def _null_cast(v: torch.Tensor, nk: int, t: int, onk: int) -> torch.Tensor:
    """astype to t, with v's nulls (null kind nk) mapped to the null of the
    result (null kind onk)."""
    out = v.to(CODE_DTYPE[t])
    if nk == N_NONE or onk == N_NONE:
        return out
    nv = {N_INT: ev.NULL_INT, N_LONG: ev.NULL_LONG, N_NAN: float("nan"),
          N_ID: ev.NULL_ID}[onk]
    return torch.where(_is_null(v, nk),
                       torch.tensor(nv, dtype=CODE_DTYPE[t]), out)


def _typed(v: torch.Tensor, t: int) -> torch.Tensor:
    """A stack value in its static type (constants arrive as int64 slots
    holding the constant's bits)."""
    d = CODE_DTYPE[t]
    if v.dtype == d:
        return v
    if v.dim() == 0 and v.dtype == torch.int64:
        raw = int(v)
        if t == T_F32:
            bits = raw & 0xFFFFFFFF
            return torch.tensor(
                struct.unpack("<f", struct.pack("<I", bits))[0],
                dtype=torch.float32)
        if t == T_I32:
            return torch.tensor(
                struct.unpack("<i", struct.pack("<I", raw & 0xFFFFFFFF))[0],
                dtype=torch.int32)
        if t == T_BOOL:
            return torch.tensor(bool(raw & 1))
        return v
    return v.to(d)
