"""Expression AST for the SiddhiQL surface.

Mirrors the capability surface of the reference object model
(reference: modules/siddhi-query-api/src/main/java/io/siddhi/query/api/expression/*),
re-designed as plain Python dataclasses that compile to JAX column ops
(see siddhi_tpu/core/executor.py) instead of interpreter object trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


class Expression:
    """Base class for all expressions. Also hosts the fluent constructors
    (reference: QAPI/expression/Expression.java)."""

    # ---- fluent constructors -------------------------------------------------
    @staticmethod
    def value(v: Any) -> "Constant":
        if isinstance(v, bool):
            return Constant(v, "BOOL")
        if isinstance(v, int):
            return Constant(v, "LONG" if abs(v) > 2**31 - 1 else "INT")
        if isinstance(v, float):
            return Constant(v, "DOUBLE")
        if isinstance(v, str):
            return Constant(v, "STRING")
        raise TypeError(f"unsupported constant type: {type(v)}")

    @staticmethod
    def variable(attribute_name: str) -> "Variable":
        return Variable(attribute_name)

    @staticmethod
    def add(a, b):
        return Add(a, b)

    @staticmethod
    def subtract(a, b):
        return Subtract(a, b)

    @staticmethod
    def multiply(a, b):
        return Multiply(a, b)

    @staticmethod
    def divide(a, b):
        return Divide(a, b)

    @staticmethod
    def mod(a, b):
        return Mod(a, b)

    @staticmethod
    def compare(a, op: str, b):
        return Compare(a, op, b)

    @staticmethod
    def and_(a, b):
        return And(a, b)

    @staticmethod
    def or_(a, b):
        return Or(a, b)

    @staticmethod
    def not_(a):
        return Not(a)

    @staticmethod
    def is_null(a):
        return IsNull(a)

    @staticmethod
    def in_(a, source_id: str):
        return In(a, source_id)

    @staticmethod
    def function(name: str, *args, namespace: str = ""):
        return AttributeFunction(namespace, name, list(args))

    class Time:
        """Duration helpers returning LONG milliseconds
        (reference: QAPI/expression/Expression.java Time inner class)."""

        @staticmethod
        def millisec(i: int) -> "Constant":
            return Constant(int(i), "LONG", is_time=True)

        @staticmethod
        def sec(i: int) -> "Constant":
            return Constant(int(i) * 1000, "LONG", is_time=True)

        @staticmethod
        def minute(i: int) -> "Constant":
            return Constant(int(i) * 60 * 1000, "LONG", is_time=True)

        @staticmethod
        def hour(i: int) -> "Constant":
            return Constant(int(i) * 60 * 60 * 1000, "LONG", is_time=True)

        @staticmethod
        def day(i: int) -> "Constant":
            return Constant(int(i) * 24 * 60 * 60 * 1000, "LONG", is_time=True)

        @staticmethod
        def week(i: int) -> "Constant":
            return Constant(int(i) * 7 * 24 * 60 * 60 * 1000, "LONG", is_time=True)

        @staticmethod
        def month(i: int) -> "Constant":
            return Constant(int(i) * 30 * 24 * 60 * 60 * 1000, "LONG", is_time=True)

        @staticmethod
        def year(i: int) -> "Constant":
            return Constant(int(i) * 365 * 24 * 60 * 60 * 1000, "LONG", is_time=True)


class Constant(Expression):
    # plain class (not a dataclass): the field name `value` would collide with
    # Expression.value's staticmethod under dataclass field discovery
    def __init__(self, value: Any, type: str, is_time: bool = False):
        self.value = value
        self.type = type  # STRING INT LONG FLOAT DOUBLE BOOL
        self.is_time = is_time

    def __repr__(self):
        return f"Constant({self.value!r}:{self.type})"

    def __eq__(self, other):
        return (isinstance(other, Constant) and self.value == other.value
                and self.type == other.type)


@dataclasses.dataclass
class Variable(Expression):
    attribute_name: str
    stream_id: Optional[str] = None     # explicit `stream.attr` reference
    stream_index: Optional[int] = None  # pattern event index  e[2].attr ; -1 == LAST
    function_id: Optional[str] = None

    def of_stream(self, stream_id: str, idx: Optional[int] = None) -> "Variable":
        self.stream_id = stream_id
        self.stream_index = idx
        return self


@dataclasses.dataclass
class _Binary(Expression):
    left: Expression
    right: Expression


class Add(_Binary):
    pass


class Subtract(_Binary):
    pass


class Multiply(_Binary):
    pass


class Divide(_Binary):
    pass


class Mod(_Binary):
    pass


@dataclasses.dataclass
class Compare(Expression):
    left: Expression
    operator: str  # '<' '<=' '>' '>=' '==' '!='
    right: Expression


class And(_Binary):
    pass


class Or(_Binary):
    pass


@dataclasses.dataclass
class Not(Expression):
    expression: Expression


@dataclasses.dataclass
class IsNull(Expression):
    expression: Optional[Expression] = None
    stream_id: Optional[str] = None
    stream_index: Optional[int] = None


@dataclasses.dataclass
class In(Expression):
    expression: Expression
    source_id: str  # table/window to probe


@dataclasses.dataclass
class AttributeFunction(Expression):
    namespace: str
    name: str
    parameters: List[Expression]


def walk(expr: Expression):
    """Yield every node of an expression tree."""
    yield expr
    if isinstance(expr, (_Binary, Compare)):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, Not):
        yield from walk(expr.expression)
    elif isinstance(expr, IsNull) and expr.expression is not None:
        yield from walk(expr.expression)
    elif isinstance(expr, In):
        yield from walk(expr.expression)
    elif isinstance(expr, AttributeFunction):
        for p in expr.parameters:
            yield from walk(p)
