"""Query object model: input streams, handlers, selectors, output, rate limiting.

Reference: modules/siddhi-query-api/.../execution/query/* (Query.java,
input/stream/{SingleInputStream,JoinInputStream,StateInputStream}.java,
input/handler/{Filter,Window,StreamFunction}.java, input/state/*.java,
selection/Selector.java, output/stream/*.java, output/ratelimit/*.java).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, Union

from .definition import Annotation
from .expression import Expression, Variable


# ---------------------------------------------------------------------------
# Stream handlers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Filter:
    expression: Expression


@dataclasses.dataclass
class Window:
    namespace: str
    name: str          # time, length, lengthBatch, timeBatch, session, sort, ...
    parameters: List[Expression]


@dataclasses.dataclass
class StreamFunction:
    namespace: str
    name: str
    parameters: List[Expression]


StreamHandler = Union[Filter, Window, StreamFunction]


# ---------------------------------------------------------------------------
# Input streams
# ---------------------------------------------------------------------------

class InputStream:
    @staticmethod
    def stream(stream_id: str, ref_id: Optional[str] = None) -> "SingleInputStream":
        return SingleInputStream(stream_id, ref_id)

    @staticmethod
    def join_stream(left, join_type, right, on=None, within=None, per=None,
                    trigger="ALL_EVENTS") -> "JoinInputStream":
        return JoinInputStream(left, join_type, right, on, within, per, trigger)

    @staticmethod
    def pattern_stream(state_element, within=None) -> "StateInputStream":
        return StateInputStream("PATTERN", state_element, within)

    @staticmethod
    def sequence_stream(state_element, within=None) -> "StateInputStream":
        return StateInputStream("SEQUENCE", state_element, within)


class SingleInputStream(InputStream):
    def __init__(self, stream_id: str, ref_id: Optional[str] = None,
                 is_inner: bool = False, is_fault: bool = False):
        self.stream_id = stream_id
        self.stream_reference_id = ref_id
        self.is_inner_stream = is_inner
        self.is_fault_stream = is_fault
        self.stream_handlers: List[StreamHandler] = []

    @property
    def unique_stream_id(self) -> str:
        base = self.stream_id
        if self.is_inner_stream:
            base = "#" + base
        if self.is_fault_stream:
            base = "!" + base
        return base

    def filter(self, expr: Expression) -> "SingleInputStream":
        self.stream_handlers.append(Filter(expr))
        return self

    def window(self, name: str, *params: Expression, namespace: str = "") -> "SingleInputStream":
        self.stream_handlers.append(Window(namespace, name, list(params)))
        return self

    def function(self, name: str, *params: Expression, namespace: str = "") -> "SingleInputStream":
        self.stream_handlers.append(StreamFunction(namespace, name, list(params)))
        return self

    @property
    def window_handler(self) -> Optional[Window]:
        for h in self.stream_handlers:
            if isinstance(h, Window):
                return h
        return None


class JoinInputStream(InputStream):
    JOIN = "JOIN"
    INNER_JOIN = "JOIN"
    LEFT_OUTER_JOIN = "LEFT_OUTER_JOIN"
    RIGHT_OUTER_JOIN = "RIGHT_OUTER_JOIN"
    FULL_OUTER_JOIN = "FULL_OUTER_JOIN"

    def __init__(self, left: SingleInputStream, join_type: str,
                 right: SingleInputStream, on: Optional[Expression],
                 within=None, per=None, trigger: str = "ALL_EVENTS"):
        self.left_input_stream = left
        self.type = join_type
        self.right_input_stream = right
        self.on_compare = on
        self.within = within      # for aggregation joins
        self.per = per            # for aggregation joins
        self.trigger = trigger    # LEFT / RIGHT / ALL_EVENTS


# ---------------------------------------------------------------------------
# Pattern / sequence state elements
# ---------------------------------------------------------------------------

class StateElement:
    pass


@dataclasses.dataclass
class StreamStateElement(StateElement):
    basic_single_input_stream: SingleInputStream
    within: Optional[int] = None  # ms


@dataclasses.dataclass
class AbsentStreamStateElement(StateElement):
    """not A for 1 sec — absence detection with waiting time."""
    basic_single_input_stream: SingleInputStream
    waiting_time: Optional[int] = None  # ms
    within: Optional[int] = None


@dataclasses.dataclass
class CountStateElement(StateElement):
    stream_state_element: StreamStateElement
    min_count: int
    max_count: int  # -1 == ANY/unbounded
    within: Optional[int] = None
    ANY = -1


@dataclasses.dataclass
class LogicalStateElement(StateElement):
    stream_state_element_1: StateElement
    type: str  # 'AND' | 'OR'
    stream_state_element_2: StateElement
    within: Optional[int] = None


@dataclasses.dataclass
class NextStateElement(StateElement):
    state_element: StateElement
    next_state_element: StateElement
    within: Optional[int] = None


@dataclasses.dataclass
class EveryStateElement(StateElement):
    state_element: StateElement
    within: Optional[int] = None


class StateInputStream(InputStream):
    def __init__(self, state_type: str, state_element: StateElement,
                 within: Optional[int] = None):
        self.state_type = state_type  # 'PATTERN' | 'SEQUENCE'
        self.state_element = state_element
        self.within_time = within

    @property
    def all_stream_ids(self) -> List[str]:
        out: List[str] = []

        def rec(el):
            if isinstance(el, (StreamStateElement, AbsentStreamStateElement)):
                sid = el.basic_single_input_stream.stream_id
                if sid not in out:
                    out.append(sid)
            elif isinstance(el, CountStateElement):
                rec(el.stream_state_element)
            elif isinstance(el, LogicalStateElement):
                rec(el.stream_state_element_1)
                rec(el.stream_state_element_2)
            elif isinstance(el, NextStateElement):
                rec(el.state_element)
                rec(el.next_state_element)
            elif isinstance(el, EveryStateElement):
                rec(el.state_element)

        rec(self.state_element)
        return out


# ---------------------------------------------------------------------------
# Selector
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OutputAttribute:
    rename: Optional[str]
    expression: Expression

    @property
    def name(self) -> str:
        if self.rename:
            return self.rename
        if isinstance(self.expression, Variable):
            return self.expression.attribute_name
        raise ValueError("projection expression needs an explicit alias (as)")


@dataclasses.dataclass
class OrderByAttribute:
    variable: Variable
    order: str = "ASC"  # ASC | DESC


class Selector:
    def __init__(self):
        self.selection_list: List[OutputAttribute] = []
        self.group_by_list: List[Variable] = []
        self.having_expression: Optional[Expression] = None
        self.order_by_list: List[OrderByAttribute] = []
        self.limit: Optional[int] = None
        self.offset: Optional[int] = None

    @staticmethod
    def selector() -> "Selector":
        return Selector()

    def select(self, rename_or_expr, expr: Optional[Expression] = None) -> "Selector":
        if expr is None:
            self.selection_list.append(OutputAttribute(None, rename_or_expr))
        else:
            self.selection_list.append(OutputAttribute(rename_or_expr, expr))
        return self

    def group_by(self, var: Variable) -> "Selector":
        self.group_by_list.append(var)
        return self

    def having(self, expr: Expression) -> "Selector":
        self.having_expression = expr
        return self

    def order_by(self, var: Variable, order: str = "ASC") -> "Selector":
        self.order_by_list.append(OrderByAttribute(var, order))
        return self

    def limit_count(self, n: int) -> "Selector":
        self.limit = n
        return self

    def offset_count(self, n: int) -> "Selector":
        self.offset = n
        return self

    @property
    def is_select_all(self) -> bool:
        return not self.selection_list


# ---------------------------------------------------------------------------
# Output streams & rate limiting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OutputStream:
    target_id: str
    output_event_type: Optional[str] = None  # CURRENT_EVENTS / EXPIRED_EVENTS / ALL_EVENTS


class InsertIntoStream(OutputStream):
    def __init__(self, target_id: str, output_event_type=None,
                 is_inner: bool = False, is_fault: bool = False):
        super().__init__(target_id, output_event_type)
        self.is_inner_stream = is_inner
        self.is_fault_stream = is_fault


class ReturnStream(OutputStream):
    def __init__(self, output_event_type=None):
        super().__init__("", output_event_type)


@dataclasses.dataclass
class UpdateSetAttribute:
    table_variable: Variable
    value_expression: Expression


class UpdateSet:
    def __init__(self):
        self.set_attribute_list: List[UpdateSetAttribute] = []

    def set(self, table_var: Variable, value: Expression) -> "UpdateSet":
        self.set_attribute_list.append(UpdateSetAttribute(table_var, value))
        return self


class DeleteStream(OutputStream):
    def __init__(self, target_id: str, on: Expression, output_event_type=None):
        super().__init__(target_id, output_event_type)
        self.on_delete_expression = on


class UpdateStream(OutputStream):
    def __init__(self, target_id: str, on: Expression,
                 update_set: Optional[UpdateSet] = None, output_event_type=None):
        super().__init__(target_id, output_event_type)
        self.on_update_expression = on
        self.update_set = update_set


class UpdateOrInsertStream(OutputStream):
    def __init__(self, target_id: str, on: Expression,
                 update_set: Optional[UpdateSet] = None, output_event_type=None):
        super().__init__(target_id, output_event_type)
        self.on_update_expression = on
        self.update_set = update_set


class OutputRate:
    """output [all|first|last] every N events / every <time> | output snapshot every <time>."""

    def __init__(self, type: str, value, behavior: str = "ALL"):
        self.type = type        # 'EVENTS' | 'TIME' | 'SNAPSHOT'
        self.value = value      # event count or ms
        self.behavior = behavior  # ALL | FIRST | LAST

    @staticmethod
    def per_events(n: int, behavior: str = "ALL") -> "OutputRate":
        return OutputRate("EVENTS", n, behavior)

    @staticmethod
    def per_time(ms: int, behavior: str = "ALL") -> "OutputRate":
        return OutputRate("TIME", ms, behavior)

    @staticmethod
    def per_snapshot(ms: int) -> "OutputRate":
        return OutputRate("SNAPSHOT", ms)


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

class Query:
    def __init__(self):
        self.input_stream: Optional[InputStream] = None
        self.selector: Selector = Selector()
        self.output_stream: Optional[OutputStream] = None
        self.output_rate: Optional[OutputRate] = None
        self.annotations: List[Annotation] = []

    @staticmethod
    def query() -> "Query":
        return Query()

    def from_(self, input_stream: InputStream) -> "Query":
        self.input_stream = input_stream
        return self

    def select(self, selector: Selector) -> "Query":
        self.selector = selector
        return self

    def insert_into(self, stream_id: str, event_type=None) -> "Query":
        self.output_stream = InsertIntoStream(stream_id, event_type)
        return self

    def return_output(self, event_type=None) -> "Query":
        self.output_stream = ReturnStream(event_type)
        return self

    def output(self, rate: OutputRate) -> "Query":
        self.output_rate = rate
        return self

    def annotation(self, ann: Annotation) -> "Query":
        self.annotations.append(ann)
        return self

    def get_annotation(self, name: str) -> Optional[Annotation]:
        for a in self.annotations:
            if a.name.lower() == name.lower():
                return a
        return None


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RangePartitionProperty:
    partition_key: str      # label
    condition: Expression


class PartitionType:
    pass


@dataclasses.dataclass
class ValuePartitionType(PartitionType):
    stream_id: str
    expression: Expression


@dataclasses.dataclass
class RangePartitionType(PartitionType):
    stream_id: str
    ranges: List[RangePartitionProperty]


class Partition:
    def __init__(self):
        self.partition_type_map: dict = {}  # stream_id -> PartitionType
        self.query_list: List[Query] = []
        self.annotations: List[Annotation] = []

    @staticmethod
    def partition() -> "Partition":
        return Partition()

    def with_(self, stream_id: str, expr_or_ranges) -> "Partition":
        if isinstance(expr_or_ranges, list):
            self.partition_type_map[stream_id] = RangePartitionType(stream_id, expr_or_ranges)
        else:
            self.partition_type_map[stream_id] = ValuePartitionType(stream_id, expr_or_ranges)
        return self

    def add_query(self, query: Query) -> "Partition":
        self.query_list.append(query)
        return self


ExecutionElement = Union[Query, Partition]


# ---------------------------------------------------------------------------
# On-demand (store) queries
# ---------------------------------------------------------------------------

class OnDemandQuery:
    """One-shot query against tables/windows/aggregations.
    Reference: QAPI/execution/query/StoreQuery.java / OnDemandQuery.java"""

    def __init__(self):
        self.input_store = None           # InputStore
        self.selector: Selector = Selector()
        self.output_stream: Optional[OutputStream] = None
        self.type: str = "FIND"           # FIND | INSERT | UPDATE | DELETE | UPDATE_OR_INSERT

    @staticmethod
    def query() -> "OnDemandQuery":
        return OnDemandQuery()

    def from_(self, input_store) -> "OnDemandQuery":
        self.input_store = input_store
        return self

    def select(self, selector: Selector) -> "OnDemandQuery":
        self.selector = selector
        return self


@dataclasses.dataclass
class InputStore:
    store_id: str
    on_condition: Optional[Expression] = None
    within: Optional[Tuple[Any, Any]] = None  # aggregation within
    per: Optional[Expression] = None          # aggregation per duration

    @staticmethod
    def store(store_id: str) -> "InputStore":
        return InputStore(store_id)

    def on(self, condition: Expression) -> "InputStore":
        self.on_condition = condition
        return self
