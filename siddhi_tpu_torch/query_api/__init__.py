"""Object model / AST for SiddhiQL apps (fluent Python builder).

Reference module: modules/siddhi-query-api (9.7k LoC Java) — re-expressed as
Python dataclasses; see SURVEY.md L8b.
"""
from .app import SiddhiApp
from .definition import (
    AbstractDefinition,
    AggregationDefinition,
    Annotation,
    Attribute,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
from .expression import (
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
from .query import (
    AbsentStreamStateElement,
    CountStateElement,
    DeleteStream,
    EveryStateElement,
    Filter,
    InputStore,
    InputStream,
    InsertIntoStream,
    JoinInputStream,
    LogicalStateElement,
    NextStateElement,
    OnDemandQuery,
    OrderByAttribute,
    OutputAttribute,
    OutputRate,
    OutputStream,
    Partition,
    Query,
    RangePartitionProperty,
    RangePartitionType,
    ReturnStream,
    Selector,
    SingleInputStream,
    StateInputStream,
    StreamFunction,
    StreamStateElement,
    UpdateOrInsertStream,
    UpdateSet,
    UpdateStream,
    ValuePartitionType,
    Window,
)

__all__ = [n for n in dir() if not n.startswith("_")]
