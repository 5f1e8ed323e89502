"""Stream/table/window/trigger/aggregation definitions.

Reference: modules/siddhi-query-api/.../definition/* (StreamDefinition.java,
TableDefinition.java, WindowDefinition.java, TriggerDefinition.java,
AggregationDefinition.java, FunctionDefinition.java, Attribute.java).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


class Attribute:
    class Type:
        STRING = "STRING"
        INT = "INT"
        LONG = "LONG"
        FLOAT = "FLOAT"
        DOUBLE = "DOUBLE"
        BOOL = "BOOL"
        OBJECT = "OBJECT"

    ALL_TYPES = ("STRING", "INT", "LONG", "FLOAT", "DOUBLE", "BOOL", "OBJECT")

    def __init__(self, name: str, type: str):
        type = type.upper()
        if type not in self.ALL_TYPES:
            raise ValueError(f"unknown attribute type {type!r}")
        self.name = name
        self.type = type

    def __repr__(self):
        return f"Attribute({self.name}:{self.type})"

    def __eq__(self, other):
        return (
            isinstance(other, Attribute)
            and self.name == other.name
            and self.type == other.type
        )


@dataclasses.dataclass
class Annotation:
    """@name(element='v', ...) annotations (reference: QAPI/annotation/Annotation.java)."""

    name: str
    elements: Dict[Optional[str], Any] = dataclasses.field(default_factory=dict)
    annotations: List["Annotation"] = dataclasses.field(default_factory=list)

    def element(self, key: Optional[str] = None, default: Any = None) -> Any:
        return self.elements.get(key, default)

    def positional_elements(self) -> List[Any]:
        """All positional (key-less) elements in source order.  The parser
        stores the first under None and later ones under synthetic '__pN'
        keys (dicts cannot repeat None); consumers must use this instead of
        filtering elements by key."""
        return [v for k, v in self.elements.items()
                if k is None or str(k).startswith("__p")]

    def named_elements(self) -> Dict[str, Any]:
        """Key=value elements only (no positionals, no synthetic keys)."""
        return {k: v for k, v in self.elements.items()
                if k is not None and not str(k).startswith("__p")}


class AbstractDefinition:
    def __init__(self, id: str):
        self.id = id
        self.attribute_list: List[Attribute] = []
        self.annotations: List[Annotation] = []

    def attribute(self, name: str, type: str) -> "AbstractDefinition":
        if any(a.name == name for a in self.attribute_list):
            raise ValueError(f"duplicate attribute {name!r} in {self.id!r}")
        self.attribute_list.append(Attribute(name, type))
        return self

    def annotation(self, ann: Annotation) -> "AbstractDefinition":
        self.annotations.append(ann)
        return self

    def get_annotation(self, name: str) -> Optional[Annotation]:
        for a in self.annotations:
            if a.name.lower() == name.lower():
                return a
        return None

    @property
    def attribute_names(self) -> List[str]:
        return [a.name for a in self.attribute_list]

    def attribute_type(self, name: str) -> str:
        for a in self.attribute_list:
            if a.name == name:
                return a.type
        raise KeyError(f"attribute {name!r} not found in {self.id!r}")

    def attribute_position(self, name: str) -> int:
        for i, a in enumerate(self.attribute_list):
            if a.name == name:
                return i
        raise KeyError(f"attribute {name!r} not found in {self.id!r}")

    def __repr__(self):
        return f"{type(self).__name__}({self.id}, {self.attribute_list})"


class StreamDefinition(AbstractDefinition):
    @staticmethod
    def id(stream_id: str) -> "StreamDefinition":
        return StreamDefinition(stream_id)


class TableDefinition(AbstractDefinition):
    @staticmethod
    def id(table_id: str) -> "TableDefinition":
        return TableDefinition(table_id)


class WindowDefinition(AbstractDefinition):
    """define window W(attrs) window.type(args) [output current/expired/all events]."""

    def __init__(self, id: str):
        super().__init__(id)
        self.window = None           # query_api.query.Window handler
        self.output_event_type = "ALL_EVENTS"

    @staticmethod
    def id(window_id: str) -> "WindowDefinition":
        return WindowDefinition(window_id)


class TriggerDefinition:
    """define trigger T at {'start' | every <time> | 'cron expr'}.
    Reference: QAPI/definition/TriggerDefinition.java"""

    def __init__(self, id: str):
        self.id = id
        self.at_every: Optional[int] = None  # period ms
        self.at: Optional[str] = None        # 'start' or cron expression
        self.annotations: List[Annotation] = []

    @staticmethod
    def id(trigger_id: str) -> "TriggerDefinition":
        return TriggerDefinition(trigger_id)


class FunctionDefinition:
    """define function f[lang] return type { body } (script functions)."""

    def __init__(self, id: str = ""):
        self.id = id
        self.language = ""
        self.body = ""
        self.return_type = "OBJECT"


class AggregationDefinition(AbstractDefinition):
    """define aggregation A from S select ... group by ... aggregate by ts every sec...year.
    Reference: QAPI/definition/AggregationDefinition.java"""

    DURATIONS = ("SECONDS", "MINUTES", "HOURS", "DAYS", "MONTHS", "YEARS")

    def __init__(self, id: str):
        super().__init__(id)
        self.basic_single_input_stream = None  # query.SingleInputStream
        self.selector = None                   # query.Selector
        self.aggregate_attribute = None        # Variable or None (-> event ts)
        self.time_periods: List[str] = []      # subset of DURATIONS, ordered

    @staticmethod
    def id(agg_id: str) -> "AggregationDefinition":
        return AggregationDefinition(agg_id)
