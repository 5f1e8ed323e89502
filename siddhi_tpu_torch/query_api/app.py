"""SiddhiApp: the top-level AST / fluent builder.

Reference: modules/siddhi-query-api/.../SiddhiApp.java
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .definition import (
    AbstractDefinition,
    AggregationDefinition,
    Annotation,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
from .query import ExecutionElement, Partition, Query


class SiddhiApp:
    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.stream_definition_map: Dict[str, StreamDefinition] = {}
        self.table_definition_map: Dict[str, TableDefinition] = {}
        self.window_definition_map: Dict[str, WindowDefinition] = {}
        self.trigger_definition_map: Dict[str, TriggerDefinition] = {}
        self.aggregation_definition_map: Dict[str, AggregationDefinition] = {}
        self.function_definition_map: Dict[str, FunctionDefinition] = {}
        self.execution_element_list: List[ExecutionElement] = []
        self.annotations: List[Annotation] = []

    @staticmethod
    def siddhi_app(name: Optional[str] = None) -> "SiddhiApp":
        return SiddhiApp(name)

    def _check_duplicate(self, kind: str, d) -> None:
        """One id names ONE definition: redefinition with a different
        schema, a different kind (stream vs table vs window), or — for
        windows — a different window function is an error; an identical
        re-definition is a no-op (reference: DuplicateDefinitionException,
        AbstractDefinition.equalsIgnoreAnnotations)."""
        from ..exceptions import DuplicateDefinitionError
        for other_kind, dmap in (("stream", self.stream_definition_map),
                                 ("table", self.table_definition_map),
                                 ("window", self.window_definition_map)):
            existing = dmap.get(d.id)
            if existing is None:
                continue
            if other_kind != kind:
                raise DuplicateDefinitionError(
                    f"{d.id!r} is already defined as a {other_kind}")
            if existing.attribute_list != d.attribute_list:
                raise DuplicateDefinitionError(
                    f"{d.id!r} is already defined with a different schema")
            if kind == "window" and self._window_spec(existing) != \
                    self._window_spec(d):
                raise DuplicateDefinitionError(
                    f"window {d.id!r} is already defined with a different "
                    f"window function")

    @staticmethod
    def _window_spec(wd):
        w = wd.window
        return (None if w is None else (w.namespace, w.name,
                                        [repr(p) for p in w.parameters]),
                wd.output_event_type)

    def define_stream(self, d: StreamDefinition) -> "SiddhiApp":
        self._check_duplicate("stream", d)
        self.stream_definition_map[d.id] = d
        return self

    def define_table(self, d: TableDefinition) -> "SiddhiApp":
        self._check_duplicate("table", d)
        self.table_definition_map[d.id] = d
        return self

    def define_window(self, d: WindowDefinition) -> "SiddhiApp":
        self._check_duplicate("window", d)
        self.window_definition_map[d.id] = d
        return self

    def define_trigger(self, d: TriggerDefinition) -> "SiddhiApp":
        self.trigger_definition_map[d.id] = d
        # a trigger implicitly defines a stream <id> (triggered_time long)
        sd = StreamDefinition(d.id).attribute("triggered_time", "LONG")
        self.stream_definition_map[d.id] = sd
        return self

    def define_aggregation(self, d: AggregationDefinition) -> "SiddhiApp":
        self.aggregation_definition_map[d.id] = d
        return self

    def define_function(self, d: FunctionDefinition) -> "SiddhiApp":
        self.function_definition_map[d.id] = d
        return self

    def add_query(self, q: Query) -> "SiddhiApp":
        self.execution_element_list.append(q)
        return self

    def add_partition(self, p: Partition) -> "SiddhiApp":
        self.execution_element_list.append(p)
        return self

    def annotation(self, ann: Annotation) -> "SiddhiApp":
        self.annotations.append(ann)
        return self

    def get_annotation(self, name: str) -> Optional[Annotation]:
        for a in self.annotations:
            if a.name.lower() == name.lower():
                return a
        return None

    def definition(self, id: str) -> AbstractDefinition:
        for m in (
            self.stream_definition_map,
            self.table_definition_map,
            self.window_definition_map,
            self.aggregation_definition_map,
        ):
            if id in m:
                return m[id]
        raise KeyError(f"no definition for {id!r}")
