"""SiddhiQL compiler front-end.

Reference: modules/siddhi-query-compiler (SiddhiCompiler.java:63 + ANTLR4
grammar SiddhiQL.g4 + SiddhiQLBaseVisitorImpl.java) — re-implemented as a
hand-rolled tokenizer + recursive-descent parser producing the query_api AST.
"""
from __future__ import annotations

import os
import re

from ..query_api.app import SiddhiApp
from ..query_api.query import OnDemandQuery, Partition, Query
from ..query_api.definition import StreamDefinition
from .parser import Parser
from .tokenizer import SiddhiParserException

_VAR_RE = re.compile(r"\$\{(\w+)\}")


class SiddhiCompiler:
    @staticmethod
    def update_variables(text: str) -> str:
        """${var} substitution from the environment
        (reference: SiddhiCompiler.updateVariables QC/SiddhiCompiler.java:233)."""
        def sub(m):
            name = m.group(1)
            val = os.environ.get(name)
            if val is None:
                raise SiddhiParserException(
                    f"no system or environment variable found for ${{{name}}}")
            return val
        return _VAR_RE.sub(sub, text)

    @staticmethod
    def parse(text: str) -> SiddhiApp:
        return Parser(SiddhiCompiler.update_variables(text)).parse_app()

    @staticmethod
    def parse_query(text: str) -> Query:
        return Parser(text).parse_query()

    @staticmethod
    def parse_stream_definition(text: str) -> StreamDefinition:
        app = Parser(text).parse_app()
        return next(iter(app.stream_definition_map.values()))

    @staticmethod
    def parse_partition(text: str) -> Partition:
        return Parser(text).parse_partition()

    @staticmethod
    def parse_on_demand_query(text: str) -> OnDemandQuery:
        return Parser(text).parse_on_demand_query()

    parseOnDemandQuery = parse_on_demand_query
    parseQuery = parse_query
    updateVariables = update_variables
