"""SiddhiQL recursive-descent parser -> query_api AST.

Covers the rule surface of the reference grammar
(modules/siddhi-query-compiler/.../SiddhiQL.g4, 918 lines) and the AST
construction role of SiddhiQLBaseVisitorImpl.java (3k LoC): app/stream/table/
window/trigger/function/aggregation definitions, queries (standard, join,
pattern, sequence), partitions, on-demand (store) queries, annotations,
expressions with the reference's precedence ladder, and time literals.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..query_api.app import SiddhiApp
from ..query_api.definition import (
    AggregationDefinition,
    Annotation,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
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
from ..query_api.query import (
    AbsentStreamStateElement,
    CountStateElement,
    DeleteStream,
    EveryStateElement,
    InputStore,
    InsertIntoStream,
    JoinInputStream,
    LogicalStateElement,
    NextStateElement,
    OnDemandQuery,
    OutputAttribute,
    OutputRate,
    Partition,
    Query,
    RangePartitionProperty,
    ReturnStream,
    Selector,
    SingleInputStream,
    StateInputStream,
    StreamStateElement,
    UpdateOrInsertStream,
    UpdateSet,
    UpdateStream,
    Window,
)
from .tokenizer import SiddhiParserException, Token, tokenize

_TIME_UNITS = {
    "millisecond": 1, "milliseconds": 1, "millisec": 1, "ms": 1,
    "second": 1000, "seconds": 1000, "sec": 1000,
    "minute": 60_000, "minutes": 60_000, "min": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "week": 604_800_000, "weeks": 604_800_000,
    "month": 2_592_000_000, "months": 2_592_000_000,
    "year": 31_536_000_000, "years": 31_536_000_000,
}

_DURATION_NAMES = {
    "sec": "SECONDS", "seconds": "SECONDS", "second": "SECONDS",
    "min": "MINUTES", "minutes": "MINUTES", "minute": "MINUTES",
    "hour": "HOURS", "hours": "HOURS",
    "day": "DAYS", "days": "DAYS",
    "week": "WEEKS", "weeks": "WEEKS",
    "month": "MONTHS", "months": "MONTHS",
    "year": "YEARS", "years": "YEARS",
}

_ATTR_TYPES = {"string", "int", "long", "float", "double", "bool", "object"}

# keywords that terminate a query-input token scan
_SECTION_KWS = {"select", "insert", "delete", "update", "return", "output"}


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.pos = 0

    def _at(self, node, tok: Token):
        """Attach the source position of `tok` to an AST node as
        `node.pos = (line, col)` — the static analyzer cites findings as
        `app.siddhi:line:col` from these, and they ride along for any
        later diagnostic.  Never overwrites a position set deeper in the
        parse (the first token of a subtree wins)."""
        if getattr(node, "pos", None) is None:
            try:
                node.pos = (tok.line, tok.col)
            except AttributeError:   # slotted/frozen node: skip silently
                pass
        return node

    # ---- token helpers -----------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        return self.toks[min(self.pos + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at_kw(self, *kws: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "ID" and t.lower in kws

    def at_punct(self, p: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "PUNCT" and t.text == p

    def eat_kw(self, *kws: str) -> Optional[Token]:
        if self.at_kw(*kws):
            return self.next()
        return None

    def expect_kw(self, *kws: str) -> Token:
        t = self.next()
        if t.kind != "ID" or t.lower not in kws:
            raise SiddhiParserException(
                f"expected {'/'.join(kws)!r}, got {t.text!r}", t.line, t.col)
        return t

    def eat_punct(self, p: str) -> Optional[Token]:
        if self.at_punct(p):
            return self.next()
        return None

    def expect_punct(self, p: str) -> Token:
        t = self.next()
        if t.kind != "PUNCT" or t.text != p:
            raise SiddhiParserException(
                f"expected {p!r}, got {t.text!r}", t.line, t.col)
        return t

    def expect_name(self) -> str:
        t = self.next()
        if t.kind != "ID":
            raise SiddhiParserException(
                f"expected identifier, got {t.text!r}", t.line, t.col)
        return t.text

    def err(self, msg: str):
        t = self.peek()
        raise SiddhiParserException(msg + f" near {t.text!r}", t.line, t.col)

    # ---- app ---------------------------------------------------------------
    def parse_app(self) -> SiddhiApp:
        app = SiddhiApp()
        while self.at_punct("@") and self._is_app_annotation():
            ann = self.parse_annotation()
            app.annotation(ann)
            if ann.name.lower() == "app:name":
                app.name = ann.element() or ann.element("name")
        while True:
            while self.eat_punct(";"):
                pass
            if self.peek().kind == "EOF":
                break
            anns = []
            while self.at_punct("@"):
                anns.append(self.parse_annotation())
            if self.at_kw("define"):
                self._parse_definition(app, anns)
            elif self.at_kw("from"):
                q = self.parse_query()
                q.annotations = anns + q.annotations
                app.add_query(q)
            elif self.at_kw("partition"):
                p = self.parse_partition()
                p.annotations = anns
                app.add_partition(p)
            else:
                self.err("expected define/from/partition")
        return app

    def _is_app_annotation(self) -> bool:
        return (self.peek(1).kind == "ID" and self.peek(1).lower == "app"
                and self.at_punct(":", 2))

    # ---- annotations -------------------------------------------------------
    def parse_annotation(self) -> Annotation:
        t0 = self.expect_punct("@")
        name = self.expect_name()
        if self.eat_punct(":"):
            name = f"{name}:{self.expect_name()}"
        ann = self._at(Annotation(name), t0)
        if self.eat_punct("("):
            while not self.at_punct(")"):
                if self.at_punct("@"):
                    ann.annotations.append(self.parse_annotation())
                else:
                    key, val = self._parse_annotation_element()
                    if key is None and None in ann.elements:
                        # later positional elements must not overwrite the
                        # first (@Index('a','b'), composite @PrimaryKey)
                        key = f"__p{len(ann.elements)}"
                    ann.elements[key] = val
                if not self.eat_punct(","):
                    break
            self.expect_punct(")")
        return ann

    def _parse_annotation_element(self) -> Tuple[Optional[str], object]:
        # property_name: dotted/dashed/colon-joined names, or bare value
        t = self.peek()
        if t.kind == "ID":
            # lookahead for ('.'|'-'|':') name ... '='
            save = self.pos
            parts = [self.expect_name()]
            while self.at_punct(".") or self.at_punct("-") or self.at_punct(":"):
                sep = self.next().text
                parts.append(sep)
                parts.append(self.expect_name())
            if self.eat_punct("="):
                key = "".join(parts)
                return key, self._parse_annotation_value()
            self.pos = save
            self.err("annotation element must be key=value or a string")
        if t.kind == "STRING":
            return None, self.next().value
        self.err("bad annotation element")

    def _parse_annotation_value(self):
        t = self.next()
        if t.kind in ("STRING", "INT", "LONG", "FLOAT", "DOUBLE"):
            return t.value
        if t.kind == "ID" and t.lower in ("true", "false"):
            return t.lower == "true"
        raise SiddhiParserException(
            f"bad annotation value {t.text!r}", t.line, t.col)

    # ---- definitions -------------------------------------------------------
    def _parse_definition(self, app: SiddhiApp, anns: List[Annotation]):
        t0 = self.expect_kw("define")
        kind = self.next()
        k = kind.lower
        if k == "stream":
            d = self._at(StreamDefinition(self._parse_source_name()), t0)
            self._parse_attr_list(d)
            d.annotations = anns
            app.define_stream(d)
        elif k == "table":
            d = self._at(TableDefinition(self._parse_source_name()), t0)
            self._parse_attr_list(d)
            d.annotations = anns
            app.define_table(d)
        elif k == "window":
            d = self._at(WindowDefinition(self._parse_source_name()), t0)
            self._parse_attr_list(d)
            d.window = self._parse_window_function()
            if self.eat_kw("output"):
                d.output_event_type = self._parse_output_event_type()
            d.annotations = anns
            app.define_window(d)
        elif k == "trigger":
            d = self._at(TriggerDefinition(self.expect_name()), t0)
            self.expect_kw("at")
            if self.eat_kw("every"):
                d.at_every = self._parse_time_value()
            else:
                t = self.next()
                if t.kind != "STRING":
                    raise SiddhiParserException(
                        "trigger at-expression must be 'start' or a cron "
                        "string", t.line, t.col)
                d.at = t.value
            d.annotations = anns
            app.define_trigger(d)
        elif k == "function":
            d = self._at(FunctionDefinition(), t0)
            d.id = self.expect_name()
            self.expect_punct("[")
            d.language = self.expect_name()
            self.expect_punct("]")
            self.expect_kw("return")
            d.return_type = self.expect_name().upper()
            d.body = self._parse_script_body()
            app.define_function(d)
        elif k == "aggregation":
            d = self._at(self._parse_aggregation_definition(anns), t0)
            app.define_aggregation(d)
        else:
            raise SiddhiParserException(
                f"unknown definition kind {kind.text!r}", kind.line, kind.col)

    def _parse_source_name(self) -> str:
        prefix = ""
        if self.eat_punct("#"):
            prefix = "#"
        elif self.eat_punct("!"):
            prefix = "!"
        return prefix + self.expect_name()

    def _parse_attr_list(self, d):
        self.expect_punct("(")
        while True:
            name = self.expect_name()
            t = self.next()
            if t.kind != "ID" or t.lower not in _ATTR_TYPES:
                raise SiddhiParserException(
                    f"bad attribute type {t.text!r}", t.line, t.col)
            d.attribute(name, t.lower.upper())
            if not self.eat_punct(","):
                break
        self.expect_punct(")")

    def _parse_window_function(self) -> Window:
        t0 = self.peek()
        ns, name, params = self._parse_function_call()
        return self._at(Window(ns, name, params), t0)

    def _parse_script_body(self) -> str:
        """The tokenizer captures { ... } bodies verbatim as one SCRIPT
        token (whitespace preserved — python bodies need it)."""
        t = self.next()
        if t.kind != "SCRIPT":
            raise SiddhiParserException("expected { function body }",
                                        t.line, t.col)
        return t.text

    def _parse_aggregation_definition(self, anns) -> AggregationDefinition:
        d = AggregationDefinition(self.expect_name())
        d.annotations = anns
        self.expect_kw("from")
        d.basic_single_input_stream = self._parse_standard_stream()
        d.selector = self._parse_selector(group_by_only=True)
        self.expect_kw("aggregate")
        if self.eat_kw("by"):
            d.aggregate_attribute = self._parse_attribute_reference()
        self.expect_kw("every")
        first = self._parse_duration_name()
        if self.eat_punct("..."):
            last = self._parse_duration_name()
            order = AggregationDefinition.DURATIONS
            i0, i1 = order.index(first), order.index(last)
            if i1 < i0:
                self.err("invalid aggregation duration range")
            d.time_periods = list(order[i0:i1 + 1])
        else:
            periods = [first]
            while self.eat_punct(","):
                periods.append(self._parse_duration_name())
            d.time_periods = periods
        # derive output attributes from selector
        return d

    def _parse_duration_name(self) -> str:
        t = self.next()
        if t.kind != "ID" or t.lower not in _DURATION_NAMES:
            raise SiddhiParserException(
                f"bad aggregation duration {t.text!r}", t.line, t.col)
        return _DURATION_NAMES[t.lower]

    # ---- queries -----------------------------------------------------------
    def parse_query(self) -> Query:
        q = Query()
        t0 = self.expect_kw("from")
        self._at(q, t0)
        q.input_stream = self._at(self._parse_query_input(), t0)
        if self.at_kw("select"):
            tsel = self.peek()
            q.selector = self._at(self._parse_selector(), tsel)
        if self.at_kw("output"):
            trate = self.peek()
            q.output_rate = self._at(self._parse_output_rate(), trate)
        tout = self.peek()
        self._parse_query_output(q)
        if q.output_stream is not None:
            self._at(q.output_stream, tout)
        return q

    def _classify_input(self) -> str:
        """Scan ahead (depth-0) to classify the input as standard/join/
        pattern/sequence."""
        depth = 0
        i = self.pos
        toks = self.toks
        kind = "standard"
        while i < len(toks):
            t = toks[i]
            if t.kind == "EOF":
                break
            if t.kind == "PUNCT":
                if t.text in "([":
                    depth += 1
                elif t.text in ")]":
                    depth -= 1
                    if depth < 0:
                        break
                elif t.text == "->":
                    return "pattern"
                elif t.text == "," and depth == 0:
                    kind = "sequence"
                elif t.text == ";" and depth == 0:
                    break
            elif t.kind == "ID" and depth == 0:
                lw = t.lower
                if lw in _SECTION_KWS:
                    break
                if lw in ("join", "unidirectional") or (
                        lw in ("left", "right", "full", "inner") and
                        i + 1 < len(toks) and toks[i + 1].kind == "ID" and
                        toks[i + 1].lower in ("outer", "join")):
                    return "join"
                if lw in ("every", "not", "and", "or") and kind == "standard":
                    kind = "pattern"
                # event binding  e1=Stream  (depth-0 '=')
                if (toks[i + 1].kind == "PUNCT" and toks[i + 1].text == "="
                        and kind == "standard"):
                    kind = "pattern"
            i += 1
        return kind

    def _parse_query_input(self):
        kind = self._classify_input()
        if kind == "standard":
            return self._parse_standard_stream()
        if kind == "join":
            return self._parse_join_stream()
        if kind == "pattern":
            return self._parse_pattern_stream("PATTERN")
        return self._parse_pattern_stream("SEQUENCE")

    def _parse_standard_stream(self) -> SingleInputStream:
        s = self._parse_basic_source()
        # optional window + post handlers
        while True:
            if self.at_punct("#") and self.at_kw("window", off=1):
                t0 = self.next()
                self.expect_kw("window")
                self.expect_punct(".")
                ns, name, params = self._parse_function_call()
                s.stream_handlers.append(
                    self._at(Window(ns, name, params), t0))
            elif self.at_punct("#") or self.at_punct("["):
                self._parse_stream_handler(s)
            else:
                break
        if self.eat_kw("as"):
            s.stream_reference_id = self.expect_name()
        return s

    def _parse_basic_source(self) -> SingleInputStream:
        t0 = self.peek()
        is_inner = bool(self.eat_punct("#"))
        is_fault = False if is_inner else bool(self.eat_punct("!"))
        sid = self.expect_name()
        s = self._at(SingleInputStream(sid, None, is_inner, is_fault), t0)
        while self.at_punct("[") or (
                self.at_punct("#") and not self.at_kw("window", off=1)):
            self._parse_stream_handler(s)
        return s

    def _parse_stream_handler(self, s: SingleInputStream):
        if self.eat_punct("["):
            expr = self.parse_expression()
            self.expect_punct("]")
            s.filter(expr)
            return
        self.expect_punct("#")
        if self.at_punct("[", off=0):
            self.expect_punct("[")
            expr = self.parse_expression()
            self.expect_punct("]")
            s.filter(expr)
            return
        if self.at_kw("window"):
            t0 = self.expect_kw("window")
            self.expect_punct(".")
            ns, name, params = self._parse_function_call()
            s.stream_handlers.append(
                self._at(Window(ns, name, params), t0))
            return
        ns, name, params = self._parse_function_call()
        s.function(name, *params, namespace=ns)

    def _parse_function_call(self) -> Tuple[str, str, List[Expression]]:
        ns = ""
        name = self.expect_name()
        if self.eat_punct(":"):
            ns = name
            name = self.expect_name()
        params: List[Expression] = []
        self.expect_punct("(")
        if not self.at_punct(")"):
            if self.at_punct("*"):
                self.next()
            else:
                params.append(self.parse_expression())
                while self.eat_punct(","):
                    params.append(self.parse_expression())
        self.expect_punct(")")
        return ns, name, params

    # -- joins ----------------------------------------------------------------
    def _parse_join_stream(self) -> JoinInputStream:
        left = self._parse_join_source()
        trigger = "ALL_EVENTS"
        if self.eat_kw("unidirectional"):
            trigger = "LEFT"
        jt = self._parse_join_type()
        right = self._parse_join_source()
        if self.eat_kw("unidirectional"):
            if trigger == "LEFT":
                self.err("both sides cannot be unidirectional")
            trigger = "RIGHT"
        on = None
        if self.eat_kw("on"):
            on = self.parse_expression()
        within = per = None
        if self.eat_kw("within"):
            within = self.parse_expression()
            if self.eat_punct(","):
                within = (within, self.parse_expression())
        if self.eat_kw("per"):
            per = self.parse_expression()
        return JoinInputStream(left, jt, right, on, within, per, trigger)

    def _parse_join_type(self) -> str:
        if self.eat_kw("left"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.LEFT_OUTER_JOIN
        if self.eat_kw("right"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.RIGHT_OUTER_JOIN
        if self.eat_kw("full"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinInputStream.FULL_OUTER_JOIN
        if self.eat_kw("outer"):
            self.expect_kw("join")
            return JoinInputStream.FULL_OUTER_JOIN
        self.eat_kw("inner")
        self.expect_kw("join")
        return JoinInputStream.JOIN

    def _parse_join_source(self) -> SingleInputStream:
        s = self._parse_basic_source()
        if self.at_punct("#") and self.at_kw("window", off=1):
            t0 = self.next()
            self.expect_kw("window")
            self.expect_punct(".")
            ns, name, params = self._parse_function_call()
            s.stream_handlers.append(
                self._at(Window(ns, name, params), t0))
        if self.eat_kw("as"):
            s.stream_reference_id = self.expect_name()
        return s

    # -- patterns / sequences --------------------------------------------------
    def _parse_pattern_stream(self, state_type: str) -> StateInputStream:
        sep = "->" if state_type == "PATTERN" else ","
        root = self._parse_state_chain(sep)
        within = None
        if self.eat_kw("within"):
            within = self._parse_time_value()
        return StateInputStream(state_type, root, within)

    def _parse_state_chain(self, sep: str):
        elements = [self._parse_state_element(sep)]
        while (self.at_punct(sep) if sep == "->" else
               (self.at_punct(",") and not self.at_kw("within", off=1))):
            self.next()
            elements.append(self._parse_state_element(sep))
        root = elements[-1]
        for el in reversed(elements[:-1]):
            root = NextStateElement(el, root)
        return root

    def _parse_state_element(self, sep: str):
        t0 = self.peek()
        if self.eat_kw("every"):
            if self.eat_punct("("):
                inner = self._parse_state_chain(sep)
                self.expect_punct(")")
                return self._at(EveryStateElement(inner), t0)
            return self._at(EveryStateElement(self._parse_state_unit(sep)),
                            t0)
        if self.at_punct("("):
            self.next()
            inner = self._parse_state_chain(sep)
            self.expect_punct(")")
            return inner
        return self._parse_state_unit(sep)

    def _parse_state_unit(self, sep: str):
        left = self._parse_stateful_source(sep)
        if self.at_kw("and", "or"):
            op = self.next().lower.upper()
            right = self._parse_stateful_source(sep)
            return LogicalStateElement(left, op, right)
        return left

    def _parse_stateful_source(self, sep: str):
        t0 = self.peek()
        if self.eat_kw("not"):
            src = self._parse_basic_source()
            waiting = None
            if self.eat_kw("for"):
                waiting = self._parse_time_value()
            return self._at(AbsentStreamStateElement(src, waiting), t0)
        # (event '=')? basic_source (<m:n> | * | + | ?)?
        ref = None
        if self.peek().kind == "ID" and self.at_punct("=", off=1):
            ref = self.expect_name()
            self.expect_punct("=")
        src = self._parse_basic_source()
        src.stream_reference_id = ref
        sse = self._at(StreamStateElement(src), t0)
        if self.eat_punct("<"):
            lo_t = self.next()
            if lo_t.kind != "INT":
                if lo_t.kind == "PUNCT" and lo_t.text == ":":
                    lo = 0
                    hi = int(self._expect_int())
                    self.expect_punct(">")
                    return CountStateElement(sse, lo, hi)
                raise SiddhiParserException("bad count range",
                                            lo_t.line, lo_t.col)
            lo = int(lo_t.value)
            hi = CountStateElement.ANY
            if self.eat_punct(":"):
                if self.peek().kind == "INT":
                    hi = int(self.next().value)
            else:
                hi = lo
            self.expect_punct(">")
            return CountStateElement(sse, lo, hi)
        if self.at_punct("*") and sep == ",":
            self.next()
            return CountStateElement(sse, 0, CountStateElement.ANY)
        if self.at_punct("+") and sep == ",":
            self.next()
            return CountStateElement(sse, 1, CountStateElement.ANY)
        if self.at_punct("?") and sep == ",":
            self.next()
            return CountStateElement(sse, 0, 1)
        return sse

    def _expect_int(self) -> int:
        t = self.next()
        if t.kind != "INT":
            raise SiddhiParserException(
                f"expected integer, got {t.text!r}", t.line, t.col)
        return int(t.value)

    # -- selector ---------------------------------------------------------------
    def _parse_selector(self, group_by_only: bool = False) -> Selector:
        sel = Selector()
        self.expect_kw("select")
        if self.eat_punct("*"):
            pass
        else:
            while True:
                expr = self.parse_expression()
                if self.eat_kw("as"):
                    sel.select(self.expect_name(), expr)
                else:
                    sel.selection_list.append(OutputAttribute(None, expr))
                if not self.eat_punct(","):
                    break
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            while True:
                v = self._parse_attribute_reference()
                sel.group_by(v)
                if not self.eat_punct(","):
                    break
        if group_by_only:
            return sel
        if self.eat_kw("having"):
            sel.having(self.parse_expression())
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                v = self._parse_attribute_reference()
                order = "ASC"
                if self.eat_kw("asc"):
                    order = "ASC"
                elif self.eat_kw("desc"):
                    order = "DESC"
                sel.order_by(v, order)
                if not self.eat_punct(","):
                    break
        if self.eat_kw("limit"):
            sel.limit = self._parse_const_int()
        if self.eat_kw("offset"):
            sel.offset = self._parse_const_int()
        return sel

    def _parse_const_int(self) -> int:
        t = self.next()
        if t.kind not in ("INT", "LONG"):
            raise SiddhiParserException(
                f"expected integer constant, got {t.text!r}", t.line, t.col)
        return int(t.value)

    # -- output rate / output --------------------------------------------------
    def _parse_output_rate(self) -> OutputRate:
        self.expect_kw("output")
        if self.eat_kw("snapshot"):
            self.expect_kw("every")
            return OutputRate.per_snapshot(self._parse_time_value())
        behavior = "ALL"
        if self.eat_kw("all"):
            behavior = "ALL"
        elif self.eat_kw("first"):
            behavior = "FIRST"
        elif self.eat_kw("last"):
            behavior = "LAST"
        self.expect_kw("every")
        if self.peek().kind == "INT" and self.at_kw("events", off=1):
            n = self._expect_int()
            self.expect_kw("events")
            return OutputRate.per_events(n, behavior)
        return OutputRate.per_time(self._parse_time_value(), behavior)

    def _parse_output_event_type(self) -> str:
        if self.eat_kw("all"):
            self.expect_kw("events")
            return "ALL_EVENTS"
        if self.eat_kw("expired"):
            self.expect_kw("events")
            return "EXPIRED_EVENTS"
        self.eat_kw("current")
        self.expect_kw("events")
        return "CURRENT_EVENTS"

    def _parse_query_output(self, q: Query):
        if self.eat_kw("insert"):
            et = None
            if self.at_kw("all", "expired", "current"):
                et = self._parse_output_event_type()
            self.expect_kw("into")
            target = self._parse_source_name()
            q.output_stream = InsertIntoStream(
                target, et, target.startswith("#"), target.startswith("!"))
            return
        if self.eat_kw("delete"):
            target = self._parse_source_name()
            et = None
            if self.eat_kw("for"):
                et = self._parse_output_event_type()
            self.expect_kw("on")
            q.output_stream = DeleteStream(target, self.parse_expression(), et)
            return
        if self.eat_kw("update"):
            if self.eat_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                target = self._parse_source_name()
                et = None
                if self.eat_kw("for"):
                    et = self._parse_output_event_type()
                us = self._parse_set_clause()
                self.expect_kw("on")
                q.output_stream = UpdateOrInsertStream(
                    target, self.parse_expression(), us, et)
                return
            target = self._parse_source_name()
            et = None
            if self.eat_kw("for"):
                et = self._parse_output_event_type()
            us = self._parse_set_clause()
            self.expect_kw("on")
            q.output_stream = UpdateStream(target, self.parse_expression(),
                                           us, et)
            return
        if self.eat_kw("return"):
            et = None
            if self.at_kw("all", "expired", "current"):
                et = self._parse_output_event_type()
            q.output_stream = ReturnStream(et)
            return
        self.err("expected insert/delete/update/return")

    def _parse_set_clause(self) -> Optional[UpdateSet]:
        if not self.eat_kw("set"):
            return None
        us = UpdateSet()
        while True:
            var = self._parse_attribute_reference()
            self.expect_punct("=")
            us.set(var, self.parse_expression())
            if not self.eat_punct(","):
                break
        return us

    # -- partitions -------------------------------------------------------------
    def parse_partition(self) -> Partition:
        t0 = self.expect_kw("partition")
        self.expect_kw("with")
        self.expect_punct("(")
        p = self._at(Partition(), t0)
        while True:
            save = self.pos
            expr = self.parse_expression()
            if self.eat_kw("as"):
                # range partition: expr as 'label' (or ...) of stream
                self.pos = save
                ranges = []
                while True:
                    cond = self.parse_expression()
                    self.expect_kw("as")
                    t = self.next()
                    if t.kind != "STRING":
                        raise SiddhiParserException(
                            "range label must be a string", t.line, t.col)
                    ranges.append(RangePartitionProperty(t.value, cond))
                    if not self.eat_kw("or"):
                        break
                self.expect_kw("of")
                sid = self.expect_name()
                p.with_(sid, ranges)
            else:
                self.expect_kw("of")
                sid = self.expect_name()
                p.with_(sid, expr)
            if not self.eat_punct(","):
                break
        self.expect_punct(")")
        self.expect_kw("begin")
        while True:
            while self.eat_punct(";"):
                pass
            if self.at_kw("end"):
                break
            anns = []
            while self.at_punct("@"):
                anns.append(self.parse_annotation())
            q = self.parse_query()
            q.annotations = anns
            p.add_query(q)
        self.expect_kw("end")
        return p

    # -- on-demand (store) query -------------------------------------------------
    def parse_on_demand_query(self) -> OnDemandQuery:
        oq = OnDemandQuery()
        if self.at_kw("select"):
            # "query_section INSERT INTO target" form
            oq.selector = self._parse_selector()
            self.expect_kw("insert")
            self.expect_kw("into")
            oq.type = "INSERT"
            oq.output_stream = InsertIntoStream(self._parse_source_name())
            return oq
        self.expect_kw("from")
        store = InputStore(self.expect_name())
        if self.eat_kw("as"):
            store.alias = self.expect_name()
        if self.eat_kw("on"):
            store.on_condition = self.parse_expression()
        if self.eat_kw("within"):
            a = self.parse_expression()
            b = None
            if self.eat_punct(","):
                b = self.parse_expression()
            store.within = (a, b)
        if self.eat_kw("per"):
            store.per = self.parse_expression()
        oq.input_store = store
        if self.at_kw("select"):
            oq.selector = self._parse_selector()
        if self.eat_kw("delete"):
            tgt = self._parse_source_name()
            self.expect_kw("on")
            oq.type = "DELETE"
            oq.output_stream = DeleteStream(tgt, self.parse_expression())
        elif self.eat_kw("update"):
            if self.eat_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                tgt = self._parse_source_name()
                us = self._parse_set_clause()
                self.expect_kw("on")
                oq.type = "UPDATE_OR_INSERT"
                oq.output_stream = UpdateOrInsertStream(
                    tgt, self.parse_expression(), us)
            else:
                tgt = self._parse_source_name()
                us = self._parse_set_clause()
                self.expect_kw("on")
                oq.type = "UPDATE"
                oq.output_stream = UpdateStream(tgt, self.parse_expression(), us)
        else:
            oq.type = "FIND"
        return oq

    # ---- expressions ---------------------------------------------------------
    def parse_expression(self) -> Expression:
        t0 = self.peek()
        return self._at(self._parse_or(), t0)

    def _parse_or(self) -> Expression:
        left = self._parse_and()
        while self.at_kw("or"):
            self.next()
            left = Or(left, self._parse_and())
        return left

    def _parse_and(self) -> Expression:
        left = self._parse_in()
        while self.at_kw("and"):
            self.next()
            left = And(left, self._parse_in())
        return left

    def _parse_in(self) -> Expression:
        left = self._parse_equality()
        while self.at_kw("in"):
            self.next()
            left = In(left, self.expect_name())
        return left

    def _parse_equality(self) -> Expression:
        left = self._parse_relational()
        while self.at_punct("==") or self.at_punct("!="):
            t = self.next()
            left = self._at(Compare(left, t.text,
                                    self._parse_relational()), t)
        return left

    def _parse_relational(self) -> Expression:
        left = self._parse_additive()
        while (self.at_punct(">=") or self.at_punct("<=")
               or self.at_punct(">") or self.at_punct("<")):
            t = self.next()
            left = self._at(Compare(left, t.text,
                                    self._parse_additive()), t)
        return left

    def _parse_additive(self) -> Expression:
        left = self._parse_multiplicative()
        while self.at_punct("+") or self.at_punct("-"):
            op = self.next().text
            right = self._parse_multiplicative()
            left = Add(left, right) if op == "+" else Subtract(left, right)
        return left

    def _parse_multiplicative(self) -> Expression:
        left = self._parse_unary()
        while self.at_punct("*") or self.at_punct("/") or self.at_punct("%"):
            op = self.next().text
            right = self._parse_unary()
            left = {"*": Multiply, "/": Divide, "%": Mod}[op](left, right)
        return left

    def _parse_unary(self) -> Expression:
        if self.at_kw("not"):
            self.next()
            return Not(self._parse_unary())
        if self.at_punct("-") or self.at_punct("+"):
            sign = self.next().text
            inner = self._parse_unary()
            if sign == "+":
                return inner
            if isinstance(inner, Constant) and inner.type != "STRING":
                return Constant(-inner.value, inner.type)
            return Subtract(Constant(0, "INT"), inner)
        return self._parse_postfix()

    def _parse_postfix(self) -> Expression:
        e = self._parse_primary()
        if self.at_kw("is") and self.at_kw("null", off=1):
            self.next()
            self.next()
            if isinstance(e, Variable) and e.attribute_name is None:
                return IsNull(None, e.stream_id, e.stream_index)
            return IsNull(e)
        return e

    def _parse_primary(self) -> Expression:
        t = self.peek()
        if self.at_punct("("):
            self.next()
            e = self.parse_expression()
            self.expect_punct(")")
            return e
        if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
            self.next()
            # time literal: INT followed by a unit keyword
            if t.kind == "INT" and self.peek().kind == "ID" and \
                    self.peek().lower in _TIME_UNITS:
                return Constant(self._parse_time_value(int(t.value)), "LONG",
                                is_time=True)
            kind = {"INT": "INT", "LONG": "LONG", "FLOAT": "FLOAT",
                    "DOUBLE": "DOUBLE"}[t.kind]
            return Constant(t.value, kind)
        if t.kind == "STRING":
            self.next()
            return Constant(t.value, "STRING")
        if t.kind == "ID":
            if t.lower == "true" or t.lower == "false":
                self.next()
                return Constant(t.lower == "true", "BOOL")
            if t.lower == "null":
                self.next()
                return Constant(None, "STRING")
            return self._parse_reference_or_function()
        if self.at_punct("#") or self.at_punct("!"):
            return self._parse_reference_or_function()
        self.err("unexpected token in expression")

    def _parse_reference_or_function(self) -> Expression:
        # function call: name '(' or ns ':' name '('
        if (self.peek().kind == "ID" and self.at_punct("(", off=1)) or \
                (self.peek().kind == "ID" and self.at_punct(":", off=1)
                 and self.peek(2).kind == "ID" and self.at_punct("(", off=3)):
            ns, name, params = self._parse_function_call()
            return AttributeFunction(ns, name, params)
        return self._parse_attribute_reference(allow_bare_stream=True)

    def _parse_attribute_reference(self, allow_bare_stream: bool = False
                                   ) -> Variable:
        prefix = ""
        if self.eat_punct("#"):
            prefix = "#"
        elif self.eat_punct("!"):
            prefix = "!"
        name1 = self.expect_name()
        idx1 = None
        if self.at_punct("[") and not prefix:
            self.next()
            idx1 = self._parse_attribute_index()
            self.expect_punct("]")
        # inner-stream second part: name1#name2.attr
        if self.eat_punct("#"):
            name2 = self.expect_name()
            self.expect_punct(".")
            attr = self.expect_name()
            return Variable(attr, stream_id=prefix + name1 + "#" + name2)
        if self.at_punct(".") :
            self.next()
            attr = self.expect_name()
            return Variable(attr, stream_id=prefix + name1, stream_index=idx1)
        if idx1 is not None or prefix:
            if allow_bare_stream:
                # stream reference (for `S is null` in patterns)
                return Variable(None, stream_id=prefix + name1,
                                stream_index=idx1)
            self.err("expected '.attribute' after stream reference")
        return Variable(name1)

    def _parse_attribute_index(self) -> int:
        if self.at_kw("last"):
            self.next()
            if self.eat_punct("-"):
                return -(self._expect_int() + 1)
            return -1
        return self._expect_int()

    # ---- time values -----------------------------------------------------------
    def _parse_time_value(self, first: Optional[int] = None) -> int:
        total = 0
        count = 0
        while True:
            if first is not None:
                amount = first
                first = None
            else:
                if self.peek().kind != "INT":
                    break
                if not (self.peek(1).kind == "ID" and
                        self.peek(1).lower in _TIME_UNITS):
                    break
                amount = int(self.next().value)
            unit = self.next()
            if unit.kind != "ID" or unit.lower not in _TIME_UNITS:
                raise SiddhiParserException(
                    f"expected time unit, got {unit.text!r}",
                    unit.line, unit.col)
            total += amount * _TIME_UNITS[unit.lower]
            count += 1
        if count == 0:
            self.err("expected time value")
        return total
