"""Output rate limiting (port of `siddhi_tpu/core/ratelimit.py`, host code;
reference: CORE/query/output/ratelimit/* — 17 limiter classes:
{All,First,Last}Per{Event,Time} (+GroupBy variants) and snapshot
limiters).

The device step always computes the full output batch; limiting is a host
concern on the emission path (events are already host-side there), matching
the reference's placement between QuerySelector and OutputCallback.
`output snapshot every t` re-emits the latest row per group at each tick,
with the group key recovered from the projected group-by attributes when
they appear in the output (the common `select g, agg(x) ... group by g`
shape); otherwise the whole latest row stands in.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from ..observability import tracing as _tracing
from . import event as ev


class OutputRateLimiter:
    """Base: `process` receives (kind, Event) pairs in emission order and
    forwards whatever is due to `deliver`.

    `process` (query/drainer thread) and `on_timer` (scheduler thread)
    mutate the same buffers; subclasses call them through the public
    entry points which serialize on the limiter's own RLock."""

    needs_timer = False

    def __init__(self,
                 deliver: Callable[[List[Tuple[int, ev.Event]], int], None]):
        self.deliver = deliver
        self._lk = threading.RLock()
        # what the app's timer scheduler reads of a timer target: its lock
        # and, for its log, a name (the query's, set at wiring)
        self._qlock = self._lk
        self.name = "output rate limiter"

    def process(self, pairs: List[Tuple[int, ev.Event]], now: int) -> None:
        # a rate-limit span on a DETAIL pipeline trace (reference
        # `process`, `siddhi_tpu/core/ratelimit.py:36-47`)
        if _tracing.active() is not None:
            with _tracing.span("ratelimit", limiter=type(self).__name__,
                               pairs=len(pairs)):
                with self._lk:
                    self._process(pairs, now)
            return
        with self._lk:
            self._process(pairs, now)

    def on_timer(self, now: int) -> None:
        with self._lk:
            self._on_timer(now)

    def _process(self, pairs, now) -> None:
        raise NotImplementedError

    def _on_timer(self, now: int) -> None:  # pragma: no cover - overridden
        pass


class PerEventsLimiter(OutputRateLimiter):
    """`output [all|first|last] every N events` (reference:
    ratelimit/event/*PerEventOutputRateLimiter.java, incl. the
    First/LastGroupByPerEvent variants).  Counts CURRENT output events; at
    each full window of N, ALL flushes the buffer, FIRST emits only the
    window's first event, LAST only its Nth.  With group-by, FIRST emits
    each GROUP's first event within the window and LAST emits each group's
    latest event at the window boundary."""

    def __init__(self, deliver, n: int, behavior: str,
                 group_positions: Optional[List[int]] = None):
        super().__init__(deliver)
        self.n = n
        self.behavior = behavior
        self.group_positions = group_positions
        self._buf: List[Tuple[int, ev.Event]] = []
        self._count = 0
        self._first_sent = False
        self._group_first: set = set()
        self._group_last: dict = {}

    def _key(self, e: ev.Event):
        return tuple(e.data[i] for i in self.group_positions)

    def _process(self, pairs, now):
        out: List[Tuple[int, ev.Event]] = []
        grouped = bool(self.group_positions)
        for kind, e in pairs:
            if self.behavior == "ALL":
                self._buf.append((kind, e))
                self._count += 1
                if self._count == self.n:
                    out.extend(self._buf)
                    self._buf.clear()
                    self._count = 0
            elif self.behavior == "FIRST":
                if grouped:
                    k = self._key(e)
                    if k not in self._group_first:
                        out.append((kind, e))
                        self._group_first.add(k)
                else:
                    if not self._first_sent:
                        out.append((kind, e))
                        self._first_sent = True
                self._count += 1
                if self._count == self.n:
                    self._count = 0
                    self._first_sent = False
                    self._group_first.clear()
            else:  # LAST
                if grouped:
                    self._group_last[self._key(e)] = (kind, e)
                self._count += 1
                if self._count == self.n:
                    if grouped:
                        out.extend(self._group_last.values())
                        self._group_last.clear()
                    else:
                        out.append((kind, e))
                    self._count = 0
        if out:
            self.deliver(out, now)


class PerTimeLimiter(OutputRateLimiter):
    """`output [all|first|last] every <t>` (reference: ratelimit/time/*,
    incl. First/LastGroupByPerTime variants).  Scheduler-driven: every t ms
    the buffered (ALL), first (FIRST) or most recent (LAST) output is
    flushed.  With group-by, FIRST emits each group's first event of the
    interval immediately; LAST flushes each group's latest at the tick."""

    needs_timer = True

    def __init__(self, deliver, interval_ms: int, behavior: str,
                 group_positions: Optional[List[int]] = None):
        super().__init__(deliver)
        self.interval = interval_ms
        self.behavior = behavior
        self.group_positions = group_positions
        self._buf: List[Tuple[int, ev.Event]] = []
        self._group_first: set = set()
        self._group_last: dict = {}
        self._schedule: Optional[Callable[[int], None]] = None

    def _key(self, e: ev.Event):
        return tuple(e.data[i] for i in self.group_positions)

    def _process(self, pairs, now):
        grouped = bool(self.group_positions)
        if self.behavior == "FIRST":
            if grouped:
                out = []
                for kind, e in pairs:
                    k = self._key(e)
                    if k not in self._group_first:
                        self._group_first.add(k)
                        out.append((kind, e))
                if out:
                    self.deliver(out, now)
            elif not self._buf and pairs:
                # emit immediately the first event of each interval
                self.deliver([pairs[0]], now)
                self._buf = [pairs[0]]       # marks "sent this interval"
        elif self.behavior == "LAST":
            if grouped:
                for kind, e in pairs:
                    self._group_last[self._key(e)] = (kind, e)
            elif pairs:
                self._buf = [pairs[-1]]
        else:
            self._buf.extend(pairs)

    def _on_timer(self, now: int) -> None:
        if self.behavior == "FIRST":
            self._buf = []
            self._group_first.clear()
        elif self.behavior == "LAST" and self._group_last:
            self.deliver(list(self._group_last.values()), now)
            self._group_last.clear()
        elif self._buf:
            self.deliver(self._buf, now)
            self._buf = []
        if self._schedule is not None:
            self._schedule(now + self.interval)


class SnapshotLimiter(OutputRateLimiter):
    """`output snapshot every <t>` (reference: ratelimit/snapshot/*): at each
    tick, re-emit the latest CURRENT row per group."""

    needs_timer = True

    def __init__(self, deliver, interval_ms: int,
                 group_positions: Optional[List[int]] = None):
        super().__init__(deliver)
        self.interval = interval_ms
        self.group_positions = group_positions
        self._latest = {}
        self._schedule: Optional[Callable[[int], None]] = None

    def _key(self, e: ev.Event):
        if self.group_positions:
            return tuple(e.data[i] for i in self.group_positions)
        return ()

    def _process(self, pairs, now):
        for kind, e in pairs:
            if kind == ev.CURRENT:
                self._latest[self._key(e)] = e

    def _on_timer(self, now: int) -> None:
        if self._latest:
            self.deliver([(ev.CURRENT, e) for e in self._latest.values()],
                         now)
        if self._schedule is not None:
            self._schedule(now + self.interval)


def create_rate_limiter(output_rate, deliver,
                        group_positions=None) -> Optional[OutputRateLimiter]:
    if output_rate is None:
        return None
    if output_rate.type == "EVENTS":
        return PerEventsLimiter(deliver, int(output_rate.value),
                                output_rate.behavior, group_positions)
    if output_rate.type == "TIME":
        return PerTimeLimiter(deliver, int(output_rate.value),
                              output_rate.behavior, group_positions)
    if output_rate.type == "SNAPSHOT":
        return SnapshotLimiter(deliver, int(output_rate.value),
                               group_positions)
    raise ValueError(f"unknown output rate type {output_rate.type!r}")
