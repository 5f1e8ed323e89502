"""Minimal quartz-style cron evaluator (a copy of the JAX package's
`siddhi_tpu/utils/cron.py`, which the port does not import): the fire
times of the `cron` window, computed on the host.  `next_fire` works in
the host's local time, as the JAX package's does, so both fire at the same
instants on the same machine.

Reference behavior (what): CORE/trigger/CronTrigger.java:46 schedules via the
Quartz library.  Quartz is a JVM dependency; here a small pure-Python
next-fire computation covers the expression subset the test corpus uses:
``sec min hour day-of-month month day-of-week [year]`` with ``*``, ``?``,
``a``, ``a-b``, ``a,b,c``, ``*/n`` and ``a/n`` per field.
"""
from __future__ import annotations

import datetime
from typing import Optional

_FIELD_RANGES = [
    (0, 59),   # second
    (0, 59),   # minute
    (0, 23),   # hour
    (1, 31),   # day of month
    (1, 12),   # month
    (0, 7),    # day of week (0 and 7 = Sunday, quartz: 1=SUN..7=SAT)
]

_DOW_NAMES = {"SUN": 1, "MON": 2, "TUE": 3, "WED": 4, "THU": 5, "FRI": 6,
              "SAT": 7}
_MON_NAMES = {"JAN": 1, "FEB": 2, "MAR": 3, "APR": 4, "MAY": 5, "JUN": 6,
              "JUL": 7, "AUG": 8, "SEP": 9, "OCT": 10, "NOV": 11, "DEC": 12}


def _parse_field(text: str, lo: int, hi: int,
                 names=None) -> Optional[frozenset]:
    """Returns the allowed value set, or None for 'any'."""
    text = text.strip().upper()
    if text in ("*", "?"):
        return None
    vals = set()
    for part in text.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", "?", ""):
            start, end = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a, b = part.split("-", 1)
            start = names[a] if names and a in names else int(a)
            end = names[b] if names and b in names else int(b)
        else:
            v = names[part] if names and part in names else int(part)
            if step > 1:
                start, end = v, hi
            else:
                vals.add(v)
                continue
        vals.update(range(start, end + 1, step))
    return frozenset(vals)


class CronExpression:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) == 7:
            fields = fields[:6]  # drop year field
        if len(fields) == 5:
            fields = ["0"] + fields  # classic cron without seconds
        if len(fields) != 6:
            raise ValueError(f"bad cron expression {expr!r}")
        self.sec = _parse_field(fields[0], 0, 59)
        self.min = _parse_field(fields[1], 0, 59)
        self.hour = _parse_field(fields[2], 0, 23)
        self.dom = _parse_field(fields[3], 1, 31)
        self.mon = _parse_field(fields[4], 1, 12, _MON_NAMES)
        # quartz day-of-week: 1=SUN..7=SAT
        self.dow = _parse_field(fields[5], 1, 7, _DOW_NAMES)

    def _dow_ok(self, dt: datetime.datetime) -> bool:
        if self.dow is None:
            return True
        quartz_dow = (dt.weekday() + 1) % 7 + 1   # Mon=2 .. Sun=1
        return quartz_dow in self.dow

    def next_fire(self, after_ms: int) -> int:
        """Earliest firing time strictly after `after_ms` (epoch millis)."""
        dt = datetime.datetime.fromtimestamp(after_ms / 1000.0)
        dt = dt.replace(microsecond=0) + datetime.timedelta(seconds=1)
        limit = dt + datetime.timedelta(days=366 * 4)
        while dt < limit:
            if self.mon is not None and dt.month not in self.mon:
                # jump to first second of next month
                y, m = dt.year + (dt.month == 12), dt.month % 12 + 1
                dt = datetime.datetime(y, m, 1)
                continue
            if (self.dom is not None and dt.day not in self.dom) or \
                    not self._dow_ok(dt):
                dt = (dt + datetime.timedelta(days=1)).replace(
                    hour=0, minute=0, second=0)
                continue
            if self.hour is not None and dt.hour not in self.hour:
                dt = (dt + datetime.timedelta(hours=1)).replace(
                    minute=0, second=0)
                continue
            if self.min is not None and dt.minute not in self.min:
                dt = (dt + datetime.timedelta(minutes=1)).replace(second=0)
                continue
            if self.sec is not None and dt.second not in self.sec:
                dt = dt + datetime.timedelta(seconds=1)
                continue
            return int(dt.timestamp() * 1000)
        raise ValueError("cron expression never fires")
