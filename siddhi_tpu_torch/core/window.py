"""The few window-module names the pattern path uses (port of parts of
`siddhi_tpu/core/window.py` and `siddhi_tpu/core/plan_facts.py`).

The window processors themselves are not ported yet (ROADMAP B11-B13).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

# "no timer wanted": a quarter of the int64 range, as the reference defines it
NO_WAKEUP = (2 ** 63 - 1) // 4

# emission cap meaning "effectively uncapped" (non-partitioned patterns)
UNCAPPED_SENTINEL = 1 << 30


class Rows(NamedTuple):
    """Ordered operator rows flowing into the selector."""

    ts: Any     # i64[B]
    kind: Any   # i32[B] CURRENT/EXPIRED/TIMER/RESET
    valid: Any  # bool[B]
    seq: Any    # i64[B] global order
    gslot: Any  # i32[B] group-by slot (-1 none)
    cols: Tuple[Any, ...]
