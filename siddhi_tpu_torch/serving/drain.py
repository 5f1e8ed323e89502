"""The serving drainer: the only place serving emissions cross from the
card to the host (port of `siddhi_tpu/serving/drain.py`).

One thread per app takes every registered ring's pending slots and waits
on the transfers HERE; the producer merely queued a slot write.  Delivery
re-enters the query's own delivery function (`core/runtime.py`
`_deliver_pattern` / `_deliver_plain` / `_deliver_join`), so callbacks,
table writes, rate limits and output routing behave as a blocking fetch
would; the rows arrive as host tensors of the valid rows only, so a batch
callback's payload under `@serve` holds those rows (the blocking path
hands it the whole output block, invalid rows included).

Cadence: the thread wakes every `serving.drain.interval.ms` and at once
on a high-water kick from any ring.  Each round drains every ring: per
ring generation one pack launch and two device-to-host transfers, on the
drainer's own stream.

`drain_all()` is the synchronous edge for flush / shutdown: it runs rounds
on the caller's thread under the same delivery lock the thread uses.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List

log = logging.getLogger("siddhi_tpu_torch")

# a drainer with work pending and no round for this many intervals is
# stalled: health() flips `degraded` (reference `STALL_INTERVALS`)
STALL_INTERVALS = 10.0


class ServingDrainer:
    """Per-app serving drain thread (started with the first ring)."""

    def __init__(self, app, interval_ms: float = 2.0):
        from ..kernels.ring import PackStaging
        self.app = app
        self.interval_ms = float(interval_ms)
        self._rings: List = []
        self._cv = threading.Condition()
        # serializes delivery rounds: thread ticks and drain_all never
        # interleave, so per-ring delivery order is send order
        self._deliver_lock = threading.Lock()
        self._staging = PackStaging()
        self._thread = None
        self._started = False
        self._running = False
        self._kicked = False
        self.drains_total = 0
        self.drained_outputs_total = 0
        self.last_tick_ns = time.monotonic_ns()

    def register(self, ring) -> None:
        with self._cv:
            if ring not in self._rings:
                self._rings.append(ring)
        self.start()

    def start(self) -> None:
        with self._cv:
            if self._started:
                return
            self._started = True
            self._running = True
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="siddhi-torch-serve")
            self._thread.start()

    def kick(self) -> None:
        """High-water wakeup from a ring."""
        with self._cv:
            self._kicked = True
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            if not self._started:
                return
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.drain_all()

    def pending(self) -> int:
        """Ring entries accepted but not yet delivered."""
        return sum(r.occupancy() for r in list(self._rings))

    def alive(self) -> bool:
        t = self._thread
        return (not self._started) or (t is not None and t.is_alive())

    def stalled(self) -> bool:
        """Work pending but no round within the stall budget (health's
        `degraded`; reference `stalled`, `siddhi_tpu/serving/drain.py`
        :112-120)."""
        if not self._started or self.pending() == 0:
            return False
        idle_ns = time.monotonic_ns() - self.last_tick_ns
        budget_ns = max(self.interval_ms, 1.0) * 1e6 * STALL_INTERVALS
        return idle_ns > budget_ns or not self.alive()

    def drain_all(self) -> int:
        """Synchronous full drain on the caller's thread."""
        total = 0
        for _ in range(64):
            n = self._cycle()
            total += n
            if n == 0 and self.pending() == 0:
                break
        return total

    def _cycle(self) -> int:
        with self._deliver_lock:
            n = 0
            for ring in list(self._rings):
                items = ring.drain(self._staging)
                if items:
                    n += len(items)
                    self._deliver(ring.qr, items)
            self.last_tick_ns = time.monotonic_ns()
            if n:
                self.drains_total += 1
                self.drained_outputs_total += n
            return n

    @staticmethod
    def _deliver(qr, items) -> None:
        for deliver, out, hdr, now in items:
            try:
                deliver(qr, out, hdr, now)
            except Exception:  # noqa: BLE001 — the drainer must survive
                log.exception("serving drain error in %s",
                              getattr(qr, "name", "?"))
        st = qr.app.stats
        if st.enabled:
            st.counter_inc(f"{qr.name}.ring_drains", len(items))

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
                if not self._kicked:
                    self._cv.wait(timeout=max(self.interval_ms, 0.1) / 1e3)
                self._kicked = False
                if not self._running:
                    return
            try:
                self._cycle()
            except Exception:  # noqa: BLE001 — the drainer must survive
                log.exception("serving drain round failed")
