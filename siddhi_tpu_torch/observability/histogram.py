"""Log2-bucket latency histogram (port of
`siddhi_tpu/observability/histogram.py`, host code, copied): a fixed array
of power-of-two buckets per metric, lock-free recording into a preallocated
list, p50 / p95 / p99 / max read from the buckets.  The reference's
Dropwizard Histogram / LatencyMetric roles.
"""
from __future__ import annotations

from typing import Dict, List

NBUCKETS = 64  # covers 1ns .. ~292 years in powers of two


class LogHistogram:
    __slots__ = ("counts", "total", "sum_ns", "max_ns")

    def __init__(self):
        self.counts: List[int] = [0] * NBUCKETS
        self.total = 0
        self.sum_ns = 0
        self.max_ns = 0

    # -- hot path --------------------------------------------------------------
    def record(self, ns: int) -> None:
        if ns < 0:
            ns = 0
        i = ns.bit_length()
        if i >= NBUCKETS:
            i = NBUCKETS - 1
        self.counts[i] += 1
        self.total += 1
        self.sum_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns

    # -- queries ---------------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Approximate q-quantile in nanoseconds (error <= one octave).

        Bucket convention (the log2 UPPER-BOUND convention, shared with
        `buckets_seconds`/`buckets_raw` exposition): bucket `i` holds
        integer values with `bit_length() == i`, i.e. the half-open range
        `[2^(i-1), 2^i)` for `i >= 1` and exactly `{0}` for `i == 0`.
        The quantile interpolates linearly inside the winning bucket over
        `[2^(i-1), 2^i]` — so a target landing EXACTLY on a bucket's
        cumulative boundary reports that bucket's exclusive upper bound
        `2^i`, the same `le` value Prometheus' `histogram_quantile` would
        interpolate to from the exported buckets.  The result is clamped
        to the observed max, which also makes a single-sample histogram
        report the exact recorded value at every q."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = float(1 << (i - 1)) if i > 0 else 0.0
                hi = float(1 << i) if i > 0 else 0.0
                frac = (target - cum) / c
                return min(lo + frac * (hi - lo), float(self.max_ns))
            cum += c
        return float(self.max_ns)

    @property
    def mean_ns(self) -> float:
        return self.sum_ns / self.total if self.total else 0.0

    def snapshot(self) -> Dict:
        """Summary dict for `report()` (microseconds for readability, like
        the scalar metrics they replace)."""
        return {
            "count": self.total,
            "mean_us": self.mean_ns / 1e3,
            "p50_us": self.quantile(0.50) / 1e3,
            "p95_us": self.quantile(0.95) / 1e3,
            "p99_us": self.quantile(0.99) / 1e3,
            "max_us": self.max_ns / 1e3,
        }

    def buckets_seconds(self) -> List:
        """Cumulative (le_seconds, count) pairs for Prometheus exposition,
        trimmed to the occupied range (+Inf is appended by the renderer)."""
        out = []
        cum = 0
        hi = 0
        for i in range(NBUCKETS - 1, -1, -1):
            if self.counts[i]:
                hi = i
                break
        for i in range(hi + 1):
            cum += self.counts[i]
            out.append(((1 << i) / 1e9, cum))
        return out

    def buckets_raw(self) -> List:
        """Cumulative (le, count) pairs in the RAW recorded unit — for
        count-valued histograms (batches per @fuse dispatch, events per
        shard per batch) where a seconds conversion would lie."""
        out = []
        cum = 0
        hi = 0
        for i in range(NBUCKETS - 1, -1, -1):
            if self.counts[i]:
                hi = i
                break
        for i in range(hi + 1):
            cum += self.counts[i]
            out.append((float(1 << i), cum))
        return out

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        m = LogHistogram()
        m.counts = [a + b for a, b in zip(self.counts, other.counts)]
        m.total = self.total + other.total
        m.sum_ns = self.sum_ns + other.sum_ns
        m.max_ns = max(self.max_ns, other.max_ns)
        return m


def hist_of(registry: Dict[str, LogHistogram], name: str,
            lock=None) -> LogHistogram:
    """Get-or-create without holding `lock` on the steady-state path: the
    dict lookup is GIL-atomic; only first-touch of a name takes the lock."""
    h = registry.get(name)
    if h is not None:
        return h
    if lock is None:
        return registry.setdefault(name, LogHistogram())
    with lock:
        return registry.setdefault(name, LogHistogram())
