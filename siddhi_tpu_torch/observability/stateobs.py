"""State observatory: occupancy, key hotness and high-water telemetry (port of
`siddhi_tpu/observability/stateobs.py`).

Every sized device structure has a HOST mirror (`SlotAllocator`,
`JoinKeyTracker`, the emission header, the serving ring's counters), so the
observatory is an always-on accumulator over those mirrors that never adds
a device fetch or a sync.  The one device quantity without a mirror, the
fill of a plain window's buffers, is counted by kernel K33 `fill_probe`
(`kernels/fill_probe.py`) every `state.obs.sample.every`-th dispatch of an
unkeyed single-stream step; its counts ride the header fetch the delivery
already makes (`core/runtime.py` `_deliver_output`).

Key hotness: each staged batch's key set (slot ids + per-key row counts)
folds into a count-min sketch, a space-saving top-64 and an exact distinct
bitmap.  The per-key work runs in the port's host C
(`native/staging.c` `sg_hot_update`), with results equal to the JAX
package's numpy / dict version: the same hashes, the same victim (the
first of the minimum counts in insertion order), a replaced key moved to
the end.  `top()`, `hot_share()` and `snapshot()` stay in Python over the
64 entries.

Config: `state.obs.enabled` (default true; false turns off the hotness
feed and the probe), `state.obs.sample.every` (probe modulus, default 8,
0 disables it), `state.obs.near.capacity` (health's near-capacity
threshold, default 0.9).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# canonical structure order — every surface lists structures in this
# order, not dict order (the phases.PHASES convention)
STRUCTURES = ("window_keys", "group_slots", "pattern_keys", "pair_slots",
              "join_keys", "join_lane", "window_fill", "emission_cap",
              "serve_ring")

# count-min sketch geometry: 4 rows x 1024 counters of int64 = 32 KiB
# per tracked query — error bound e*total/1024 per estimate, one-sided
_CMS_DEPTH = 4
_CMS_WIDTH = 1024
# odd multipliers for the per-row multiply-shift hashes (keys are dense
# non-negative slot ints, so multiply-shift mixes them well enough)
_CMS_MULT = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE35, 0x27D4EB2F)
_TOPK = 64


class KeyHotness:
    """Per-query key-traffic tracker: count-min sketch + space-saving
    top-K + exact distinct bitmap.  Fed from staging's per-batch key sets
    (slot ids + per-key row counts), host numpy only.  The per-key work
    runs in `native/staging.c` `sg_hot_update`; without the native
    library it runs the same algorithm in Python (`_feed_py`)."""

    __slots__ = ("_cms", "_seen", "_ss_keys", "_ss_counts", "_ss_n",
                 "_nxt", "_prv", "_aux", "_filter", "total")

    def __init__(self, capacity: int):
        self._cms = np.zeros((_CMS_DEPTH, _CMS_WIDTH), np.int64)
        self._seen = np.zeros(max(1, int(capacity)), np.uint8)
        # space-saving entries in fixed slots [0, _ss_n), linked in
        # insertion order (_nxt / _prv, head and tail in _aux)
        self._ss_keys = np.zeros(_TOPK, np.int64)
        self._ss_counts = np.zeros(_TOPK, np.int64)
        self._ss_n = np.zeros(1, np.int32)
        self._nxt = np.full(_TOPK, -1, np.int32)
        self._prv = np.full(_TOPK, -1, np.int32)
        # [caches valid, least count, cursor, head, tail]; the C feed
        # rebuilds its caches (and its counting filter) while [0] is 0
        self._aux = np.array([0, 0, -1, -1, -1], np.int64)
        self._filter = np.zeros(4096, np.uint16)
        self.total = 0

    @property
    def _ss(self) -> Dict[int, int]:
        """The top-K as the JAX package's dict: key -> count, in
        insertion order."""
        out: Dict[int, int] = {}
        j = int(self._aux[3])
        while j >= 0:
            out[int(self._ss_keys[j])] = int(self._ss_counts[j])
            j = int(self._nxt[j])
        return out

    def update(self, keys, counts) -> None:
        keys = np.ascontiguousarray(keys, np.int64).ravel()
        counts = np.ascontiguousarray(counts, np.int64).ravel()
        if keys.size == 0:
            return
        from ..native import LIB, ptr
        if LIB is None:
            self.total += self._feed_py(keys, counts)
            return
        import ctypes
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        self.total += int(LIB.sg_hot_update(
            ptr(self._cms, i64), ptr(self._seen, ctypes.c_uint8),
            self._seen.shape[0], ptr(self._ss_keys, i64),
            ptr(self._ss_counts, i64), ptr(self._ss_n, i32),
            ptr(self._nxt, i32), ptr(self._prv, i32), ptr(self._aux, i64),
            ptr(self._filter, ctypes.c_uint16), ptr(keys, i64),
            ptr(counts, i64), keys.size))

    def _feed_py(self, keys: np.ndarray, counts: np.ndarray) -> int:
        """`sg_hot_update` in Python: the rows added to the total."""
        added = 0
        ss = self._ss
        cap = self._seen.shape[0]
        for k, c in zip(keys.tolist(), counts.tolist()):
            if k < 0 or c <= 0:
                continue
            added += c
            if k < cap:
                self._seen[k] = 1
            kk = np.int64(k + 1)
            for d in range(_CMS_DEPTH):
                self._cms[d, (kk * np.int64(_CMS_MULT[d])) % (2 ** 31)
                          % _CMS_WIDTH] += c
            if k in ss:
                ss[k] += c
            elif len(ss) < _TOPK:
                ss[k] = c
            else:
                victim = min(ss, key=ss.get)
                ss[k] = ss.pop(victim) + c
        n = len(ss)
        self._ss_keys[:n] = list(ss.keys())
        self._ss_counts[:n] = list(ss.values())
        self._ss_n[0] = n
        order = np.arange(n, dtype=np.int32)
        self._nxt[:n] = np.where(order + 1 < n, order + 1, -1)
        self._prv[:n] = order - 1
        self._aux[:] = [0, 0, -1, 0 if n else -1, n - 1]
        return added

    @property
    def distinct(self) -> int:
        return int(np.count_nonzero(self._seen))

    def estimate(self, key: int) -> int:
        """CMS point estimate — never underestimates the true count."""
        k = np.int64(key)
        return int(min(
            self._cms[d][((k + 1) * _CMS_MULT[d]) % (2 ** 31) % _CMS_WIDTH]
            for d in range(_CMS_DEPTH)))

    def top(self, n: int = 10) -> List[Tuple[int, int]]:
        """Heavy hitters with tightened counts: the space-saving count
        and the CMS estimate are both one-sided upper bounds, so their
        min is a tighter upper bound — this keeps eviction inflation
        (space-saving's min-floor creep under uniform traffic) from
        masquerading as heat."""
        items = [(k, min(c, self.estimate(k)))
                 for k, c in self._ss.items()]
        return sorted(items, key=lambda kv: -kv[1])[:n]

    def hot_share(self, fraction: float = 0.01) -> float:
        """Share of total keyed traffic landing in the hottest
        ceil(distinct * fraction) keys (at least one key)."""
        if not self.total:
            return 0.0
        k = max(1, int(np.ceil(self.distinct * fraction)))
        hot = sum(c for _, c in self.top(k))
        return min(1.0, hot / self.total)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "total": self.total,
            "distinct": self.distinct,
            "hot_share_1pct": round(self.hot_share(0.01), 4),
            "top": [[int(k), int(c)] for k, c in self.top(8)],
        }


class StateObservatory:
    """Always-on per-(query, structure) utilization accumulator.  One
    per StatisticsManager (i.e. per app runtime); `observe` is the
    single hot-path entry — a dict upsert under a short lock."""

    __slots__ = ("_lock", "_rec", "_hot")

    def __init__(self):
        self._lock = threading.Lock()
        # (query, structure) -> [occupancy, capacity, high_water,
        #                        growable, config_key]
        self._rec: Dict[tuple, list] = {}
        self._hot: Dict[str, KeyHotness] = {}

    def observe(self, query: str, structure: str,
                occupancy: Optional[int], capacity: int,
                growable: bool = True,
                config_key: Optional[str] = None) -> None:
        """Record one occupancy sample (high-water = running max).
        occupancy=None refreshes capacity/metadata only — the HWM a
        restore adopted survives untouched until real traffic beats
        it."""
        key = (query, structure)
        with self._lock:
            rec = self._rec.get(key)
            if rec is None:
                rec = self._rec[key] = [0, 0, 0, True, None]
            if occupancy is not None:
                occ = int(occupancy)
                rec[0] = occ
                if occ > rec[2]:
                    rec[2] = occ
            rec[1] = int(capacity)
            rec[3] = bool(growable)
            if config_key is not None:
                rec[4] = config_key

    def feed_keys(self, query: str, capacity: int, keys, counts) -> None:
        """Fold one staged batch's key set (slot ids + per-key row
        counts, both host numpy) into the query's hotness tracker."""
        with self._lock:
            hot = self._hot.get(query)
            if hot is None:
                hot = self._hot[query] = KeyHotness(capacity)
            hot.update(keys, counts)

    def hotness(self, query: str) -> Optional[KeyHotness]:
        with self._lock:
            return self._hot.get(query)

    def snapshot(self) -> Dict[str, Any]:
        """{"structures": {q: {s: {...}}}, "hotness": {q: {...}}} —
        structures in canonical order; scrape-safe shallow reads."""
        with self._lock:
            recs = {k: list(v) for k, v in self._rec.items()}
            hots = {q: h.snapshot() for q, h in self._hot.items()}
        structures: Dict[str, Dict] = {}
        for (q, s), (occ, cap, hwm, growable, ck) in recs.items():
            # utilization may exceed 1.0 for emission_cap: occupancy is
            # the batch's total row DEMAND while a partitioned pattern's
            # @emit cap is per-key — >1 reads as drop/growth pressure,
            # not arena fill
            structures.setdefault(q, {})[s] = {
                "occupancy": occ,
                "capacity": cap,
                "utilization": round(occ / cap, 4) if cap else 0.0,
                "high_water": hwm,
                "growable": growable,
                **({"config_key": ck} if ck else {}),
            }
        for q in structures:
            ordered = {s: structures[q][s] for s in STRUCTURES
                       if s in structures[q]}
            ordered.update({s: v for s, v in structures[q].items()
                            if s not in ordered})
            structures[q] = ordered
        return {"structures": structures, "hotness": hots}

    # -- sizing-hints ledger ---------------------------------------------
    def ledger(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{query: {structure: {"high_water", "capacity"}}} — the
        sizing-hints payload the JAX package carries in app snapshots
        (the port's snapshots and their restore wait for ROADMAP A13).

        `window_fill` is excluded: a sliding window trends to full by
        design (its capacity IS the configured length, nothing to
        learn), and the sampled probe rides the unfused delivery fetch
        — whether an entry exists depends on dispatch strategy, which
        would break the fused-vs-sequential snapshot byte-parity
        contract (the JAX package's tests/test_fused.py).  It stays a live surface
        (state_report/metrics/EXPLAIN), just not a persisted hint."""
        with self._lock:
            out: Dict[str, Dict] = {}
            for (q, s), (_, cap, hwm, _, _) in self._rec.items():
                if s == "window_fill":
                    continue
                out.setdefault(q, {})[s] = {"high_water": int(hwm),
                                            "capacity": int(cap)}
            return out

    def reset(self) -> None:
        with self._lock:
            self._rec.clear()
            self._hot.clear()


# -- config memos (the phases.sample_every pattern) -------------------------

def obs_enabled(rt) -> bool:
    """`state.obs.enabled` (default true), memoized on the runtime —
    the hot path reads one dict slot, never the ConfigManager."""
    on = rt.__dict__.get("_stateobs_enabled")
    if on is None:
        on = True
        try:
            cm = getattr(rt, "config_manager", None)
            v = cm.extract_property("state.obs.enabled") \
                if cm is not None else None
            if v is not None:
                on = str(v).strip().lower() not in ("false", "0", "no")
        except Exception:  # noqa: BLE001 — observability must not throw
            on = True
        rt.__dict__["_stateobs_enabled"] = on
    return on


def obs_sample_every(rt) -> int:
    """`state.obs.sample.every` — window-fill probe modulus (default 8,
    0 disables the sampled probe entirely), memoized like obs_enabled."""
    every = rt.__dict__.get("_stateobs_sample_every")
    if every is None:
        every = 8
        try:
            cm = getattr(rt, "config_manager", None)
            v = cm.extract_property("state.obs.sample.every") \
                if cm is not None else None
            if v is not None:
                every = max(0, int(v))
        except Exception:  # noqa: BLE001 — observability must not throw
            every = 8
        rt.__dict__["_stateobs_sample_every"] = every
    return every


def near_capacity_threshold(rt) -> float:
    """`state.obs.near.capacity` — /healthz degraded threshold over
    non-growable structures (default 0.9)."""
    th = rt.__dict__.get("_stateobs_near_capacity")
    if th is None:
        th = 0.9
        try:
            cm = getattr(rt, "config_manager", None)
            v = cm.extract_property("state.obs.near.capacity") \
                if cm is not None else None
            if v is not None:
                th = min(1.0, max(0.0, float(v)))
        except Exception:  # noqa: BLE001 — observability must not throw
            th = 0.9
        rt.__dict__["_stateobs_near_capacity"] = th
    return th


# tiny test fixtures legitimately run 100%-full 4-key allocators; below
# this capacity a full arena is sizing noise, not an incident
_NEAR_CAPACITY_MIN_CAP = 16

# a sliding length/time window runs 100% full at steady state — that is
# its job, not an incident — and emission-cap "occupancy" is per-batch
# row demand (legitimately >cap for partitioned patterns, and already
# surfaced by drop counters + adaptive growth); only arenas where
# "full" means "next new key raises" count toward the near-capacity
# verdict
_NEAR_CAPACITY_EXEMPT = frozenset({"window_fill", "emission_cap"})


# -- pull collection over the host mirrors ----------------------------------

def collect(rt) -> None:
    """Refresh the observatory from every query's HOST mirrors: slot
    allocators (len/capacity attribute reads), the join tracker's lane
    demand, emission-cap plan metadata, serve-ring facts.  Pure host
    object walk — scrape surfaces call this under the monkeypatched
    never-fetch bomb and must survive."""
    if not obs_enabled(rt):
        return
    obs = rt.stats.stateobs
    for qname, qr in list(getattr(rt, "query_runtimes", {}).items()):
        try:
            _collect_query(obs, qname, qr)
        except Exception:  # noqa: BLE001 — metrics must not throw
            pass


def _collect_query(obs: StateObservatory, qname: str, qr) -> None:
    p = qr.planned
    wk = getattr(p, "window_key_allocator", None)
    if wk is not None:
        obs.observe(qname, "window_keys", len(wk), wk.capacity,
                    growable=False, config_key="@capacity(keys='N')")
    ga = getattr(p, "slot_allocator", None)
    if ga is not None and getattr(qr, "slot_allocator", None) is not ga:
        obs.observe(qname, "group_slots", len(ga), ga.capacity,
                    growable=False, config_key="@capacity(groups='N')")
    pairs = getattr(p, "pair_allocs", None) or ()
    if pairs:
        obs.observe(qname, "pair_slots",
                    max(len(a) for a, _ in pairs),
                    max(a.capacity for a, _ in pairs),
                    growable=False, config_key="@capacity(groups='N')")
    # pattern slab allocator lives on the runtime, not the plan
    pa = getattr(qr, "slot_allocator", None)
    if pa is not None:
        obs.observe(qname, "pattern_keys", len(pa), pa.capacity,
                    growable=False, config_key="@capacity(keys='N')")
    jk_alloc = getattr(p, "join_key_allocator", None)
    if jk_alloc is not None:
        obs.observe(qname, "join_keys", len(jk_alloc), jk_alloc.capacity,
                    growable=False, config_key="@capacity(keys='N')")
    jk = getattr(qr, "_jk", None)
    if jk is not None:
        obs.observe(qname, "join_lane", jk.needed_k(),
                    getattr(p, "lane_k", 0) or 0, growable=True,
                    config_key="auto (lane grows via replan)")
    cap = getattr(p, "compact_rows", None)
    if cap is not None:
        obs.observe(qname, "emission_cap", None, cap,
                    growable=not getattr(p, "emit_explicit", True),
                    config_key="@emit(rows='N')")
    ring = qr.__dict__.get("_serve_ring")
    if ring is not None:
        obs.observe(qname, "serve_ring", ring.occupancy(), ring.capacity,
                    growable=True, config_key="serving.ring.capacity")


# -- window-fill probe (sampled; the counts ride the delivery fetch) ---------

def arm_fill_probe(qr) -> None:
    """Every Nth dispatch of an unkeyed single-stream step, launch kernel
    K33 over the window state's fill sources (`fill_sources`, one per
    JAX `alive` leaf) and stash the int64[n] counts on the runtime:
    `_deliver_output` joins them to the header it fetches (no added
    transfer, no sync).  A state with no window Buffer in the JAX layout
    turns the probe off for good.  A K33 build or launch failure
    propagates; only the host bookkeeping is guarded."""
    rt = qr.app
    if qr.__dict__.get("_stateobs_probe_off"):
        return
    if not obs_enabled(rt):
        return
    every = obs_sample_every(rt)
    if every <= 0:
        return
    n = qr.__dict__.get("_stateobs_tick", 0) + 1
    qr.__dict__["_stateobs_tick"] = n
    if n % every:
        return
    srcs = qr.planned.window.fill_sources(qr.state[0])
    if not srcs:
        qr.__dict__["_stateobs_probe_off"] = True
        return
    from ..kernels import fill_probe
    counts = fill_probe.fill_counts(srcs)
    qr.__dict__["_stateobs_probe"] = counts
    qr.__dict__["_stateobs_probe_caps"] = [s.cap for s in srcs]


def take_fill_probe(qr):
    """Pop the pending fill counts (a device tensor) or None."""
    return qr.__dict__.pop("_stateobs_probe", None)


def record_fill(qr, fills) -> None:
    """Fold fetched fill counts back into the observatory (summed across
    the query's window buffers; capacity is their total row capacity)."""
    if fills is None:
        return
    caps = qr.__dict__.get("_stateobs_probe_caps") or []
    try:
        fill = int(np.asarray(fills).sum())
        cap = int(sum(caps)) or 1
        qr.app.stats.stateobs.observe(
            qr.name, "window_fill", fill, cap, growable=False,
            config_key="window length/time capacity")
    except Exception:  # noqa: BLE001 — observability must not throw
        pass


# -- reports ----------------------------------------------------------------

def near_capacity(rt, snap: Optional[Dict] = None) -> List[Dict]:
    """Non-growable structures at/over the near-capacity threshold —
    the /healthz degraded trigger and the STATE003 lint input."""
    if snap is None:
        snap = rt.stats.stateobs.snapshot()
    th = near_capacity_threshold(rt)
    out: List[Dict] = []
    for q, structures in snap["structures"].items():
        for s, rec in structures.items():
            if rec["growable"] or s in _NEAR_CAPACITY_EXEMPT \
                    or rec["capacity"] < _NEAR_CAPACITY_MIN_CAP:
                continue
            if rec["occupancy"] >= th * rec["capacity"]:
                out.append({"query": q, "structure": s,
                            "occupancy": rec["occupancy"],
                            "capacity": rec["capacity"],
                            "utilization": rec["utilization"],
                            **({"config_key": rec["config_key"]}
                               if rec.get("config_key") else {})})
    return out


def state_report(rt) -> Dict:
    """Full observatory report for one app: per-structure utilization
    and high-water marks, key hotness, near-capacity verdicts, and the
    sizing-hints ledger a snapshot would carry.  Host-side reads only —
    safe to call on a live app."""
    enabled = obs_enabled(rt)
    if enabled:
        collect(rt)
    obs = rt.stats.stateobs
    snap = obs.snapshot()
    return {
        "app": rt.name,
        "enabled": enabled,
        "sample_every": obs_sample_every(rt),
        "structures": snap["structures"],
        "hotness": snap["hotness"],
        "near_capacity": near_capacity(rt, snap) if enabled else [],
        "sizing_hints": obs.ledger(),
    }
