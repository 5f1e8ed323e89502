"""Multi-query optimizer: co-resident queries on one stream run as one
merged dispatch (port of `siddhi_tpu/optimizer/mqo.py`).

After per-query planning and before traffic, the app's plain stream
queries partition into merge groups keyed on (stream, @async / @pipeline
/ @fuse / @serve decorations) by `core/plan_facts.merge_plan`, the JAX
package's own plan copied string for string.  A group stages each batch
once: one upload, each unit's group slots resolved once, the units'
pre-window filters in ONE launch sequence of kernel K29 (one program per
unit), each unit's window kernel once per batch on its filtered rows, and
the selector of every member of a shared unit over that unit's one window
output.  Every member's header comes back in ONE device-to-host transfer,
and the demux delivers each query's events through its own callbacks,
rate limits, table writes and output stream; a member whose delivery
fails is logged and its co-members still deliver (the junction's LOG
fault semantics).

Members whose pre-window chain, window and group-by agree form a *shared*
unit: one window buffer and one group-slot allocator (the leader's) for
all of them.  Members stay in `query_runtimes` and read / write their
state through `member_state` / `set_member_state` views (`QueryRuntime.
state`).  `optimizer.merge.enabled=false` (a manager config property)
turns the pass off.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from ..core import event as ev
from ..core import plan_facts
from .. import sharding as _sharding

log = logging.getLogger("siddhi_tpu_torch")


def merge_enabled(rt) -> bool:
    """`optimizer.merge.enabled` manager config property (default on);
    any of false/0/off/no disables the pass."""
    try:
        cm = getattr(rt, "config_manager", None)
        v = cm.extract_property("optimizer.merge.enabled") \
            if cm is not None else None
    except Exception:  # noqa: BLE001 — config must not break deploy
        v = None
    if v is None:
        return True
    return str(v).strip().lower() not in ("false", "0", "off", "no")


class MergedGroupRuntime:
    """One merge group's host wrapper: stages each batch once, runs every
    unit's filters in one K29 launch sequence and the units' windows and
    selectors batch by batch, and demuxes per-query emissions.  Subscribes
    to the junction in place of its members."""

    def __init__(self, rt, gmeta: Dict, members: List[Tuple[str, object]],
                 units: List[Tuple[str, List[int]]]):
        from ..core import fusion
        self.app = rt
        self.group = gmeta["group"]
        self.stream_id = gmeta["stream"]
        self.name = f"merged:{self.group}"
        self.members = [qr for _, qr in members]
        self.units = units
        self.in_schema = self.members[0].planned.in_schema
        self.device = self.members[0].planned.device
        # ONE lock for the group: the demux re-enters member emission
        # paths, and flush takes member locks
        self._qlock = threading.RLock()
        # id(member) -> (unit, position in unit, mode)
        self._slots: Dict[int, Tuple[int, int, str]] = {}
        state: List = []
        for u, (mode, idxs) in enumerate(units):
            if mode == "solo":
                m = self.members[idxs[0]]
                self._slots[id(m)] = (u, 0, mode)
                state.append(m.state)
                continue
            lead = self.members[idxs[0]]
            astates = []
            for j, i in enumerate(idxs):
                m = self.members[i]
                self._slots[id(m)] = (u, j, mode)
                astates.append(m.state[1])
            state.append((lead.state[0], tuple(astates)))
            # shared group-slot space: every member resolves group keys
            # through the LEADER's allocator (identical key layout is the
            # shared-unit precondition)
            for i in idxs[1:]:
                self.members[i].planned.slot_allocator = \
                    lead.planned.slot_allocator
        self._state = state
        for m in self.members:
            m._state = None
            m._merged = self
            m._qlock = self._qlock
        # @fuse(batches=K) on every member: the MERGED dispatch owns the
        # stack; members drop theirs
        self._fuse = None
        k = int(gmeta.get("decorations", {}).get("fuse", 0) or 0)
        if k > 0:
            for m in self.members:
                if m._fuse is not None:
                    m._fuse = None
                    m._fuse_excluded = (
                        f"query dispatch is merged — {self.name} owns the "
                        f"@fuse stack")
            self._fuse = fusion.FuseBuffer(self, k, "merged")

    # -- state views ----------------------------------------------------------
    def member_state(self, qr):
        u, j, mode = self._slots[id(qr)]
        st = self._state[u]
        return st if mode == "solo" else (st[0], st[1][j])

    def set_member_state(self, qr, v) -> None:
        u, j, mode = self._slots[id(qr)]
        if mode == "solo":
            self._state[u] = v
            return
        w_new, a_new = v
        astates = list(self._state[u][1])
        astates[j] = a_new
        self._state[u] = (w_new, tuple(astates))

    def member_components(self, qr) -> Dict[str, int]:
        """A member's EXCLUSIVE state bytes: a shared unit's members
        carry only their selector state; the shared window is reported
        once, under the group (`shared_components`)."""
        from ..observability.memory import tree_nbytes
        u, j, mode = self._slots[id(qr)]
        st = self._state[u]
        if mode == "solo":
            return {"window": tree_nbytes(st[0]),
                    "selector": tree_nbytes(st[1])}
        return {"selector": tree_nbytes(st[1][j])}

    def shared_components(self) -> Dict[str, int]:
        """{component: bytes} the group owns: shared window buffers
        (counted once) and a pending @fuse stack."""
        from ..observability.memory import leaf_nbytes, tree_nbytes
        out: Dict[str, int] = {}
        shared = sum(tree_nbytes(self._state[u][0])
                     for u, (mode, _) in enumerate(self.units)
                     if mode == "shared")
        if shared:
            out["window[shared]"] = shared
        fb = self._fuse
        if fb is not None and fb.items:
            total = sum(leaf_nbytes(x) for st, _ in fb.items
                        for x in (st.ts, st.kind, st.valid, *st.cols))
            if total:
                out["fuse_stack"] = total
        return out

    def mode_of(self, qr) -> str:
        return "shared" if self._slots[id(qr)][2] == "shared" else "stacked"

    # -- dispatch -------------------------------------------------------------
    def process_staged(self, staged: ev.StagedBatch, now: int) -> None:
        fb = self._fuse
        if fb is not None and fb.offer((staged, now), staged, None):
            return
        self._dispatch_many([(staged, now)])

    def _dispatch_many(self, items) -> None:
        """K batches (K = 1 unfused) x every member: one upload, one K29
        launch sequence, the units' windows and selectors batch by batch,
        then the demux."""
        from ..core.fusion import _batch, _facts
        from ..core.planner import header_of
        from ..kernels import multi_filter as k29
        members, units = self.members, self.units
        stats = self.app.stats
        t0 = time.perf_counter_ns() if stats.enabled else 0
        nows = [now for _, now in items]
        # host slot staging, ONCE per unit and batch (in arrival order):
        # shared units resolve group keys through the leader
        extra, pslot_at = [], {}
        for mode, idxs in units:
            lead = members[idxs[0]]
            gs = [lead._group_slots(st) for st, _ in items]
            extra.append(np.stack(gs))
            if mode == "solo":
                pa = lead.planned.pair_allocs
                for j, (alloc, pos) in enumerate(pa):
                    pslot_at[(idxs[0], j)] = len(extra)
                    extra.append(np.stack([
                        alloc.slots_for([g, st.cols[pos]], st.valid)
                        for g, (st, _) in zip(gs, items)]))
        staged0 = items[0][0]
        if len(items) == 1 and staged0.dev is not None:
            # the serving stager's upload of this batch (started at the
            # junction's accept edge): adopted, only the slots go up here
            b = staged0.to_device(self.in_schema, self.device)
            batch = ev.EventBatch(b.ts[None], b.kind[None], b.valid[None],
                                  tuple(c[None] for c in b.cols))
            dev_extra = ev.upload(extra, self.device)
        else:
            batch, dev_extra = ev.StackedBatch(
                [st for st, _ in items]).to_device(self.in_schema,
                                                   self.device, extra)
        # `in Table` snapshots: once per merged dispatch
        kws = [self.app.in_probe_kw(m.planned.in_deps) for m in members]
        # every unit's pre-window filters in one K29 launch sequence
        progs = []
        for u, (mode, idxs) in enumerate(units):
            p = members[idxs[0]].planned
            wstate = self._state[u][0]
            if p.window.prefilters:
                progs.append((u, p.filter_spec.bind(
                    kws[idxs[0]].get("in_tabs")), p.window.arrival_seq(
                        wstate), p.window.keeps_expired))
        pre: Dict[int, List] = {}
        if progs:
            specs = [sp for _, sp, _, _ in progs]
            seqs = [sq for _, _, sq, _ in progs]
            res = k29.multi_filter(
                specs, batch.ts, batch.kind, batch.valid, batch.cols,
                [dev_extra[u] for u, _, _, _ in progs], nows, seqs,
                [kx for _, _, _, kx in progs])
            for (u, _, _, _), row in zip(progs, k29.prefiltered(
                    specs, res, seqs)):
                pre[u] = row
        results = []
        for s, (staged, now) in enumerate(items):
            bs = _batch(batch, s)
            facts = _facts(staged)
            outs: List = [None] * len(members)
            for u, (mode, idxs) in enumerate(units):
                g = dev_extra[u][s]
                pre_s = pre[u][s] if u in pre else None
                if mode == "solo":
                    i = idxs[0]
                    p = members[i].planned
                    kw = dict(kws[i])
                    if p.pair_allocs:
                        kw["pslots"] = tuple(
                            dev_extra[pslot_at[(i, j)]][s]
                            for j in range(len(p.pair_allocs)))
                    st, out, header = p.step(self._state[u], bs, g, now,
                                             facts, pre=pre_s, **kw)
                    self._state[u] = st
                    outs[i] = (out, header)
                    continue
                wstate, astates = self._state[u]
                lead = members[idxs[0]].planned
                wstate, orows, wake = lead.stage_body(
                    wstate, bs, g, now, facts,
                    kws[idxs[0]].get("in_tabs"), pre_s)
                new_as = []
                for j, i in enumerate(idxs):
                    a, out = members[i].planned.select_body(
                        astates[j], orows, now, kws[i].get("in_tabs"))
                    new_as.append(a)
                    outs[i] = (out, header_of(out, wake))
                self._state[u] = (wstate, tuple(new_as))
            results.append(outs)
        if stats.enabled:
            stats.counter_inc(f"merged.{self.group}.dispatches")
            stats.counter_inc(f"merged.{self.group}.member_batches",
                              len(members) * len(items))
        self._demux(items, results, t0)

    # -- demux: one combined fetch, per-query delivery ------------------------
    def _demux(self, items, results, t0: int = 0) -> None:
        """Deliver per-query emissions for the dispatched batches.  Sync
        mode fetches every consumed member's header across all batches in
        ONE transfer; @async / @pipeline / @serve members re-enter their
        deferred paths.  A member's delivery failure is logged (the
        junction's LOG fault semantics) without blocking its co-members.
        With statistics on, each member's latency sample is an even share
        of the dispatch plus its own delivery, and its `<query>:e2e`
        closes against the send's stamp (reference `_demux`,
        `siddhi_tpu/optimizer/mqo.py:283-340`)."""
        from ..core import runtime as _rt
        members = self.members
        m0 = members[0]
        deferred = m0.serve_emit or bool(m0.pipeline_emit) or (
            m0.async_emit and self.app._drainer is not None)
        consumers = [i for i, m in enumerate(members) if _rt._live(m)]
        hosted: Dict[Tuple[int, int], List[int]] = {}
        if consumers and not deferred:
            keys = [(s, i) for s in range(len(items)) for i in consumers]
            hosted = dict(zip(keys, _rt.fetch_headers(
                [results[s][i][1] for s, i in keys])))
        stats = self.app.stats
        stamp = self.__dict__.get("_ingest_ns")
        share = 0
        if stats.enabled:
            share = (time.perf_counter_ns() - t0) // \
                max(1, len(members) * len(items))
        live = set(consumers)
        for s, (staged, now) in enumerate(items):
            for i, m in enumerate(members):
                td = time.perf_counter_ns() if stats.enabled else 0
                out, header = results[s][i]
                try:
                    if i in live and deferred:
                        m.__dict__["_ingest_ns"] = stamp
                        try:
                            _rt._emit(m, out, header, now,
                                      _rt._deliver_plain)
                        finally:
                            m.__dict__["_ingest_ns"] = None
                    elif i in live:
                        _rt._deliver_plain(m, out, hosted[(s, i)], now)
                except Exception:  # noqa: BLE001 — per-query fault
                    log.exception("stream %s: query %s failed in merge "
                                  "group %s; batch of %d events dropped for "
                                  "it", self.stream_id, m.name, self.group,
                                  staged.n)
                finally:
                    if stats.enabled:
                        stats.query_latency(
                            m.name, staged.n,
                            share + time.perf_counter_ns() - td)
                        if i in live and not deferred and \
                                stamp is not None:
                            stats.e2e_latency(
                                m.name, time.perf_counter_ns() - stamp)


def apply_merge(rt) -> None:
    """Run the merge pass over a freshly constructed SiddhiAppRuntime:
    build a MergedGroupRuntime per group of `plan_facts.merge_plan`, swap
    the junction subscriptions, and record the reason on every unmerged
    query."""
    from ..core import runtime as _rt
    rt.merged_groups = {}
    rt._merge_reasons = {}
    if not merge_enabled(rt):
        why = "multi-query merge disabled (optimizer.merge.enabled=false)"
        for name, qr in rt.query_runtimes.items():
            qr._merge_excluded = why
            rt._merge_reasons[name] = why
        return
    try:
        plan = plan_facts.merge_plan(
            rt.app, mesh_devices=_sharding.shard_count(rt))
    except Exception as exc:  # noqa: BLE001 — the pass must not break deploy
        log.warning("multi-query merge pass skipped: %r", exc)
        return
    reasons = dict(plan["reasons"])
    for g in plan["groups"]:
        junction = rt.junctions.get(g["stream"])
        subs = {id(getattr(q, "_qr", None)): q
                for q in (junction.queries if junction is not None else [])}
        members: List[Tuple[str, object]] = []
        for name in g["members"]:
            qr = rt.query_runtimes.get(name)
            p = getattr(qr, "planned", None)
            ok = (isinstance(qr, _rt.QueryRuntime) and p is not None
                  and getattr(p, "stage_body", None) is not None
                  and not getattr(p, "needs_timer", False)
                  and not getattr(p, "keyed_window", False)
                  and getattr(p, "partition_key_fn", None) is None
                  and id(qr) in subs)
            if ok:
                members.append((name, qr))
            else:
                reasons[name] = ("planner produced no mergeable step body "
                                 "for this query (demoted)")
        if len(members) < 2:
            for name, _qr in members:
                reasons[name] = (
                    f"no co-resident query shares stream {g['stream']!r} "
                    f"and its @async/@pipeline/@fuse/@serve decorations")
            continue
        kept = {n for n, _ in members}
        pos_of = {n: i for i, (n, _) in enumerate(members)}
        units: List[Tuple[str, List[int]]] = []
        for u in g["units"]:
            names = [n for n in u["members"] if n in kept]
            if not names:
                continue
            if u["mode"] == "shared" and len(names) >= 2:
                units.append(("shared", [pos_of[n] for n in names]))
            else:
                for n in names:
                    units.append(("solo", [pos_of[n]]))
        mg = MergedGroupRuntime(rt, g, members, units)
        rt.merged_groups[mg.group] = mg
        # the merged runtime takes the FIRST member's junction slot
        qs = junction.queries
        pos = qs.index(subs[id(members[0][1])])
        for _name, qr in members:
            qs.remove(subs[id(qr)])
        qs.insert(pos, _rt._QSub(mg))
        log.info("multi-query merge: %s merges %d queries on %r (%d shared "
                 "unit(s))", mg.name, len(members), g["stream"],
                 sum(1 for mode, _ in units if mode == "shared"))
    for name, why in reasons.items():
        qr = rt.query_runtimes.get(name)
        if qr is not None:
            qr._merge_excluded = why
    rt._merge_reasons = reasons
