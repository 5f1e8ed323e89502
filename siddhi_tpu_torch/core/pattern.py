"""Pattern / sequence matching as a vectorised slot-slab NFA (PyTorch port of
`siddhi_tpu/core/pattern.py`).

A pattern compiles to a linear chain of atoms.  Runtime state is a fixed
slab of P pending slots per key, with the captured event columns of each
atom.  One step consumes a micro-batch laid out per key as [K, E]; a loop
walks the E event columns (sequential semantics within a key) and each tick
evaluates every chain position for every (slot, key) at once.

Tick phase order (strict): within-expiry -> absent-deadline advance ->
match eval (pre-capture state) -> in-place capture -> emission gather ->
fork/seed spawn -> in-place advance / kill / deactivate.

Absent atoms (`not X for t`, and the absent side of `not A and B`) hold no
captures: a pending state waits at an absent atom until its deadline
(phase 2 advances or completes it, driven by events or by the planner's
timer step), and a matching arrival of the absent stream kills it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..query_api.expression import Expression
from ..query_api.query import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    Filter,
    LogicalStateElement,
    NextStateElement,
    SingleInputStream,
    StateElement,
    StateInputStream,
    StreamStateElement,
)
from . import event as ev
from .executor import CompileError, CompiledExpr, Scope, compile_expression
from ..kernels.in_probe import probe_env


# ---------------------------------------------------------------------------
# Compilation: StateElement tree -> linear atom chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Atom:
    pos: int
    stream_id: str
    ref: str
    filter_expr: Optional[Expression]
    min_count: int = 1
    max_count: int = 1            # -1 == ANY
    absent: bool = False
    waiting_time: Optional[int] = None
    every: bool = False
    logical: Optional[str] = None  # 'AND' | 'OR' (self = side 0)
    partner: Optional["Atom"] = None
    capture_depth: int = 1

    @property
    def is_count(self) -> bool:
        return self.max_count != 1 or self.min_count != 1

    @property
    def ckey(self) -> str:
        return f"{self.pos}:{self.ref}"


@dataclasses.dataclass
class PatternSpec:
    atoms: List[Atom]
    state_type: str               # PATTERN | SEQUENCE
    within: Optional[int]
    count_cap: int = 8

    @property
    def n_states(self) -> int:
        return len(self.atoms)

    @property
    def stream_ids(self) -> List[str]:
        out = []
        for a in self.all_atoms():
            if a.stream_id not in out:
                out.append(a.stream_id)
        return out

    def all_atoms(self):
        for a in self.atoms:
            yield a
            if a.partner is not None:
                yield a.partner

    @property
    def has_absent(self) -> bool:
        """True when timer-driven absent machinery is needed: standalone
        `not X for t` atoms, or timed absent sides of logical pairs
        (instant `not A and B` needs no timers)."""
        return any(
            a.absent or (a.partner is not None and a.partner.absent and
                         a.partner.waiting_time is not None)
            for a in self.atoms)


def linearize(sis: StateInputStream, count_cap: int = 8) -> PatternSpec:
    atoms: List[Atom] = []

    def mk_atom(stream: SingleInputStream, pos: int, every: bool) -> Atom:
        filt = None
        for h in stream.stream_handlers:
            if isinstance(h, Filter):
                if filt is not None:
                    raise CompileError("multiple filters on a pattern element")
                filt = h.expression
            else:
                raise CompileError(
                    "windows/functions on pattern elements not supported")
        ref = stream.stream_reference_id or f"__p{pos}"
        return Atom(pos, stream.stream_id, ref, filt, every=every)

    def rec(el: StateElement, every: bool):
        if isinstance(el, NextStateElement):
            rec(el.state_element, every)
            rec(el.next_state_element, False)
        elif isinstance(el, EveryStateElement):
            rec(el.state_element, True)
        elif isinstance(el, StreamStateElement):
            atoms.append(mk_atom(el.basic_single_input_stream,
                                 len(atoms), every))
        elif isinstance(el, AbsentStreamStateElement):
            a = mk_atom(el.basic_single_input_stream, len(atoms), every)
            a.absent = True
            a.waiting_time = el.waiting_time
            if a.waiting_time is None:
                raise CompileError(
                    "absent pattern elements need 'for <time>' in this build")
            atoms.append(a)
        elif isinstance(el, CountStateElement):
            inner = el.stream_state_element
            a = mk_atom(inner.basic_single_input_stream, len(atoms), every)
            a.min_count = el.min_count
            a.max_count = el.max_count
            cap = count_cap if el.max_count == CountStateElement.ANY \
                else min(el.max_count, count_cap)
            a.capture_depth = max(cap, 1)
            atoms.append(a)
        elif isinstance(el, LogicalStateElement):
            def to_parts(x):
                if isinstance(x, StreamStateElement):
                    return x.basic_single_input_stream, False, None
                if isinstance(x, AbsentStreamStateElement):
                    return x.basic_single_input_stream, True, x.waiting_time
                raise CompileError(
                    "logical pattern sides must be plain or absent stream "
                    "elements")
            s1, ab1, wt1 = to_parts(el.stream_state_element_1)
            s2, ab2, wt2 = to_parts(el.stream_state_element_2)
            if ab1 and ab2:
                raise CompileError(
                    "both sides of a logical pattern cannot be absent")
            if (ab1 or ab2) and el.type == "OR":
                raise CompileError(
                    "'not X or Y' is not a valid pattern (reference: "
                    "logical absent combines with 'and' only)")
            pos = len(atoms)
            wt = wt1 if ab1 else wt2
            if (ab1 or ab2) and wt is not None and pos == 0:
                raise CompileError(
                    "leading 'not X for <time> and Y' is not supported in "
                    "this build (the wait clock starts at a preceding "
                    "stage); precede it with a stage or drop 'for <time>'")
            # the PRESENCE side is always the primary atom (it seeds and
            # captures); an absent side rides as the partner: its arrival
            # kills the pending state until the waiting time (if any) has
            # elapsed, after which the absence obligation is satisfied
            if ab1:
                a = mk_atom(s2, pos, every)
                b = mk_atom(s1, pos, False)
                b.absent = True
            else:
                a = mk_atom(s1, pos, every)
                b = mk_atom(s2, pos, False)
                b.absent = ab2
            b.waiting_time = wt if (ab1 or ab2) else None
            if b.ref == a.ref or b.ref == f"__p{pos}":
                b.ref = f"__p{pos}b"
            a.logical = el.type
            a.partner = b
            atoms.append(a)
        else:
            raise CompileError(
                f"unsupported pattern element {type(el).__name__}")

    rec(sis.state_element, False)
    if not atoms:
        raise CompileError("empty pattern")
    return PatternSpec(atoms, sis.state_type, sis.within_time,
                       count_cap=count_cap)


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

class PatternState(NamedTuple):
    """Per-key NFA slab.  The key axis K is LAST on every leaf, so the packed
    blobs are [W, K] key-minor: one thread per key reads neighbouring
    addresses."""
    active: Any       # bool[P,K]
    pos: Any          # i32[P,K]
    count: Any        # i32[P,K] captures at current pos
    lmask: Any        # i32[P,K] logical sides satisfied (bit0/bit1)
    start_ts: Any     # i64[P,K]
    entry_ts: Any     # i64[P,K] ts of entering current pos
    seed_on: Any      # bool[K]
    done: Any         # bool[K]  non-every pattern already matched
    dropped: Any      # i64 scalar: forks dropped on slab overflow
    caps: Dict[str, Tuple]   # atom.ckey -> (ts[P,D,K], cols tuple [P,D,K])


class PatternExec:
    def __init__(self, spec: PatternSpec, schemas: Dict[str, ev.Schema],
                 interner: ev.StringInterner, slots: int = 8,
                 emit_refs: Optional[set] = None,
                 device: Optional[torch.device] = None,
                 in_col0_types: Optional[Dict[str, str]] = None):
        self.spec = spec
        self.schemas = schemas
        self.P = slots
        self.S = spec.n_states
        self.interner = interner
        self.device = device if device is not None else torch.device("cpu")
        # emission pruning: only captures referenced by the query's selector
        # are materialised into per-match output rows (None = all)
        self.emit_refs = emit_refs

        # selector-facing scope: every non-absent atom ref is a source
        self.scope = Scope(self.device)
        self.scope.interner = interner
        for a in spec.all_atoms():
            if not a.absent:
                self.scope.add_source(a.ref, schemas[a.stream_id])

        # per-atom filter scopes: unqualified attrs bind to the atom's OWN
        # stream (the incoming event); qualified refs reach earlier captures
        # `x in Table` probes: the tables the query reads, and each one's
        # first attribute type (the kernels' compare types)
        self._filters: Dict[str, Optional[CompiledExpr]] = {}
        self.filter_scopes: Dict[str, Scope] = {}
        self.in_col0_types: Dict[str, str] = dict(in_col0_types or {})
        self.in_deps: List[str] = list(self.in_col0_types)
        for a in spec.all_atoms():
            if a.filter_expr is None:
                self._filters[a.ckey] = None
                continue
            fscope = Scope(self.device)
            fscope.interner = interner
            fscope.add_source(a.ref, schemas[a.stream_id], default=True)
            for other in spec.all_atoms():
                if other.ckey != a.ckey and not other.absent:
                    fscope.add_source(other.ref, schemas[other.stream_id],
                                      default=False)
            self.filter_scopes[a.ckey] = fscope
            self._filters[a.ckey] = compile_expression(a.filter_expr, fscope)

    # -- state ----------------------------------------------------------------
    def init_state(self, K: int) -> PatternState:
        P, dev = self.P, self.device
        caps: Dict[str, Tuple] = {}
        for a in self.spec.all_atoms():
            if a.absent:
                continue
            schema = self.schemas[a.stream_id]
            D = a.capture_depth
            # unfilled captures are NULL, not zero; the ts plane holds -1
            cols = tuple(
                torch.full((P, D, K), ev.null_value(t), dtype=d, device=dev)
                for t, d in zip(schema.types, schema.dtypes))
            caps[a.ckey] = (torch.full((P, D, K), -1, dtype=torch.int64,
                                       device=dev), cols)
        return PatternState(
            active=torch.zeros((P, K), dtype=torch.bool, device=dev),
            pos=torch.zeros((P, K), dtype=torch.int32, device=dev),
            count=torch.zeros((P, K), dtype=torch.int32, device=dev),
            lmask=torch.zeros((P, K), dtype=torch.int32, device=dev),
            start_ts=torch.zeros((P, K), dtype=torch.int64, device=dev),
            entry_ts=torch.zeros((P, K), dtype=torch.int64, device=dev),
            seed_on=torch.ones((K,), dtype=torch.bool, device=dev),
            done=torch.zeros((K,), dtype=torch.bool, device=dev),
            dropped=torch.zeros((), dtype=torch.int64, device=dev),
            caps=caps,
        )

    # -- one event per key ----------------------------------------------------
    def tick(self, st: PatternState, stream_id: str, ev_cols, ev_ts,
             ev_valid, now_k, in_tabs=None):
        spec = self.spec
        S = self.S
        P, K = st.active.shape
        a0 = spec.atoms[0]
        F = torch.zeros((P, K), dtype=torch.bool, device=st.active.device)

        # ---- phase 1: within expiry ----------------------------------------
        if spec.within is not None:
            alive = now_k[None, :] - st.start_ts <= spec.within
            st = st._replace(active=torch.logical_and(st.active, alive))

        # ---- phase 2: absent deadlines -------------------------------------
        absent_complete = F
        absent_ts = torch.zeros((P, K), dtype=torch.int64, device=F.device)
        for a in spec.atoms:
            if not a.absent:
                continue
            at_pos = st.active & (st.pos == a.pos)
            due = at_pos & (st.entry_ts + a.waiting_time <= now_k[None, :])
            if a.pos == S - 1:
                absent_complete = absent_complete | due
                absent_ts = torch.where(due, st.entry_ts + a.waiting_time,
                                        absent_ts)
                st = st._replace(active=st.active & torch.logical_not(due))
            else:
                st = st._replace(
                    pos=torch.where(due, a.pos + 1, st.pos).to(torch.int32),
                    count=torch.where(due, 0, st.count).to(torch.int32),
                    lmask=torch.where(due, 0, st.lmask).to(torch.int32),
                    entry_ts=torch.where(due, st.entry_ts + a.waiting_time,
                                         st.entry_ts))

        # timed logical-absent pairs (`not A for t and B`): when the wait
        # elapses without a matching A, the absence obligation is SATISFIED
        # (bit 2 in lmask); the state fires once B has also arrived --
        # whichever of {deadline, B} comes last triggers the completion
        for a in spec.atoms:
            p = a.partner
            if p is None or not p.absent or p.waiting_time is None:
                continue
            at_pos = st.active & (st.pos == a.pos)
            pend = at_pos & ((st.lmask & 2) == 0)
            due = pend & (st.entry_ts + p.waiting_time <= now_k[None, :])
            have_b = (st.lmask & 1) != 0
            fire = due & have_b
            st = st._replace(lmask=torch.where(due, st.lmask | 2, st.lmask)
                             .to(torch.int32))
            if a.pos == S - 1:
                absent_complete = absent_complete | fire
                absent_ts = torch.where(fire, st.entry_ts + p.waiting_time,
                                        absent_ts)
                st = st._replace(active=st.active & torch.logical_not(fire))
            else:
                st = st._replace(
                    pos=torch.where(fire, a.pos + 1, st.pos).to(torch.int32),
                    count=torch.where(fire, 0, st.count).to(torch.int32),
                    lmask=torch.where(fire, 0, st.lmask).to(torch.int32),
                    entry_ts=torch.where(fire, st.entry_ts + p.waiting_time,
                                         st.entry_ts))

        # ---- phase 3: match evaluation (pre-capture state) -----------------
        env = self._build_env(st, ev_ts, in_tabs)
        ev_ok = torch.logical_and(ev_valid, torch.logical_not(st.done))

        advance_inplace = F
        complete = absent_complete
        deactivate = absent_complete
        fork = F
        kill = F
        matched_any = F
        capture: Dict[str, Any] = {}
        lmask_new = st.lmask
        # epsilon closure over zero-min count atoms (e1? / e1*): a thread
        # parked at q that has collected NOTHING there may match a later
        # atom p directly when every atom in [q, p) is a plain zero-min count
        skip_srcs: Dict[int, List[int]] = {}
        for a_ in spec.atoms:
            srcs: List[int] = []
            if a_.logical is None and not a_.absent:
                q = a_.pos - 1
                while q >= 0 and spec.atoms[q].is_count \
                        and spec.atoms[q].min_count == 0 \
                        and spec.atoms[q].partner is None \
                        and not spec.atoms[q].absent:
                    srcs.append(q)
                    q -= 1
            skip_srcs[a_.pos] = srcs
        fork_tgt = st.pos + 1      # [P,K] forked continuation's position
        fork_cnt = torch.zeros_like(st.count)
        capture_here: Dict[str, Any] = {}
        skip_marks: Dict[str, Any] = {}

        def mark(d, key, m):
            d[key] = torch.logical_or(d.get(key, F), m)

        for a in spec.atoms:
            last = a.pos == S - 1
            sides = [(a, 0)] + ([(a.partner, 1)] if a.partner else [])
            for atom, side in sides:
                if atom.stream_id != stream_id:
                    continue
                filt = self._filters[atom.ckey]
                if filt is None:
                    cond = torch.ones((P, K), dtype=torch.bool,
                                      device=F.device)
                else:
                    # the atom under evaluation sees the INCOMING event under
                    # its own ref; other refs stay bound to captures
                    env_a = dict(env)
                    env_a[atom.ref] = tuple(
                        torch.broadcast_to(c[None, :], (P, K))
                        for c in ev_cols)
                    cond = torch.broadcast_to(filt.fn(env_a), (P, K))
                at_here = torch.logical_and(st.active, st.pos == a.pos)
                m_here = at_here & cond & ev_ok[None, :]
                m_skip = F
                if atom is a and skip_srcs.get(a.pos):
                    from_skip = F
                    for q2 in skip_srcs[a.pos]:
                        from_skip = torch.logical_or(from_skip, st.pos == q2)
                    from_skip = st.active & from_skip & (st.count == 0)
                    m_skip = from_skip & cond & ev_ok[None, :]
                m = torch.logical_or(m_here, m_skip)
                if atom is a and skip_srcs.get(a.pos):
                    mark(skip_marks, atom.ckey, m_skip)
                if atom.absent:
                    # absence violated -- unless the obligation was already
                    # satisfied (timed pair whose wait elapsed, bit 1<<side)
                    live = (st.lmask & (1 << side)) == 0
                    kill = kill | (m & live)
                    continue
                matched_any = torch.logical_or(matched_any, m)
                if a.logical is not None:
                    bit = 1 << side
                    have_other = (lmask_new & (3 ^ bit)) != 0
                    # only OR and INSTANT absent pairs advance on the
                    # presence side alone; AND-of-presences needs the other
                    # side's bit and TIMED absent pairs the satisfied-
                    # absence bit the deadline pass sets -- both ride
                    # have_other
                    pair_absent = a.partner is not None and a.partner.absent
                    instant_pair = pair_absent and \
                        a.partner.waiting_time is None
                    adv = m if (a.logical == "OR" or instant_pair) \
                        else torch.logical_and(m, have_other)
                    lmask_new = torch.where(m, lmask_new | bit, lmask_new)
                    mark(capture, atom.ckey, m)
                    mark(capture_here, atom.ckey, m)
                    if last:
                        complete = torch.logical_or(complete, adv)
                        deactivate = torch.logical_or(deactivate, adv)
                    else:
                        advance_inplace = torch.logical_or(advance_inplace,
                                                           adv)
                elif not a.is_count:
                    mark(capture, atom.ckey, m)
                    mark(capture_here, atom.ckey, m_here)
                    if last:
                        # skip-completions emit but do NOT kill the slot
                        complete = torch.logical_or(complete, m)
                        deactivate = torch.logical_or(deactivate, m_here)
                    else:
                        advance_inplace = torch.logical_or(advance_inplace,
                                                           m_here)
                        # skip-advances FORK a continuation at the target
                        fork = torch.logical_or(fork, m_skip)
                        fork_tgt = torch.where(m_skip, a.pos + 1, fork_tgt)
                        fork_cnt = torch.where(m_skip, 0, fork_cnt)
                else:
                    newc = st.count + 1
                    maxc = spec.count_cap if a.max_count < 0 else a.max_count
                    can_stay = torch.logical_and(m_here, newc < maxc)
                    can_adv = torch.logical_and(m_here, newc >= a.min_count)
                    mark(capture, atom.ckey, m)
                    mark(capture_here, atom.ckey, m_here)
                    if last:
                        complete = torch.logical_or(complete, can_adv)
                        if a.min_count <= 1:
                            complete = torch.logical_or(complete, m_skip)
                        deactivate = torch.logical_or(
                            deactivate,
                            can_adv & torch.logical_not(can_stay))
                    else:
                        fk = torch.logical_and(can_adv, can_stay)
                        fork = torch.logical_or(fork, fk)
                        fork_tgt = torch.where(fk, a.pos + 1, fork_tgt)
                        ai = can_adv & torch.logical_not(can_stay)
                        advance_inplace = torch.logical_or(advance_inplace,
                                                           ai)
                    # skip-collect into a count atom: fork a collector at
                    # the target position that already HOLDS this event
                    fork = torch.logical_or(fork, m_skip)
                    fork_tgt = torch.where(m_skip, a.pos, fork_tgt)
                    fork_cnt = torch.where(m_skip, 1, fork_cnt)

        # SEQUENCE: strict continuity
        if spec.state_type == "SEQUENCE":
            no_match = st.active & ev_ok[None, :] & \
                torch.logical_not(matched_any)
            kill = torch.logical_or(kill, no_match)

        # ---- seed (virtual pending slot at position 0) ---------------------
        # an absent FIRST side (`not A and B` at position 0): A's arrival
        # disarms the virtual seed (non-every; `every` re-arms immediately,
        # so the arrival has no lasting effect there)
        if a0.partner is not None and a0.partner.absent and \
                a0.partner.stream_id == stream_id and not a0.every:
            patom = a0.partner
            pfilt = self._filters[patom.ckey]
            if pfilt is None:
                pc = torch.ones((K,), dtype=torch.bool, device=F.device)
            else:
                env_p = dict(env)
                env_p[patom.ref] = tuple(
                    torch.broadcast_to(cc[None, :], (P, K)) for cc in ev_cols)
                pc = _seed_eval(pfilt, env_p, K)
            disarm = st.seed_on & ev_ok & pc
            st = st._replace(seed_on=st.seed_on & torch.logical_not(disarm))
        seed_match = torch.zeros((K,), dtype=torch.bool, device=F.device)
        seed_side = torch.zeros((K,), dtype=torch.int32, device=F.device)
        for atom, side in [(a0, 0)] + ([(a0.partner, 1)] if a0.partner
                                       else []):
            if atom.stream_id != stream_id or a0.absent or atom.absent:
                continue
            filt = self._filters[atom.ckey]
            if filt is None:
                c = torch.ones((K,), dtype=torch.bool, device=F.device)
            else:
                env_s = dict(env)
                env_s[atom.ref] = tuple(
                    torch.broadcast_to(cc[None, :], (P, K)) for cc in ev_cols)
                c = _seed_eval(filt, env_s, K)
            sm = st.seed_on & ev_ok & c
            seed_side = torch.where(sm & torch.logical_not(seed_match), side,
                                    seed_side)
            seed_match = torch.logical_or(seed_match, sm)

        # a seed advances immediately iff the first atom completes with one
        # event: single non-count atom, count with min<=1, or logical OR
        if a0.logical is not None:
            seed_immediate = a0.logical == "OR" or (
                a0.partner is not None and a0.partner.absent)
        elif a0.is_count:
            seed_immediate = a0.min_count <= 1
        else:
            seed_immediate = True
        # ...and keeps a collecting continuation iff a count atom can take more
        seed_keeps = a0.is_count and (a0.max_count < 0 or a0.max_count > 1)

        seed_complete = seed_match & bool(seed_immediate and S == 1)
        # seed epsilon skip: when EVERY atom before the last is a plain
        # zero-min count, an event matching the last atom completes the
        # whole pattern from the virtual seed with all earlier captures null
        last_atom = spec.atoms[S - 1]
        seed_skip_possible = (
            S > 1 and len(skip_srcs.get(S - 1, ())) == S - 1 and
            last_atom.logical is None and not last_atom.absent and
            (not last_atom.is_count or last_atom.min_count <= 1))
        if seed_skip_possible and last_atom.stream_id == stream_id:
            lfilt = self._filters[last_atom.ckey]
            if lfilt is None:
                lc = torch.ones((K,), dtype=torch.bool, device=F.device)
            else:
                env_l = dict(env)
                env_l[last_atom.ref] = tuple(
                    torch.broadcast_to(cc[None, :], (P, K)) for cc in ev_cols)
                # the zero-occurrence interpretation carries NO captures
                for aa in spec.all_atoms():
                    if aa.absent or aa is last_atom:
                        continue
                    a_sch = self.schemas[aa.stream_id]
                    nulls = tuple(
                        torch.full((P, K), ev.null_value(t), dtype=d,
                                   device=F.device)
                        for t, d in zip(a_sch.types, a_sch.dtypes))
                    env_l[aa.ref] = nulls
                    for di in range(aa.capture_depth):
                        env_l[f"{aa.ref}@{di}"] = nulls
                    env_l[f"{aa.ref}@-1"] = nulls
                lc = _seed_eval(lfilt, env_l, K)
            seed_skip_hit = st.seed_on & ev_ok & lc
            seed_complete = torch.logical_or(seed_complete, seed_skip_hit)
        seed_spawn = seed_match & bool(
            (seed_immediate and S > 1) or not seed_immediate or seed_keeps)
        if seed_immediate and not seed_keeps:
            seed_pos, seed_count = 1, 0
        else:
            seed_pos, seed_count = 0, 1
        seed_fork_also = seed_immediate and seed_keeps and S > 1

        if not a0.every:
            st = st._replace(seed_on=st.seed_on &
                             torch.logical_not(seed_match))
            newly_done = torch.logical_or(torch.any(complete, dim=0),
                                          seed_complete)
            st = st._replace(done=torch.logical_or(st.done, newly_done))

        st = st._replace(lmask=lmask_new)

        # ---- phase 4: in-place capture -------------------------------------
        newcaps = {}
        for a in spec.all_atoms():
            if a.absent:
                continue
            ck = a.ckey
            ts_c, cols_c = st.caps[ck]
            here = capture.get(ck)
            if here is None:
                newcaps[ck] = (ts_c, cols_c)
                continue
            D = ts_c.shape[1]
            idx = torch.clamp(st.count, 0, D - 1)
            ncols = tuple(
                _set_along(c, idx, torch.broadcast_to(
                    ev_cols[j][None, :], idx.shape), here)
                for j, c in enumerate(cols_c))
            nts = _set_along(ts_c, idx, torch.broadcast_to(
                ev_ts[None, :], idx.shape), here)
            newcaps[ck] = (nts, ncols)
        st = st._replace(caps=newcaps)

        # ---- phase 5: emission gather ([P+1, K]: slot axis + seed row) -----
        emit_mask = torch.cat([complete, seed_complete[None, :]], dim=0)
        emit_ts = torch.cat([
            torch.where(absent_complete, absent_ts,
                        torch.broadcast_to(ev_ts[None, :], (P, K))),
            ev_ts[None, :]], dim=0)                       # [P+1,K]
        emit: Dict[str, Any] = {"mask": emit_mask, "ts": emit_ts}
        for a in spec.all_atoms():
            if a.absent:
                continue
            if self.emit_refs is not None and a.ref not in self.emit_refs:
                continue
            ck = a.ckey
            ts_c, cols_c = st.caps[ck]
            D = ts_c.shape[1]
            # the seed emission row's captured atom: position 0 for a
            # single-atom pattern; the LAST atom for an epsilon-skip
            # completion (every earlier capture emits null)
            if S == 1:
                is_seed_cap = (a.pos == 0 and a.stream_id == stream_id)
            else:
                is_seed_cap = (seed_skip_possible and a.pos == S - 1 and
                               a.stream_id == stream_id)
            a_schema2 = self.schemas[a.stream_id]
            seed_cols = tuple(
                torch.broadcast_to(ev_cols[j][None, None, :], (1, D, K))
                if is_seed_cap else
                torch.full((1, D, K), ev.null_value(t), dtype=c.dtype,
                           device=F.device)
                for j, (c, t) in enumerate(zip(cols_c, a_schema2.types)))
            seed_ts = torch.broadcast_to(ev_ts[None, None, :], (1, D, K)) \
                if is_seed_cap else torch.full((1, D, K), -1,
                                               dtype=torch.int64,
                                               device=F.device)
            emit[ck] = (torch.cat([ts_c, seed_ts], dim=0),
                        tuple(torch.cat([c, sc], dim=0)
                              for c, sc in zip(cols_c, seed_cols)))

        # ---- phase 6: spawn forks + seed -----------------------------------
        st = self._spawn(st, fork, fork_tgt, fork_cnt, seed_spawn,
                         seed_pos, seed_count, seed_side, seed_fork_also,
                         stream_id, ev_cols, ev_ts, a0)

        # surviving zero-collect origins revert skip-written captures to
        # null AFTER emission and fork inheritance consumed them
        if skip_marks:
            newcaps2 = dict(st.caps)
            for a in spec.all_atoms():
                msk = skip_marks.get(a.ckey)
                if msk is None or a.absent:
                    continue
                ts_c, cols_c = st.caps[a.ckey]
                D2 = ts_c.shape[1]
                idx2 = torch.clamp(st.count, 0, D2 - 1)
                a_sch = self.schemas[a.stream_id]
                nts2 = _set_along(ts_c, idx2, torch.full(
                    idx2.shape, -1, dtype=torch.int64, device=F.device), msk)
                ncols2 = tuple(
                    _set_along(c, idx2, torch.full(
                        idx2.shape, ev.null_value(t), dtype=c.dtype,
                        device=F.device), msk)
                    for c, t in zip(cols_c, a_sch.types))
                newcaps2[a.ckey] = (nts2, ncols2)
            st = st._replace(caps=newcaps2)

        # ---- phase 7: in-place advance / kill / deactivate -----------------
        captured_now = capture_any(capture_here, F)
        st = st._replace(
            count=torch.where(advance_inplace | deactivate, 0,
                              torch.where(captured_now, st.count + 1,
                                          st.count)).to(torch.int32),
            pos=torch.where(advance_inplace, st.pos + 1,
                            st.pos).to(torch.int32),
            lmask=torch.where(advance_inplace, 0, st.lmask).to(torch.int32),
            entry_ts=torch.where(advance_inplace, ev_ts[None, :],
                                 st.entry_ts),
            active=st.active & torch.logical_not(kill | deactivate),
        )
        return st, emit

    # -- spawn ----------------------------------------------------------------
    def _spawn(self, st: PatternState, fork, fork_tgt, fork_cnt, seed_spawn,
               seed_pos, seed_count, seed_side, seed_fork_also, stream_id,
               ev_cols, ev_ts, a0):
        """Allocate free slots for fork/seed candidates: slot j (if free) has
        free-rank r_j, and the candidate with allocation-rank r_j lands
        there (each destination slot pulls its candidate)."""
        P, K = st.active.shape
        dev = st.active.device
        spec = self.spec

        extra = 2 if seed_fork_also else 1
        NC = P + extra
        if seed_fork_also:
            cand_valid = torch.cat(
                [fork, seed_spawn[None, :], seed_spawn[None, :]], dim=0)
        else:
            cand_valid = torch.cat([fork, seed_spawn[None, :]], dim=0)

        i32 = torch.int32
        rank = torch.cumsum(cand_valid.to(i32), dim=0, dtype=i32) - 1
        free = torch.logical_not(st.active)
        free_rank = torch.cumsum(free.to(i32), dim=0, dtype=i32) - 1
        nfree = torch.sum(free.to(i32), dim=0, dtype=i32)
        ncand = torch.sum(cand_valid.to(i32), dim=0, dtype=i32)

        # destination slot j takes candidate c iff free[j] and
        # rank[c] == free_rank[j] (and candidate exists)
        hot = cand_valid[None, :, :] & \
            (rank[None, :, :] == free_rank[:, None, :]) & free[:, None, :]
        has_cand = torch.any(hot, dim=1)                              # [P,K]

        st = st._replace(dropped=st.dropped + torch.sum(
            torch.clamp(ncand - nfree, min=0).to(torch.int64)))

        def pull(cand_field, old_field):
            got = oh_take(cand_field[None, :, :], hot, 1)
            return torch.where(has_cand, got, old_field)

        def row(v, dtype):
            return torch.full((1, K), v, dtype=dtype, device=dev)

        if seed_fork_also:
            # first seed candidate: advancing slot (pos 1); second: collector
            cpos = torch.cat([fork_tgt, row(1, i32), row(0, i32)], dim=0)
            ccount = torch.cat([fork_cnt.to(i32), row(0, i32), row(1, i32)],
                               dim=0)
        else:
            cpos = torch.cat([fork_tgt, row(seed_pos, i32)], dim=0)
            ccount = torch.cat([fork_cnt.to(i32), row(seed_count, i32)],
                               dim=0)
        # lmask only matters while the seed STAYS at position 0 collecting
        # the other logical side
        if a0.logical is not None and seed_pos == 0:
            seed_lmask = torch.where(
                seed_spawn, torch.bitwise_left_shift(
                    torch.ones((K,), dtype=i32, device=dev), seed_side),
                0)[None, :]
        else:
            seed_lmask = row(0, i32)
        clmask = torch.cat([torch.zeros((P, K), dtype=i32, device=dev)] +
                           [seed_lmask] * extra, dim=0)
        cstart = torch.cat([st.start_ts] + [ev_ts[None, :]] * extra, dim=0)
        centry = torch.broadcast_to(ev_ts[None, :], (NC, K))

        st = st._replace(
            active=torch.logical_or(st.active, has_cand),
            pos=pull(cpos, st.pos),
            count=pull(ccount, st.count),
            lmask=pull(clmask, st.lmask),
            start_ts=pull(cstart, st.start_ts),
            entry_ts=pull(centry, st.entry_ts),
        )

        # captures: forks inherit the source slot (post-capture state, which
        # already includes this event); seeds get the incoming event at atom0
        newcaps = {}
        seed_taken = torch.any(hot[:, P:, :], dim=1)                 # [P,K]
        fork_hot = hot[:, :P, :]                                     # [P,P,K]
        fork_taken = has_cand & torch.logical_not(seed_taken)
        # each fork's source slot, for a gather: the reference's one-hot
        # sum gives the source's value with -0.0 as +0.0 (reproduced
        # below) and, on the CPU, a NaN's bits unchanged; a sum on the card
        # would rewrite a NaN's bits, a gather keeps them on every device
        fork_src = torch.argmax(fork_hot.to(torch.int32), dim=1)    # [P,K]
        for a in spec.all_atoms():
            if a.absent:
                continue
            ck = a.ckey
            ts_c, cols_c = st.caps[ck]
            D = ts_c.shape[1]
            seed_has = (a.pos == 0 and a.stream_id == stream_id)
            first_d = (torch.arange(D, device=dev) == 0)[None, :, None]
            seed_m = torch.broadcast_to(seed_taken[:, None, :], (P, D, K))

            def merge(c, incoming, nullv):
                inherited = torch.gather(c, 0, fork_src[:, None, :].expand(
                    P, D, K))                                        # [P,D,K]
                if c.dtype.is_floating_point:
                    inherited = torch.where(inherited == 0, 0.0, inherited)
                out = torch.where(fork_taken[:, None, :], inherited, c)
                clear = torch.full_like(out, nullv)
                if seed_has:
                    iv = torch.broadcast_to(incoming[None, None, :],
                                            (P, D, K)).to(c.dtype)
                    out = torch.where(seed_m & first_d, iv,
                                      torch.where(seed_m, clear, out))
                else:
                    out = torch.where(seed_m, clear, out)
                return out

            # the incoming event's columns are read only for an atom that
            # seeds from this stream: another stream may be narrower (the
            # reference indexes them for every atom and raises there)
            a_schema = self.schemas[a.stream_id]
            newcaps[ck] = (merge(ts_c, ev_ts, -1),
                           tuple(merge(c, ev_cols[j] if seed_has else None,
                                       ev.null_value(t))
                                 for j, (c, t) in enumerate(
                                     zip(cols_c, a_schema.types))))
        return st._replace(caps=newcaps)

    # -- env ------------------------------------------------------------------
    def _build_env(self, st: PatternState, ev_ts, in_tabs=None):
        # `x in Table` probes broadcast over the operand's shape ([P, K]
        # here), as the reference's do
        env: Dict[str, Any] = {"__ts__": ev_ts[None, :],
                               **probe_env(in_tabs or {})}
        for a in self.spec.all_atoms():
            if a.absent:
                continue
            ts_c, cols_c = st.caps[a.ckey]       # [P,D,K]
            D = ts_c.shape[1]
            env[a.ref] = tuple(c[:, 0, :] for c in cols_c)
            for i in range(D):
                env[f"{a.ref}@{i}"] = tuple(c[:, i, :] for c in cols_c)
            # e1[last]: the deepest FILLED capture row (the ts plane holds
            # -1 where unfilled)
            env[f"{a.ref}@-1"] = tuple(oh_take(c, last_filled(ts_c, 1), 1)
                                       for c in cols_c)
        return env


def last_filled(ts_c, axis: int):
    """One-hot of the deepest filled capture row along `axis` of a capture
    ts plane (-1 marks unfilled rows)."""
    D = ts_c.shape[axis]
    nfill = torch.sum((ts_c >= 0).to(torch.int32), dim=axis, dtype=torch.int32)
    last_i = torch.clamp(nfill - 1, 0, D - 1)
    shape = [1] * ts_c.dim()
    shape[axis] = D
    return torch.arange(D, device=ts_c.device).reshape(shape) == \
        last_i.unsqueeze(axis)


def oh_take(c, oh, axis):
    """Gather along a tiny axis as a one-hot contraction (select + reduce)."""
    if c.dtype == torch.bool:
        return torch.any(oh & c, dim=axis)
    return torch.sum(torch.where(oh, c, torch.zeros((), dtype=c.dtype,
                                                    device=c.device)),
                     dim=axis, dtype=c.dtype)


def capture_any(capture: Dict[str, Any], F):
    out = F
    for m in capture.values():
        out = torch.logical_or(out, m)
    return out


def _seed_eval(filt: CompiledExpr, env, K):
    v = filt.fn(env)
    if v.dim() == 0:
        v = torch.broadcast_to(v, (K,))
    if v.dim() == 2:     # [P,K] -> slot row 0
        return v[0, :]
    return v


def _set_along(arr, idx, vals, mask):
    """arr[p, idx[p,k], k] = vals[p,k] where mask[p,k]; arr is [P,D,K]."""
    hit = (torch.arange(arr.shape[1], device=arr.device)[None, :, None] ==
           idx[:, None, :]) & mask[:, None, :]
    return torch.where(hit, vals[:, None, :].to(arr.dtype), arr)
