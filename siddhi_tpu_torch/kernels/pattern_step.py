"""Wrapper, build and plain version of the `pattern_step` CUDA kernel.

The kernel (`siddhi_tpu_torch/csrc/pattern_step.cu`) replaces the JAX
package's jitted pattern step (`siddhi_tpu/core/pattern_planner.py`
`make_step` with `wire_ts`, `PatternExec.tick` / `_spawn` in
`siddhi_tpu/core/pattern.py`, and `_emit_matches`' compaction), and, for
plans with absent atoms, its timer step (`tstep`) and the wake of
`_emit_matches`.  The source holds two kernels: the flagship mode
(`StepPlan`: stream atoms, `every`, `->`, `within`, capture depth 1,
absent atoms after the first) and the general mode (`GenPlan`: every other
pattern the planner accepts: count atoms, logical pairs, sequences, a
leading absent atom, timed logical-absent pairs).  `KernelPlan` picks the
mode (`flagship_subset`).

Where the select aggregates, has `having` or orders, the kernel writes
every (event, slot) row uncompacted, and the selector runs over the whole
[E * (P + 1), Kb] grid before the per-key cut to R rows
(`core/pattern_planner.py` `cut_per_key`), as the reference orders them;
otherwise the kernel cuts to R rows itself and the projection runs on
those.

The general mode also has a stacked mode (`launch_stacked`,
`PatternStep.stacked`: B9's `_adapt_pattern`, `siddhi_tpu/core/
fusion.py:247`): one launch walks S stacked batches of a `@fuse` stack,
each key's state staying with its thread from batch to batch, each batch
with its own `now`, output block and header row; its plain version is S
sequential plain steps.

`PatternStep` is what the runtime calls for a data step, `TimerStep` for
a timer step (a launch in timer mode over the whole slab).  Given tensors
on the CPU it runs the plain PyTorch step (`make_step` or `tstep` in
`core/pattern_planner.py`, the kernel's reference); given CUDA tensors it
launches the kernel, and a plan without a kernel plan raises.  There is
no fallback from the kernel to the plain step.  The kernel updates the
state blobs IN PLACE (the JAX step donated them), so callers must not
keep the old blobs expecting the old values.

The kernel builds from the repository's source at first use
(`kernels/_nvcc.py`).

`launches` counts data-step kernel launches, `timer_launches` timer-mode
launches (either mode), `mode_launches` the general mode's data and timer
launches among them, `stacked_launches` the stacked mode's launches,
`plain_calls` and `stacked_plain_calls` calls of the plain versions;
`reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows
from . import _nvcc
from .in_probe import MAX_IN, InSet, fill_sets
from .filter_bytecode import InKeys, compile_filter, null_kind, type_code
from ..core.executor import CompileError

launches = 0
timer_launches = 0
plain_calls = 0
# the general mode's share of the launches: [data steps, timer steps]
mode_launches = [0, 0]
# stacked launches of the general mode (a fused stack of batches) and calls
# of their plain version
stacked_launches = 0
stacked_plain_calls = 0


def reset_counts() -> None:
    global launches, timer_launches, plain_calls, stacked_launches, \
        stacked_plain_calls
    launches = 0
    timer_launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0]
    stacked_launches = 0
    stacked_plain_calls = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def library_path() -> str:
    return _nvcc.library_path("pattern_step")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("pattern_step")
    if not getattr(lib, "_siddhi_checked", False):
        for entry, struct in (("siddhi_pattern_step", StepPlan),
                              ("siddhi_pattern_general", GenPlan)):
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            size_fn = getattr(lib, entry + "_plan_size")
            size_fn.restype = ctypes.c_int
            size_fn.argtypes = []
            if size_fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} layout mismatch: kernel "
                    f"{size_fn()} bytes, wrapper {ctypes.sizeof(struct)} "
                    f"bytes")
        lib._siddhi_checked = True
    return lib


def ptxas_report() -> str:
    """What `nvcc -Xptxas -v` said about the built kernel (registers,
    local memory, spill bytes)."""
    return _nvcc.ptxas_report("pattern_step")


# ---------------------------------------------------------------------------
# the kernels' plans (mirror `struct StepPlan` and `struct GenPlan` in
# csrc/pattern_step.cu)
# ---------------------------------------------------------------------------

MAX_ATOMS, MAX_COLS, MAX_EMIT, MAX_CODE, MAX_P = 8, 8, 24, 192, 32
# the general mode's limits: atoms, capture sets (atoms and their logical
# partners), bytecode words
G_SIDES, G_CODE = 16, 256
# batches one stacked launch of the general mode walks (a longer stack runs
# as several launches)
G_STACK = 16
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_C = ctypes.c_byte

# general-mode atom and side flags (csrc/pattern_step.cu)
A_COUNT, A_ABSENT, A_AND, A_OR, A_PABSENT, A_PTIMED = 1, 2, 4, 8, 16, 32
S_HERE, S_CAP, S_ABSENT, S_SEEDHAS, S_SEEDROW = 1, 2, 4, 8, 16


# the buffers, last in both structures
_BUFFERS = [("b32", _P), ("b64", _P), ("dropped", _P),
            ("ev_col", _P * MAX_COLS), ("raw_ts", _P), ("ts_delta", _P),
            ("sel_idx", _P), ("key_idx", _P), ("out_ts", _P),
            ("out_kind", _P), ("out_valid", _P), ("out_col", _P * MAX_EMIT),
            ("header", _P), ("in_sets", InSet * MAX_IN)]


class StepPlan(ctypes.Structure):
    _fields_ = (
        [(n, _I) for n in ("K", "Kb", "E", "B", "P", "S", "R", "compact",
                           "dense", "ts_wire", "has_within", "every",
                           "seed_cap_atom", "stream_atom_mask",
                           "absent_mask", "timer")] +
        [(n, _L) for n in ("within", "now", "ts_base", "key_lo")] +
        [("wait", _L * MAX_ATOMS)] +
        [(n, _I) for n in ("off_active", "off_pos", "off_count",
                           "off_lmask", "off_seed_on", "off_done",
                           "off_start", "off_entry")] +
        [("cap_ts", _I * MAX_ATOMS), ("n_cols", _I * MAX_ATOMS),
         ("cap_off", (_I * MAX_COLS) * MAX_ATOMS),
         ("cap_ty", (_I * MAX_COLS) * MAX_ATOMS),
         ("cap_null", (_L * MAX_COLS) * MAX_ATOMS),
         ("ev_ncols", _I), ("ev_ty", _I * MAX_COLS),
         ("code_start", _I * MAX_ATOMS), ("code_len", _I * MAX_ATOMS),
         ("code", _I * MAX_CODE),
         ("n_emit", _I), ("emit_atom", _I * MAX_EMIT),
         ("emit_col", _I * MAX_EMIT)] + _BUFFERS)


class GenPlan(ctypes.Structure):
    _fields_ = (
        [(n, _I) for n in ("K", "Kb", "E", "B", "P", "S", "R", "compact",
                           "dense", "ts_wire", "has_within", "timer",
                           "sequence", "every", "has_timers",
                           "seed_spawn", "seed_complete", "seed_pos",
                           "seed_count", "seed_fork_also", "seed_lmask",
                           "seed_skip", "seed_disarm", "last_side")] +
        [(n, _L) for n in ("within", "now", "ts_base", "key_lo")] +
        [(n, _I) for n in ("off_active", "off_pos", "off_count",
                           "off_lmask", "off_seed_on", "off_done",
                           "off_start", "off_entry")] +
        [(n, _I * MAX_ATOMS) for n in ("a_flags", "a_min", "a_max",
                                       "a_side", "a_pside", "skip_to")] +
        [("a_wait", _L * MAX_ATOMS), ("a_pwait", _L * MAX_ATOMS)] +
        [(n, _I * G_SIDES) for n in ("s_flags", "s_depth", "s_ts",
                                     "s_ncols", "s_code", "s_code_len")] +
        [("s_col", (_I * MAX_COLS) * G_SIDES),
         ("s_ty", (_C * MAX_COLS) * G_SIDES),
         ("s_nk", (_C * MAX_COLS) * G_SIDES),
         ("ev_ncols", _I), ("ev_ty", _I * MAX_COLS), ("code", _I * G_CODE),
         ("n_emit", _I), ("emit_side", _C * MAX_EMIT),
         ("emit_col", _C * MAX_EMIT), ("emit_depth", _C * MAX_EMIT)] +
        _BUFFERS +
        [("n_stack", _I), ("stack_pad", _I), ("in_stride", _L),
         ("sel_stride", _L), ("out_stride", _L), ("s_now", _L * G_STACK)])


def _null_bits(attr_type: str) -> int:
    """A column's in-band null as the kernel's 64-bit slot."""
    v = ev.null_value(attr_type)
    if isinstance(v, float):
        return int(torch.tensor(v, dtype=torch.float32).view(torch.int32))
    return int(v)


def flagship_subset(spec) -> bool:
    """Whether a plan runs the flagship mode: stream atoms, `every`, `->`,
    `within`, capture depth 1 and absent atoms after the first.  Every
    other plan runs the general mode."""
    return (spec.state_type == "PATTERN" and not spec.atoms[0].absent and
            all(a.partner is None and not a.is_count and
                a.capture_depth == 1 for a in spec.atoms))


def _limit(what: str, got: int, most: int) -> None:
    if got > most:
        raise NotImplementedError(
            f"pattern_step kernel takes at most {most} {what} (the plan "
            f"needs {got})")


def _selected_captures(sel):
    """(ref, column, depth) of every capture the select clause reads:
    depth 0 for `e1` and `e1[0]`, -1 for `e1[last]`."""
    from ..query_api.expression import Variable, walk
    exprs = list(sel._exprs)
    if sel.selector.having_expression is not None:
        exprs.append(sel.selector.having_expression)
    out = set()
    for e in exprs:
        for node in walk(e):
            if not isinstance(node, Variable):
                continue
            try:
                key, pos, _ = sel.scope.resolve(node)
            except CompileError:        # a select alias inside `having`
                continue
            if key is None:             # an aggregator's bound result
                continue
            d = node.stream_index or 0
            out.add((key, pos, d if d >= 0 else -1))
    return sorted(out)


class KernelPlan:
    """The static part of a kernel launch for one (pattern query, input
    stream): the mode, the state layout, the filters' bytecode and the
    emitted capture columns.  Built at plan time; a plan past a stated
    limit raises NotImplementedError naming it."""

    def __init__(self, pexec, sel, packer, stream_id: str,
                 compact_rows: int):
        spec = pexec.spec
        S, P = len(spec.atoms), pexec.P
        _limit("atoms", S, MAX_ATOMS)
        _limit("slots", P, MAX_P)
        self.schema = pexec.schemas[stream_id]
        _limit("columns a stream", len(self.schema.types), MAX_COLS)
        self.P, self.compact_rows = P, compact_rows
        self.sel = sel
        self.has_absent = spec.has_absent
        # the selector over the whole grid, then the cut (aggregators,
        # having, order by / limit read rows the cut would drop)
        self.full_grid = bool(sel.has_aggregation or sel.having is not None
                              or sel.ordered)
        self.general = not flagship_subset(spec)
        # env key -> (emitted column key or None per column) for the
        # projection; emit: the emitted keys in launch order, with dtypes
        self.env_cols: Dict[str, tuple] = {}
        self.emit: List[tuple] = []
        self.emit_dtypes: List[torch.dtype] = []
        if self.general:
            self.entry = "siddhi_pattern_general"
            self.template = self._general(pexec, sel, packer, stream_id)
        else:
            self.entry = "siddhi_pattern_step"
            self.template = self._flagship(pexec, sel, packer, stream_id)
        _limit("captured columns the select reads", len(self.emit),
               MAX_EMIT)
        self.template.n_emit = len(self.emit)

    def _layout(self, t, packer) -> None:
        # state layout from the packer's leaf rows (reference pytree order)
        names = ["active", "pos", "count", "lmask", "start", "entry",
                 "seed_on", "done"]
        for name, rec in zip(names, packer.recs[:8]):
            setattr(t, f"off_{name}", rec[3])
        t.ev_ncols = len(self.schema.types)
        for c, at in enumerate(self.schema.types):
            t.ev_ty[c] = type_code(at)

    def _caps_rows(self, pexec, packer) -> Dict[str, tuple]:
        """Each capture set's first blob rows: ckey -> (ts row, col rows)."""
        rows, out, i = packer.recs, {}, 9      # past the `dropped` scalar
        for ck, ncols in packer._caps_layout:
            out[ck] = (rows[i][3], [rows[i + 1 + c][3]
                                    for c in range(ncols)])
            i += 1 + ncols
        return out

    def _flagship(self, pexec, sel, packer, stream_id) -> StepPlan:
        spec = pexec.spec
        atoms = spec.atoms
        S = len(atoms)
        t = StepPlan()
        t.P, t.S = self.P, S
        t.has_within = int(spec.within is not None)
        t.within = int(spec.within or 0)
        t.every = int(atoms[0].every)
        t.seed_cap_atom = 0 if S == 1 and atoms[0].stream_id == stream_id \
            else -1
        t.stream_atom_mask = sum(1 << a.pos for a in atoms
                                 if a.stream_id == stream_id)
        t.absent_mask = sum(1 << a.pos for a in atoms if a.absent)
        for a in atoms:
            t.wait[a.pos] = int(a.waiting_time or 0)
        self._layout(t, packer)
        caps = self._caps_rows(pexec, packer)
        atom_of_ref = {a.ref: a.pos for a in atoms}
        for a in atoms:
            if a.absent:
                continue
            sch = pexec.schemas[a.stream_id]
            _limit("columns a stream", len(sch.types), MAX_COLS)
            ts_row, col_rows = caps[a.ckey]
            t.cap_ts[a.pos] = ts_row
            t.n_cols[a.pos] = len(sch.types)
            for c, at in enumerate(sch.types):
                t.cap_off[a.pos][c] = col_rows[c]
                t.cap_ty[a.pos][c] = type_code(at)
                t.cap_null[a.pos][c] = _null_bits(at)

        code: List[int] = []
        ik = InKeys(pexec.in_col0_types)
        for a in atoms:
            if a.filter_expr is None:
                continue
            words = compile_filter(a.filter_expr,
                                   pexec.filter_scopes[a.ckey], a.ref,
                                   atom_of_ref, in_keys=ik)
            t.code_start[a.pos] = len(code)
            t.code_len[a.pos] = len(words)
            code += words
        _limit("bytecode words", len(code), MAX_CODE)
        for j, w in enumerate(code):
            t.code[j] = w
        self.in_keys = ik.keys

        # emitted capture columns: those the select reads (every index of a
        # depth-1 capture reads its one row)
        for ref, c in sorted({(ref, c) for ref, c, _ in
                              _selected_captures(sel)}):
            a = atoms[atom_of_ref[ref]]
            j = len(self.emit)
            if j < MAX_EMIT:
                t.emit_atom[j], t.emit_col[j] = a.pos, c
            self.emit.append((a.pos, c))
            self.emit_dtypes.append(pexec.schemas[a.stream_id].dtypes[c])
        for a in atoms:
            if a.absent:
                continue
            n = len(pexec.schemas[a.stream_id].types)
            cols = tuple((a.pos, c) if (a.pos, c) in self.emit else None
                         for c in range(n))
            for k in (a.ref, f"{a.ref}@0", f"{a.ref}@-1"):
                self.env_cols[k] = cols
        return t

    def _general(self, pexec, sel, packer, stream_id) -> GenPlan:
        spec = pexec.spec
        atoms, sides = spec.atoms, list(spec.all_atoms())
        S = len(atoms)
        _limit("atoms and logical partners", len(sides), G_SIDES)
        side_of = {id(x): i for i, x in enumerate(sides)}
        t = GenPlan()
        t.P, t.S = self.P, S
        t.has_within = int(spec.within is not None)
        t.within = int(spec.within or 0)
        t.sequence = int(spec.state_type == "SEQUENCE")
        a0, last = atoms[0], atoms[-1]
        t.every = int(a0.every)
        t.has_timers = int(spec.has_absent)
        self._layout(t, packer)
        caps = self._caps_rows(pexec, packer)

        # skip sources (the reference tick's epsilon closure): atom b is
        # reachable from a slot parked at q when every atom in [q, b) is a
        # plain zero-minimum count
        skip_srcs = {}
        for a in atoms:
            srcs = []
            if a.logical is None and not a.absent:
                q = a.pos - 1
                while q >= 0 and atoms[q].is_count and \
                        atoms[q].min_count == 0 and \
                        atoms[q].partner is None and not atoms[q].absent:
                    srcs.append(q)
                    q -= 1
            skip_srcs[a.pos] = srcs
            for q in srcs:
                t.skip_to[q] |= 1 << a.pos
        for a in atoms:
            fl = (A_COUNT if a.is_count else 0) | \
                (A_ABSENT if a.absent else 0) | \
                {None: 0, "AND": A_AND, "OR": A_OR}[a.logical]
            p = a.partner
            if p is not None and p.absent:
                fl |= A_PABSENT
                if p.waiting_time is not None:
                    fl |= A_PTIMED
                    t.a_pwait[a.pos] = int(p.waiting_time)
            t.a_flags[a.pos] = fl
            t.a_min[a.pos] = a.min_count
            t.a_max[a.pos] = spec.count_cap if a.max_count < 0 \
                else a.max_count
            t.a_wait[a.pos] = int(a.waiting_time or 0) if a.absent else 0
            t.a_side[a.pos] = side_of[id(a)]
            t.a_pside[a.pos] = side_of[id(p)] if p is not None else -1

        # the seed (reference tick: seed_immediate / seed_keeps)
        if a0.logical is not None:
            immediate = a0.logical == "OR" or (
                a0.partner is not None and a0.partner.absent)
        elif a0.is_count:
            immediate = a0.min_count <= 1
        else:
            immediate = True
        keeps = a0.is_count and (a0.max_count < 0 or a0.max_count > 1)
        t.seed_complete = int(immediate and S == 1)
        t.seed_spawn = int((immediate and S > 1) or not immediate or keeps)
        t.seed_pos, t.seed_count = (1, 0) if immediate and not keeps \
            else (0, 1)
        t.seed_fork_also = int(immediate and keeps and S > 1)
        t.seed_lmask = int(a0.logical is not None and t.seed_pos == 0)
        skip_possible = (
            S > 1 and len(skip_srcs.get(S - 1, ())) == S - 1 and
            last.logical is None and not last.absent and
            (not last.is_count or last.min_count <= 1))
        t.seed_skip = int(skip_possible and last.stream_id == stream_id)
        t.seed_disarm = int(a0.partner is not None and a0.partner.absent
                            and a0.partner.stream_id == stream_id
                            and not a0.every)
        t.last_side = side_of[id(last)]

        # capture sets and filters, one per side
        depths = {i: x.capture_depth for i, x in enumerate(sides)}
        set_of_ref = {x.ref: i for i, x in enumerate(sides) if not x.absent}
        code: List[int] = []
        ik = InKeys(pexec.in_col0_types)
        for i, x in enumerate(sides):
            sch = pexec.schemas[x.stream_id]
            _limit("columns a stream", len(sch.types), MAX_COLS)
            here = x.stream_id == stream_id
            fl = S_HERE if here else 0
            if x.absent:
                fl |= S_ABSENT
            else:
                fl |= S_CAP
                if x.pos == 0 and here:
                    fl |= S_SEEDHAS
                if here and ((S == 1 and x.pos == 0) or
                             (S > 1 and skip_possible and x.pos == S - 1)):
                    fl |= S_SEEDROW
                ts_row, col_rows = caps[x.ckey]
                t.s_depth[i], t.s_ts[i] = x.capture_depth, ts_row
                t.s_ncols[i] = len(sch.types)
                for c, at in enumerate(sch.types):
                    t.s_col[i][c] = col_rows[c]
                    t.s_ty[i][c] = type_code(at)
                    t.s_nk[i][c] = null_kind(at)
            t.s_flags[i] = fl
            if x.filter_expr is not None:
                words = compile_filter(x.filter_expr,
                                       pexec.filter_scopes[x.ckey], x.ref,
                                       set_of_ref, in_keys=ik,
                                       depths=depths)
                t.s_code[i], t.s_code_len[i] = len(code), len(words)
                code += words
        _limit("bytecode words", len(code), G_CODE)
        for j, w in enumerate(code):
            t.code[j] = w
        self.in_keys = ik.keys

        # emitted capture columns: (set, column, depth or -1 for last)
        for ref, c, d in _selected_captures(sel):
            i = set_of_ref[ref]
            if d >= depths[i]:
                raise CompileError(
                    f"{ref}[{d}] is past the capture depth {depths[i]}")
            j = len(self.emit)
            if j < MAX_EMIT:
                t.emit_side[j], t.emit_col[j], t.emit_depth[j] = i, c, d
            self.emit.append((i, c, d))
            self.emit_dtypes.append(
                pexec.schemas[sides[i].stream_id].dtypes[c])
        for i, x in enumerate(sides):
            if x.absent:
                continue
            n = len(pexec.schemas[x.stream_id].types)
            for d in range(-1, x.capture_depth):
                cols = tuple((i, c, d) if (i, c, d) in self.emit else None
                             for c in range(n))
                self.env_cols[f"{x.ref}@{d}"] = cols
            self.env_cols[x.ref] = self.env_cols[f"{x.ref}@0"]
        return t


def _check(x: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if x.device != dev or x.dtype != dtype or x.dim() != dim or \
            not x.is_contiguous():
        raise ValueError(
            f"pattern_step: {name} must be a contiguous {dim}-d {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device})")


def launch(kp: KernelPlan, packed, raw_cols, raw_ts, ts_wire, sel_idx,
           key_ref, now: int, dense: bool, timer: bool = False,
           in_tabs=None):
    """Launch the plan's kernel on the current stream.  Returns the updated
    packed state (same blobs) and the kernel's outputs before projection:
    (header i64[3] = [n_valid, n_dropped, wake], ts, kind, valid,
    {emitted key: column}).  Rows are compacted to R per key unless the
    plan runs the selector over the whole grid (`kp.full_grid`).  In timer
    mode (`timer`) the launch ticks every key of the slab once with no
    event at ts = `now`; the event arguments are then None."""
    global launches, timer_launches
    b32, b64, scalars = packed
    dev = b32.device
    K = b32.shape[1]
    _check(b32, "b32", torch.int32, 2, dev)
    _check(b64, "b64", torch.int64, 2, dev)
    dropped = scalars[0]
    _check(dropped, "dropped", torch.int64, 0, dev)
    if b64.shape[1] != K:
        raise ValueError("pattern_step: b32 and b64 key axes differ")
    if timer:
        Kb, E = K, 1
    else:
        _check(sel_idx, "sel_idx", torch.int32, 2, dev)
        Kb, E = sel_idx.shape
    P = kp.P
    EP = E * (P + 1)
    R = min(kp.compact_rows, EP)
    compact = R < EP and not kp.full_grid
    nrows = (R if compact else EP) * Kb

    pl = type(kp.template).from_buffer_copy(kp.template)
    pl.K, pl.Kb, pl.E, pl.R, pl.compact, pl.dense = K, Kb, E, R, \
        int(compact), int(dense)
    pl.now = int(now)
    pl.timer = int(timer)
    # the bool -> int32 columns made here must live until the kernel is
    # queued: freed earlier, their blocks would be handed to the outputs
    # allocated below.  Once it is queued, the caching allocator's stream
    # ordering keeps a freed block from reuse until the kernel is done.
    converted = []
    if timer:
        pl.B = 0
    elif ts_wire is not None:
        base, delta = ts_wire
        _check(delta, "ts_delta", torch.int32, 1, dev)
        pl.B, pl.ts_wire, pl.ts_base = delta.shape[0], 1, int(base)
        pl.ts_delta = delta.data_ptr()
    else:
        _check(raw_ts, "raw_ts", torch.int64, 1, dev)
        pl.B, pl.ts_wire = raw_ts.shape[0], 0
        pl.raw_ts = raw_ts.data_ptr()
    if not timer and len(raw_cols) != len(kp.schema.types):
        raise ValueError("pattern_step: column count does not match the "
                         "stream schema")
    for c, (col, d) in enumerate(zip(raw_cols or (), kp.schema.dtypes)):
        if d == torch.bool:
            col = col.to(torch.int32)
            d = torch.int32
            converted.append(col)
        _check(col, f"column {c}", d, 1, dev)
        if col.shape[0] != pl.B:
            raise ValueError("pattern_step: column length differs from ts")
        pl.ev_col[c] = col.data_ptr()
    if timer:
        pl.dense, pl.key_lo = 1, 0
    elif dense:
        key_lo = int(key_ref)
        if key_lo < 0 or key_lo + Kb > K:
            raise ValueError(
                f"pattern_step: dense range [{key_lo}, {key_lo + Kb}) "
                f"exceeds key capacity {K}")
        pl.key_lo = key_lo
    else:
        _check(key_ref, "key_idx", torch.int32, 1, dev)
        if key_ref.shape[0] != Kb:
            raise ValueError("pattern_step: key_idx and sel_idx disagree")
        pl.key_idx = key_ref.data_ptr()

    out_ts = torch.empty(nrows, dtype=torch.int64, device=dev)
    out_kind = torch.empty(nrows, dtype=torch.int32, device=dev)
    out_valid = torch.empty(nrows, dtype=torch.bool, device=dev)
    # fills, not a host copy, so that a CUDA graph can capture the launch
    header = torch.full((3,), NO_WAKEUP, dtype=torch.int64, device=dev)
    header[:2] = 0
    out_cols = {}
    for j, (key, dt) in enumerate(zip(kp.emit, kp.emit_dtypes)):
        col = torch.empty(nrows, dtype=dt, device=dev)
        out_cols[key] = col
        pl.out_col[j] = col.data_ptr()
    pl.b32, pl.b64, pl.dropped = b32.data_ptr(), b64.data_ptr(), \
        dropped.data_ptr()
    if sel_idx is not None:
        pl.sel_idx = sel_idx.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    pl.header = header.data_ptr()

    held = fill_sets(pl.in_sets, kp.in_keys, in_tabs or {})
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.check_launch(getattr(lib, kp.entry)(ctypes.byref(pl), stream),
                       "pattern_step")
    if timer:
        timer_launches += 1
    else:
        launches += 1
    if kp.general:
        mode_launches[1 if timer else 0] += 1
    del converted, held
    return (b32, b64, scalars), (header, out_ts, out_kind, out_valid,
                                 out_cols)


def launch_stacked(kp: KernelPlan, packed, cols, ts, sel_idx, key_idx,
                   nows, in_tabs=None):
    """The general mode's stacked launch: one launch walks S batches of
    one stream in order (B9's fused pattern stack).  `cols` and `ts` are
    [S, B], `sel_idx` [S, Kb, E] and `key_idx` [Kb] (gather mode; the same
    keys for every batch), `nows` the batches' `now`.  Each batch gets its
    own output block and its own header row.  Returns the packed state and
    a list of S launch outputs as `launch` gives them."""
    global stacked_launches
    if not kp.general:
        raise ValueError("pattern_step: the stacked mode runs the general "
                         "mode's plan")
    b32, b64, scalars = packed
    dev = b32.device
    K = b32.shape[1]
    _check(b32, "b32", torch.int32, 2, dev)
    _check(b64, "b64", torch.int64, 2, dev)
    _check(ts, "ts", torch.int64, 2, dev)
    _check(sel_idx, "sel_idx", torch.int32, 3, dev)
    _check(key_idx, "key_idx", torch.int32, 1, dev)
    S, B = ts.shape
    _, Kb, E = sel_idx.shape
    if sel_idx.shape[0] != S or len(nows) != S or key_idx.shape[0] != Kb:
        raise ValueError("pattern_step: the stacked inputs disagree")
    if len(cols) != len(kp.schema.types):
        raise ValueError("pattern_step: column count does not match the "
                         "stream schema")
    P = kp.P
    EP = E * (P + 1)
    R = min(kp.compact_rows, EP)
    compact = R < EP and not kp.full_grid
    nrows = (R if compact else EP) * Kb
    ev_cols = []
    for c, (col, d) in enumerate(zip(cols, kp.schema.dtypes)):
        if d == torch.bool:
            col = col.to(torch.int32)
            d = torch.int32
        _check(col, f"column {c}", d, 2, dev)
        if tuple(col.shape) != (S, B):
            raise ValueError("pattern_step: column shape differs from ts")
        ev_cols.append(col)
    out_ts = torch.empty((S, nrows), dtype=torch.int64, device=dev)
    out_kind = torch.empty((S, nrows), dtype=torch.int32, device=dev)
    out_valid = torch.empty((S, nrows), dtype=torch.bool, device=dev)
    header = torch.full((S, 3), NO_WAKEUP, dtype=torch.int64, device=dev)
    header[:, :2] = 0
    out_cols = {key: torch.empty((S, nrows), dtype=dt, device=dev)
                for key, dt in zip(kp.emit, kp.emit_dtypes)}
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    held = []
    for lo in range(0, S, G_STACK):
        n = min(G_STACK, S - lo)
        pl = type(kp.template).from_buffer_copy(kp.template)
        pl.K, pl.Kb, pl.E, pl.R, pl.compact, pl.dense = K, Kb, E, R, \
            int(compact), 0
        pl.B, pl.ts_wire, pl.timer = B, 0, 0
        pl.now = int(nows[lo])
        pl.n_stack = n
        pl.in_stride, pl.sel_stride, pl.out_stride = B, Kb * E, nrows
        for j in range(n):
            pl.s_now[j] = int(nows[lo + j])
        for c, col in enumerate(ev_cols):
            pl.ev_col[c] = col[lo].data_ptr()
        pl.raw_ts = ts[lo].data_ptr()
        pl.sel_idx = sel_idx[lo].data_ptr()
        pl.key_idx = key_idx.data_ptr()
        pl.b32, pl.b64, pl.dropped = b32.data_ptr(), b64.data_ptr(), \
            scalars[0].data_ptr()
        pl.out_ts, pl.out_kind, pl.out_valid = out_ts[lo].data_ptr(), \
            out_kind[lo].data_ptr(), out_valid[lo].data_ptr()
        for j, key in enumerate(kp.emit):
            pl.out_col[j] = out_cols[key][lo].data_ptr()
        pl.header = header[lo].data_ptr()
        held.append(fill_sets(pl.in_sets, kp.in_keys, in_tabs or {}))
        _nvcc.check_launch(getattr(lib, kp.entry)(ctypes.byref(pl), stream),
                           "pattern_step (stacked)")
        stacked_launches += 1
    del ev_cols, held
    return packed, [(header[s], out_ts[s], out_kind[s], out_valid[s],
                     {k: v[s] for k, v in out_cols.items()})
                    for s in range(S)]


def project(kp: KernelPlan, sel_state, kout, now: int, Kb: int,
            gslot=None):
    """The selector over the kernel's rows.  Compacted rows: the
    projection, rows that hold no match zero, as the reference's
    compaction leaves them.  The whole grid (`kp.full_grid`, rows
    [E * (P + 1), Kb]): aggregators over every row with its key's group
    slot (`gslot` [Kb], None for slot 0), having, then the per-key cut to
    R rows."""
    from ..core.pattern_planner import cut_per_key
    header, out_ts, out_kind, out_valid, out_cols = kout
    env: Dict[str, Any] = {"__ts__": out_ts, "__now__": now}
    for k, cols in kp.env_cols.items():
        env[k] = tuple(None if x is None else out_cols[x] for x in cols)
    n = out_ts.shape[0]
    if not kp.full_grid:
        rows = Rows(ts=out_ts, kind=out_kind, valid=out_valid, seq=None,
                    gslot=None, cols=())
        sel_state, (ots, okind, ovalid, ocols) = kp.sel.process(
            sel_state, rows, env)
        ocols = tuple(torch.where(ovalid, c, torch.zeros(
            (), dtype=c.dtype, device=c.device)) for c in ocols)
        return sel_state, (header[0], header[1], ots, okind, ovalid, ocols)
    if gslot is None:
        slots = torch.zeros((n,), dtype=torch.int32, device=out_ts.device)
    else:
        slots = gslot.to(torch.int32).clamp(min=0).repeat(n // Kb)
    rows = Rows(ts=out_ts, kind=out_kind, valid=out_valid, seq=None,
                gslot=slots, cols=())
    sel_state, out = kp.sel.process(sel_state, rows, env)
    return sel_state, cut_per_key(out, n // Kb, Kb, kp.compact_rows)


def wake_of(kp: KernelPlan, kout):
    """The launch's wake (header[2]) where the plan has absent atoms."""
    return kout[0][2] if kp.has_absent else NO_WAKEUP


class PatternStep:
    """One step variant (dense or gather slot access, raw or ts-delta wire)
    of one pattern query for one input stream.

    Call signatures mirror the reference's steps:
      raw wire:  (packed, sel_state, raw_cols, raw_ts, sel_idx, key_ref, now)
      ts wire:   (packed, sel_state, raw_cols, ts_base, ts_delta, sel_idx,
                  key_ref, now)
    Returns (packed', sel_state', out, wake) with
    out = (n_valid, n_dropped, ts, kind, valid, cols)."""

    def __init__(self, body, kernel_plan: Optional[KernelPlan],
                 dense: bool, wire: bool):
        self.body = body
        self.kernel_plan = kernel_plan
        self.dense = dense
        self.wire = wire

    def __call__(self, packed, sel_state, raw_cols, *args, in_tabs=None):
        if packed[0].is_cuda:
            return self.kernel(packed, sel_state, raw_cols, *args,
                               in_tabs=in_tabs)
        return self.plain(packed, sel_state, raw_cols, *args,
                          in_tabs=in_tabs)

    def plain(self, packed, sel_state, raw_cols, *args, in_tabs=None):
        """The plain PyTorch step (the kernel's reference)."""
        global plain_calls
        plain_calls += 1
        return self.body(packed, sel_state, raw_cols, *args,
                         in_tabs=in_tabs)

    def kernel(self, packed, sel_state, raw_cols, *args, in_tabs=None):
        if self.kernel_plan is None:
            raise NotImplementedError(
                "this pattern plan has no CUDA kernel plan (planned for "
                "another device)")
        if self.wire:
            ts_base, ts_delta, sel_idx, key_ref, now = args
            ts_wire, raw_ts = (ts_base, ts_delta), None
        else:
            raw_ts, sel_idx, key_ref, now = args
            ts_wire = None
        kp = self.kernel_plan
        packed, kout = launch(kp, packed, raw_cols, raw_ts, ts_wire, sel_idx,
                              key_ref, now, self.dense, in_tabs=in_tabs)
        Kb = sel_idx.shape[0]
        gslot = None
        if kp.full_grid:
            # the rows' group slots: each row's key, as the plain step's
            gslot = key_ref if not self.dense else int(key_ref) + \
                torch.arange(Kb, dtype=torch.int32, device=sel_idx.device)
        sel_state, out = project(kp, sel_state, kout, now, Kb, gslot)
        return packed, sel_state, out, wake_of(self.kernel_plan, kout)


    def stacked(self, packed, sel_state, cols, ts, sel_idx, key_idx, nows,
                in_tabs=None):
        """S batches of this stream in order (a fused stack): `cols` and
        `ts` [S, B], `sel_idx` [S, Kb, E], `key_idx` [Kb] (gather mode),
        `nows` the batches' `now`.  Returns (packed', sel_state', [out] *
        S, [wake] * S).  Given CUDA tensors it makes one stacked launch of
        the general mode and projects each batch's rows in order; given
        CPU tensors it runs S sequential plain steps (its reference)."""
        global stacked_plain_calls
        if self.dense or self.wire:
            raise ValueError("pattern_step: a stack runs the gather step "
                             "on raw timestamps")
        outs, wakes = [], []
        if not packed[0].is_cuda:
            stacked_plain_calls += 1
            for s in range(len(nows)):
                packed, sel_state, out, wake = self.plain(
                    packed, sel_state, tuple(c[s] for c in cols), ts[s],
                    sel_idx[s], key_idx, nows[s], in_tabs=in_tabs)
                outs.append(out)
                wakes.append(wake)
            return packed, sel_state, outs, wakes
        kp = self.kernel_plan
        if kp is None:
            raise NotImplementedError(
                "this pattern plan has no CUDA kernel plan (planned for "
                "another device)")
        packed, kouts = launch_stacked(kp, packed, cols, ts, sel_idx,
                                       key_idx, nows, in_tabs)
        Kb = key_idx.shape[0]
        for kout, now in zip(kouts, nows):
            sel_state, out = project(kp, sel_state, kout, now, Kb,
                                     key_idx if kp.full_grid else None)
            outs.append(out)
            wakes.append(wake_of(kp, kout))
        return packed, sel_state, outs, wakes


class TimerStep:
    """The timer step of a pattern query with absent atoms:
    (packed, sel_state, now) -> (packed', sel_state', out, wake).  Given
    tensors on the CPU it runs the plain `tstep`; given CUDA tensors it
    launches the kernel in timer mode over the whole slab."""

    def __init__(self, body, kernel_plan: Optional[KernelPlan]):
        self.body = body
        self.kernel_plan = kernel_plan

    def __call__(self, packed, sel_state, now, in_tabs=None):
        if packed[0].is_cuda:
            return self.kernel(packed, sel_state, now, in_tabs)
        return self.plain(packed, sel_state, now, in_tabs)

    def plain(self, packed, sel_state, now, in_tabs=None):
        global plain_calls
        plain_calls += 1
        return self.body(packed, sel_state, now, in_tabs)

    def kernel(self, packed, sel_state, now, in_tabs=None):
        if self.kernel_plan is None:
            raise NotImplementedError(
                "this pattern plan has no CUDA kernel plan (planned for "
                "another device)")
        packed, kout = launch(self.kernel_plan, packed, None, None, None,
                              None, None, now, True, timer=True,
                              in_tabs=in_tabs)
        sel_state, out = project(self.kernel_plan, sel_state, kout, now,
                                 packed[0].shape[1])
        return packed, sel_state, out, kout[0][2]
