"""Wrapper, build and plain version of the `pattern_step` CUDA kernel.

The kernel (`siddhi_tpu_torch/csrc/pattern_step.cu`) replaces the JAX
package's jitted pattern step (`siddhi_tpu/core/pattern_planner.py`
`make_step` with `wire_ts`, `PatternExec.tick` / `_spawn` in
`siddhi_tpu/core/pattern.py`, and `_emit_matches`' compaction), and, for
plans with absent atoms, its timer step (`tstep`) and the wake of
`_emit_matches`.

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
launches and `plain_calls` calls of the plain versions; `reset_counts()`
sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import torch

from ..core import event as ev
from ..core.window import NO_WAKEUP, Rows
from . import _nvcc
from .in_probe import MAX_IN, InSet, fill_sets
from .filter_bytecode import InKeys, compile_filter, type_code

launches = 0
timer_launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, timer_launches, plain_calls
    launches = 0
    timer_launches = 0
    plain_calls = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def library_path() -> str:
    return _nvcc.library_path("pattern_step")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("pattern_step")
    if not getattr(lib, "_siddhi_checked", False):
        lib.siddhi_pattern_step.restype = ctypes.c_int
        lib.siddhi_pattern_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.siddhi_pattern_step_plan_size.restype = ctypes.c_int
        lib.siddhi_pattern_step_plan_size.argtypes = []
        size = lib.siddhi_pattern_step_plan_size()
        if size != ctypes.sizeof(StepPlan):
            raise RuntimeError(
                f"StepPlan layout mismatch: kernel {size} bytes, wrapper "
                f"{ctypes.sizeof(StepPlan)} bytes")
        lib._siddhi_checked = True
    return lib


def ptxas_report() -> str:
    """What `nvcc -Xptxas -v` said about the built kernel (registers,
    local memory, spill bytes)."""
    return _nvcc.ptxas_report("pattern_step")


# ---------------------------------------------------------------------------
# the kernel's plan (mirrors `struct StepPlan` in csrc/pattern_step.cu)
# ---------------------------------------------------------------------------

MAX_ATOMS, MAX_COLS, MAX_EMIT, MAX_CODE, MAX_P = 8, 8, 24, 192, 32
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


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
         ("emit_col", _I * MAX_EMIT),
         ("b32", _P), ("b64", _P), ("dropped", _P),
         ("ev_col", _P * MAX_COLS), ("raw_ts", _P), ("ts_delta", _P),
         ("sel_idx", _P), ("key_idx", _P), ("out_ts", _P),
         ("out_kind", _P), ("out_valid", _P), ("out_col", _P * MAX_EMIT),
         ("header", _P), ("in_sets", InSet * MAX_IN)])


def _null_bits(attr_type: str) -> int:
    """A column's in-band null as the kernel's 64-bit slot."""
    v = ev.null_value(attr_type)
    if isinstance(v, float):
        return int(torch.tensor(v, dtype=torch.float32).view(torch.int32))
    return int(v)


class KernelPlan:
    """The static part of a kernel launch for one (pattern query, input
    stream): the state layout, the filters' bytecode and the emitted
    capture columns.  Built at plan time."""

    def __init__(self, pexec, sel, packer, stream_id: str,
                 compact_rows: int):
        spec = pexec.spec
        atoms = spec.atoms
        S, P = len(atoms), pexec.P
        if S > MAX_ATOMS or P > MAX_P:
            raise NotImplementedError(
                f"pattern_step kernel takes at most {MAX_ATOMS} atoms and "
                f"{MAX_P} slots (got {S} and {P})")
        schemas = pexec.schemas
        self.schema = schemas[stream_id]
        self.P, self.compact_rows = P, compact_rows
        t = StepPlan()
        t.P, t.S = P, S
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
        self.has_absent = bool(t.absent_mask)
        if len(self.schema.types) > MAX_COLS:
            raise NotImplementedError(
                f"pattern_step kernel takes at most {MAX_COLS} columns")
        t.ev_ncols = len(self.schema.types)
        for c, at in enumerate(self.schema.types):
            t.ev_ty[c] = type_code(at)

        # state layout from the packer's leaf rows (reference pytree order)
        rows = packer.recs
        names = ["active", "pos", "count", "lmask", "start", "entry",
                 "seed_on", "done"]
        for name, rec in zip(names, rows[:8]):
            setattr(t, f"off_{name}", rec[3])
        atom_of_ref = {a.ref: a.pos for a in atoms}
        i = 9                                   # past the `dropped` scalar
        for ck in sorted(a.ckey for a in atoms if not a.absent):
            a = next(x for x in atoms if x.ckey == ck)
            sch = schemas[a.stream_id]
            if len(sch.types) > MAX_COLS:
                raise NotImplementedError(
                    f"pattern_step kernel takes at most {MAX_COLS} columns")
            t.cap_ts[a.pos] = rows[i][3]
            t.n_cols[a.pos] = len(sch.types)
            for c, at in enumerate(sch.types):
                t.cap_off[a.pos][c] = rows[i + 1 + c][3]
                t.cap_ty[a.pos][c] = type_code(at)
                t.cap_null[a.pos][c] = _null_bits(at)
            i += 1 + len(sch.types)

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
        if len(code) > MAX_CODE:
            raise NotImplementedError(
                f"pattern filters need {len(code)} bytecode words; the "
                f"kernel takes {MAX_CODE}")
        for j, w in enumerate(code):
            t.code[j] = w
        self.in_keys = ik.keys

        # emitted capture columns: those the projection reads
        self.emit = sorted((atom_of_ref[ref], pos)
                           for ref, pos in sel.used_columns())
        if len(self.emit) > MAX_EMIT:
            raise NotImplementedError(
                f"the selector reads {len(self.emit)} captured columns; the "
                f"kernel emits at most {MAX_EMIT}")
        t.n_emit = len(self.emit)
        for j, (a, c) in enumerate(self.emit):
            t.emit_atom[j], t.emit_col[j] = a, c
        self.atoms = atoms
        self.sel = sel
        self.template = t


def _check(x: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if x.device != dev or x.dtype != dtype or x.dim() != dim or \
            not x.is_contiguous():
        raise ValueError(
            f"pattern_step: {name} must be a contiguous {dim}-d {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device})")


def launch(kp: KernelPlan, packed, raw_cols, raw_ts, ts_wire, sel_idx,
           key_ref, now: int, dense: bool, timer: bool = False,
           in_tabs=None):
    """Launch the kernel on the current stream.  Returns the updated packed
    state (same blobs) and the kernel's outputs before projection:
    (header i64[3] = [n_valid, n_dropped, wake], ts, kind, valid,
    {(atom, col): column}).  In timer mode (`timer`) the launch ticks every
    key of the slab once with no event at ts = `now`; the event arguments
    are then None."""
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
    compact = R < EP
    nrows = (R if compact else EP) * Kb

    pl = StepPlan.from_buffer_copy(kp.template)
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
    for j, (a, c) in enumerate(kp.emit):
        sch = kp.sel.scope.schema(kp.atoms[a].ref)
        col = torch.empty(nrows, dtype=sch.dtypes[c], device=dev)
        out_cols[(a, c)] = col
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
    _nvcc.check_launch(lib.siddhi_pattern_step(ctypes.byref(pl), stream),
                       "pattern_step")
    if timer:
        timer_launches += 1
    else:
        launches += 1
    del converted, held
    return (b32, b64, scalars), (header, out_ts, out_kind, out_valid,
                                 out_cols)


def project(kp: KernelPlan, sel_state, kout, now: int):
    """The selector's projection over the kernel's compacted rows; rows
    that hold no match come out zero, as the reference's compaction
    leaves them."""
    header, out_ts, out_kind, out_valid, out_cols = kout
    env: Dict[str, Any] = {"__ts__": out_ts, "__now__": now}
    for a in kp.atoms:
        if a.absent:
            continue
        n = len(kp.sel.scope.schema(a.ref).types)
        cols = tuple(out_cols.get((a.pos, c)) for c in range(n))
        env[a.ref] = env[f"{a.ref}@0"] = env[f"{a.ref}@-1"] = cols
    rows = Rows(ts=out_ts, kind=out_kind, valid=out_valid, seq=None,
                gslot=None, cols=())
    sel_state, (ots, okind, ovalid, ocols) = kp.sel.process(
        sel_state, rows, env)
    ocols = tuple(torch.where(ovalid, c, torch.zeros((), dtype=c.dtype,
                                                     device=c.device))
                  for c in ocols)
    return sel_state, (header[0], header[1], ots, okind, ovalid, ocols)


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
        packed, kout = launch(self.kernel_plan, packed, raw_cols, raw_ts,
                              ts_wire, sel_idx, key_ref, now, self.dense,
                              in_tabs=in_tabs)
        sel_state, out = project(self.kernel_plan, sel_state, kout, now)
        return packed, sel_state, out, wake_of(self.kernel_plan, kout)


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
        sel_state, out = project(self.kernel_plan, sel_state, kout, now)
        return packed, sel_state, out, kout[0][2]
