"""Wrapper, build and plain version of the `block_nfa` CUDA kernel (K8).

The kernel (`siddhi_tpu_torch/csrc/block_nfa.cu`) replaces the JAX
package's jitted block-NFA step for single-key (non-partitioned) patterns
and sequences (`siddhi_tpu/core/pattern_block.py` `make_block_step`).  Its
plain version is `make_block_step` in `core/pattern_block.py`.

`BlockStep` is what the runtime calls.  Given tensors on the CPU it runs
the plain step; given CUDA tensors it launches the kernel, and a plan
without a kernel plan raises.  The kernel writes the completed matches in
arrival order (event index, then thread); the selector's projection and the
valid-first cut to the emission cap run after it as torch ops, as they do
after the reference's sort.  The state blobs are updated in place.

The kernel runs the chunks of W = 128 events in order in one block of 512
threads (the carry between chunks is serial, and chunk boundaries are
part of the reference's semantics): 128 stager threads copy the next
chunk's events into shared memory by cp.async, convert them and evaluate
atom 0 on each while the rows run this chunk; each row (a slab slot or a
seed) runs its stages in its own thread, a SEQUENCE row's next valid
event comes from the valid mask's ballot words, and a PATTERN row still
scanning after 8 events is finished by a warp, 32 events a ballot.  One
SM works; its chain of filter evaluations and block barriers a chunk
bounds it, not the bytes.

The kernel builds from the repository's source at first use
(`kernels/_nvcc.py`).  `launches` counts kernel launches and `plain_calls`
calls of the plain version; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import torch

from ..core import event as ev
from ..core.pattern_block import CHUNK, cut_rows
from ..core.window import NO_WAKEUP, Rows
from . import _nvcc
from .in_probe import MAX_IN, InSet, fill_sets
from .filter_bytecode import InKeys, cap_loads, compile_filter, type_code

launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


MAX_ATOMS, MAX_COLS, MAX_EMIT, MAX_CODE, MAX_P = 8, 16, 32, 256, 32
SMEM_MAX = 232448 - 64       # the H100 block's shared memory less the static
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


class BlockNfaPlan(ctypes.Structure):
    """Mirrors `struct BlockPlan` in csrc/block_nfa.cu."""
    _fields_ = (
        [(n, _I) for n in ("E", "B", "P", "S", "W", "C", "T", "is_seq",
                           "every", "a0_here", "has_within", "ts_wire",
                           "stream_atom_mask", "ncap", "n_emit", "smem")] +
        [(n, _L) for n in ("within", "now", "ts_base")] +
        [(n, _I) for n in ("off_active", "off_pos", "off_count",
                           "off_lmask", "off_seed_on", "off_done",
                           "off_start", "off_entry")] +
        [("n_cols", _I * MAX_ATOMS), ("cap_base", _I * MAX_ATOMS),
         ("cap_off", (_I * MAX_COLS) * MAX_ATOMS),
         ("cap_ty", (_I * MAX_COLS) * MAX_ATOMS),
         ("seed_ev", _I * MAX_ATOMS),
         ("ev_ncols", _I), ("ev_ty", _I * MAX_COLS),
         ("code_start", _I * MAX_ATOMS), ("code_len", _I * MAX_ATOMS),
         ("code", _I * MAX_CODE),
         ("emit_atom", _I * MAX_EMIT), ("emit_col", _I * MAX_EMIT),
         ("b32", _P), ("b64", _P), ("dropped", _P),
         ("ev_col", _P * MAX_COLS), ("raw_ts", _P), ("ts_delta", _P),
         ("sel_idx", _P), ("out_ts", _P), ("out_valid", _P),
         ("out_col", _P * MAX_EMIT), ("header", _P),
         ("in_sets", InSet * MAX_IN)])


NT = 512                     # the kernel's block (csrc/block_nfa.cu NT)


def smem_bytes(P: int, W: int, ncols: int, ncap: int) -> int:
    """The kernel's dynamic shared memory (its layout in block_nfa.cu):
    the staged and the converted events, the rows' captures and fields."""
    T = P + W
    return 8 * (4 * ncols * W + 4 * W + ncap * T + 4 * T) + \
        4 * (6 * W + 5 * T + MAX_P + 2 * (NT // 32) + 8)


class BlockPlan:
    """The static part of a K8 launch for one (pattern query, input
    stream): state layout, filters' bytecode, emitted capture columns.
    Built at plan time; raises NotImplementedError outside the subset."""

    def __init__(self, pexec, sel, packer, stream_id: str,
                 compact_rows: int):
        spec = pexec.spec
        atoms = spec.atoms
        S, P = len(atoms), pexec.P
        if S > MAX_ATOMS or P > MAX_P:
            raise NotImplementedError(
                f"block_nfa kernel takes at most {MAX_ATOMS} atoms and "
                f"{MAX_P} slots (got {S} and {P})")
        schemas = pexec.schemas
        self.schema = schemas[stream_id]
        if len(self.schema.types) > MAX_COLS:
            raise NotImplementedError(
                f"block_nfa kernel takes at most {MAX_COLS} columns")
        self.P, self.compact_rows = P, compact_rows
        a0 = atoms[0]
        t = BlockNfaPlan()
        t.P, t.S = P, S
        t.is_seq = int(spec.state_type == "SEQUENCE")
        t.every = int(a0.every)
        t.a0_here = int(a0.stream_id == stream_id)
        t.has_within = int(spec.within is not None)
        t.within = int(spec.within or 0)
        t.stream_atom_mask = sum(1 << a.pos for a in atoms
                                 if a.stream_id == stream_id)
        t.ev_ncols = len(self.schema.types)
        for c, at in enumerate(self.schema.types):
            t.ev_ty[c] = type_code(at)

        rows = packer.recs
        names = ["active", "pos", "count", "lmask", "start", "entry",
                 "seed_on", "done"]
        for name, rec in zip(names, rows[:8]):
            setattr(t, f"off_{name}", rec[3])
        i = 9                                   # past the `dropped` scalar
        ncap = 0
        for ck in sorted(a.ckey for a in atoms):
            a = next(x for x in atoms if x.ckey == ck)
            sch = schemas[a.stream_id]
            if len(sch.types) > MAX_COLS:
                raise NotImplementedError(
                    f"block_nfa kernel takes at most {MAX_COLS} columns")
            t.n_cols[a.pos] = len(sch.types)
            t.cap_base[a.pos] = ncap
            ncap += len(sch.types)
            for c, at in enumerate(sch.types):
                t.cap_off[a.pos][c] = rows[i + 1 + c][3]
                t.cap_ty[a.pos][c] = type_code(at)
            i += 1 + len(sch.types)
        t.ncap = ncap
        for a in atoms:
            t.seed_ev[a.pos] = int(a.ref == a0.ref and
                                   a0.stream_id == stream_id)

        atom_of_ref = {a.ref: a.pos for a in atoms}
        code: List[int] = []
        ik = InKeys(pexec.in_col0_types)
        for a in atoms:
            if a.filter_expr is None:
                continue
            words = compile_filter(a.filter_expr,
                                   pexec.filter_scopes[a.ckey], a.ref,
                                   atom_of_ref, in_keys=ik)
            if any(at == a.pos for at, _ in cap_loads(words)):
                # the block step binds an atom's own indexed ref to the
                # incoming event; the bytecode would read the capture
                raise NotImplementedError(
                    "block_nfa kernel: a filter that indexes its own "
                    "atom's capture (ROADMAP B6 kernel subset)")
            t.code_start[a.pos] = len(code)
            t.code_len[a.pos] = len(words)
            code += words
        if len(code) > MAX_CODE:
            raise NotImplementedError(
                f"pattern filters need {len(code)} bytecode words; the "
                f"block_nfa kernel takes {MAX_CODE}")
        for j, w in enumerate(code):
            t.code[j] = w
        self.in_keys = ik.keys

        # the captured columns the select and having read
        from .pattern_step import _selected_captures
        self.emit = sorted({(atom_of_ref[ref], pos)
                            for ref, pos, _ in _selected_captures(sel)})
        if len(self.emit) > MAX_EMIT:
            raise NotImplementedError(
                f"the selector reads {len(self.emit)} captured columns; "
                f"block_nfa emits at most {MAX_EMIT}")
        t.n_emit = len(self.emit)
        for j, (a, c) in enumerate(self.emit):
            t.emit_atom[j], t.emit_col[j] = a, c
        if smem_bytes(P, CHUNK, t.ev_ncols, ncap) > SMEM_MAX:
            raise NotImplementedError(
                "block_nfa kernel: the threads' captures do not fit in "
                "shared memory (ROADMAP B6 kernel subset)")
        self.atoms = atoms
        self.sel = sel
        self.template = t


def _check(x: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if x.device != dev or x.dtype != dtype or x.dim() != dim or \
            not x.is_contiguous():
        raise ValueError(
            f"block_nfa: {name} must be a contiguous {dim}-d {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device})")


def launch(kp: BlockPlan, packed, raw_cols, raw_ts, ts_wire, sel_idx,
           now: int, in_tabs=None):
    """Launch K8 on the current stream.  Returns the updated packed state
    (same blobs) and the kernel's outputs before projection: (header
    i64[1] = completions written, ts, valid, {(atom, col): column}), CT
    rows of which the first header[0] hold the completions in order."""
    global launches
    b32, b64, scalars = packed
    dev = b32.device
    _check(b32, "b32", torch.int32, 2, dev)
    _check(b64, "b64", torch.int64, 2, dev)
    if b32.shape[1] != 1 or b64.shape[1] != 1:
        raise ValueError("block_nfa: the block NFA runs one key")
    dropped = scalars[0]
    _check(dropped, "dropped", torch.int64, 0, dev)
    _check(sel_idx, "sel_idx", torch.int32, 2, dev)
    if sel_idx.shape[0] != 1:
        raise ValueError("block_nfa: the selection must be [1, E]")
    E = sel_idx.shape[1]
    P = kp.P
    W = min(CHUNK, E)
    C = (E + W - 1) // W
    T = P + W
    CT = C * T

    pl = BlockNfaPlan.from_buffer_copy(kp.template)
    pl.E, pl.W, pl.C, pl.T = E, W, C, T
    pl.now = int(now)
    pl.smem = smem_bytes(P, W, pl.ev_ncols, pl.ncap)
    # converted launch temporaries stay referenced until the kernel is
    # queued (their blocks must not go to the outputs allocated below)
    converted = []
    if ts_wire is not None:
        base, delta = ts_wire
        _check(delta, "ts_delta", torch.int32, 1, dev)
        pl.B, pl.ts_wire, pl.ts_base = delta.shape[0], 1, int(base)
        pl.ts_delta = delta.data_ptr()
    else:
        _check(raw_ts, "raw_ts", torch.int64, 1, dev)
        pl.B, pl.ts_wire = raw_ts.shape[0], 0
        pl.raw_ts = raw_ts.data_ptr()
    if len(raw_cols) != len(kp.schema.types):
        raise ValueError("block_nfa: column count does not match the "
                         "stream schema")
    for c, (col, d) in enumerate(zip(raw_cols, kp.schema.dtypes)):
        if d == torch.bool:
            col = col.to(torch.int32)
            d = torch.int32
            converted.append(col)
        _check(col, f"column {c}", d, 1, dev)
        if col.shape[0] != pl.B:
            raise ValueError("block_nfa: column length differs from ts")
        pl.ev_col[c] = col.data_ptr()

    out_ts = torch.zeros(CT, dtype=torch.int64, device=dev)
    out_valid = torch.zeros(CT, dtype=torch.bool, device=dev)
    header = torch.zeros(1, dtype=torch.int64, device=dev)
    out_cols = {}
    for j, (a, c) in enumerate(kp.emit):
        sch = kp.sel.scope.schema(kp.atoms[a].ref)
        col = torch.zeros(CT, dtype=sch.dtypes[c], device=dev)
        out_cols[(a, c)] = col
        pl.out_col[j] = col.data_ptr()
    pl.b32, pl.b64, pl.dropped = b32.data_ptr(), b64.data_ptr(), \
        dropped.data_ptr()
    pl.sel_idx = sel_idx.data_ptr()
    pl.out_ts, pl.out_valid = out_ts.data_ptr(), out_valid.data_ptr()
    pl.header = header.data_ptr()

    held = fill_sets(pl.in_sets, kp.in_keys, in_tabs or {})
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("block_nfa", "siddhi_block_nfa",
                      "siddhi_block_nfa_plan_size", pl, stream)
    launches += 1
    del converted, held
    return (b32, b64, scalars), (header, out_ts, out_valid, out_cols)


def project(kp: BlockPlan, sel_state, kout, now: int):
    """The selector over the ordered rows (aggregators over group slot 0,
    as the plain block step's), then the cut to the emission cap
    (`core/pattern_block.py` `cut_rows`)."""
    header, out_ts, out_valid, out_cols = kout
    dev = out_ts.device
    CT = out_ts.shape[0]
    env: Dict[str, Any] = {"__ts__": out_ts, "__now__": now}
    for a in kp.atoms:
        n = len(kp.sel.scope.schema(a.ref).types)
        cols = tuple(out_cols.get((a.pos, c)) for c in range(n))
        env[a.ref] = env[f"{a.ref}@0"] = env[f"{a.ref}@-1"] = cols
    rows = Rows(ts=out_ts,
                kind=torch.full((CT,), ev.CURRENT, dtype=torch.int32,
                                device=dev),
                valid=out_valid, seq=None,
                gslot=torch.zeros((CT,), dtype=torch.int32, device=dev),
                cols=())
    sel_state, out = kp.sel.process(sel_state, rows, env)
    return cut_rows(out, kp.compact_rows, sel_state)


class BlockStep:
    """One step variant (raw or ts-delta wire) of a block-NFA query for
    one input stream, with the scan steps' call signatures:
      raw wire:  (packed, sel_state, raw_cols, raw_ts, sel_idx, key_ref, now)
      ts wire:   (packed, sel_state, raw_cols, ts_base, ts_delta, sel_idx,
                  key_ref, now)
    Returns (packed', sel_state', out, wake) with
    out = (n_valid, n_dropped, ts, kind, valid, cols)."""

    def __init__(self, body, kernel_plan: Optional[BlockPlan], wire: bool):
        self.body = body
        self.kernel_plan = kernel_plan
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
            ts_base, ts_delta, sel_idx, _key_ref, now = args
            ts_wire, raw_ts = (ts_base, ts_delta), None
        else:
            raw_ts, sel_idx, _key_ref, now = args
            ts_wire = None
        packed, kout = launch(self.kernel_plan, packed, raw_cols, raw_ts,
                              ts_wire, sel_idx, now, in_tabs)
        sel_state, out = project(self.kernel_plan, sel_state, kout, now)
        return packed, sel_state, out, NO_WAKEUP
