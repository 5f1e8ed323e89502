"""Wrapper and plain version of the `join_probe` CUDA kernel (K7).

The kernel (`siddhi_tpu_torch/csrc/join_probe.cu`) replaces the body of
the JAX package's join step (`siddhi_tpu/core/join.py:458-649`, `make_step`)
from the window's output to the emission compaction, for the bucket path,
the grid path and the two table modes:
  * every CURRENT or EXPIRED row the window emits (a trigger row) takes
    its candidates from the other side: from a ring, the rows of its
    bucket's lane (`kernels/join_lanes.py`, bucket path) or every live row
    in ring order (grid path), the order of the reference's buffer
    positions; from a table, every valid row in row order (grid over a
    table) or, on the table fast path, the valid rows among the host's
    [B, K] index candidates (ascending) of the batch row the trigger row
    came from, which its window carries as its last column;
  * the ON condition (filter bytecode, with `LOAD_EV` reading the trigger
    row and `LOAD_OTHER` the candidate) decides a match; a query's having
    condition, which the reference applies to each joined row before its
    cut, is a second bytecode over the same pair;
  * the joined rows are the index rows (li, ri, null): every matched pair
    first, in trigger-row order and within a row by ascending candidate,
    then, for an outer side, the trigger rows that matched nothing (with
    the other side null) in trigger-row order, after all pairs;
  * the first `cap` of them are kept, and the header gets [n_valid,
    n_current, n_dropped]: the rows kept, the CURRENT rows among them and
    the rows past the cap.
Rows past n_valid are written as (0, 0, null) and invalid, so the torch
projection's gathers stay in range.

`join_probe` is what the join step calls: CPU tensors run `plain` (the ON
and having conditions as compiled torch expressions), CUDA tensors launch
the kernel.  `launches` / `plain_calls` count them; of the launches,
`grid_table_launches` scanned a table and `index_launches` took the table
fast path's candidates; `reset_counts()` sets all four to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..core import event as ev
from . import _nvcc
from .filter_bytecode import type_code

launches = 0
plain_calls = 0
grid_table_launches = 0
index_launches = 0

MAX_COLS, MAX_CODE, BLOCK, SCAN_BLOCK = 16, 256, 256, 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls, grid_table_launches, index_launches
    launches = plain_calls = grid_table_launches = index_launches = 0


class ProbeSpec:
    """The static part of one side's probe: the ON and having conditions
    as compiled torch expressions (`on`, `having`, None when absent; the
    plain version) and, on CUDA, as bytecode (the kernel); the scope keys
    of the trigger side and the other side; both sides' column types as
    their windows hold them (a bucketed side's key-slot column last, the
    table fast path's batch-row column last on the trigger side); whether
    unmatched trigger rows are emitted (an outer side); `table`: None for
    a stream other side, "grid" or "index" for a table one."""

    def __init__(self, this_key: str, other_key: str,
                 this_types: Sequence[str], other_types: Sequence[str],
                 on, having, on_code: Optional[List[int]],
                 having_code: Optional[List[int]], emit_unmatched: bool,
                 bucket: bool, table: Optional[str] = None):
        for code in (on_code, having_code):
            if code is not None and len(code) > MAX_CODE:
                raise NotImplementedError(
                    f"a join condition needs {len(code)} bytecode words; "
                    f"the kernel takes {MAX_CODE}")
        if on_code is not None and \
                max(len(this_types), len(other_types)) > MAX_COLS:
            raise NotImplementedError(
                f"a join side has more than {MAX_COLS} columns")
        self.this_key, self.other_key = this_key, other_key
        self.this_types, self.other_types = list(this_types), \
            list(other_types)
        self.on, self.having = on, having
        self.on_code, self.having_code = on_code, having_code
        self.emit_unmatched = emit_unmatched
        self.bucket = bucket
        self.table = table

    @property
    def visible_this(self) -> int:
        return len(self.this_types) - int(self.bucket or
                                          self.table == "index")

    @property
    def visible_other(self) -> int:
        return len(self.other_types) - int(self.bucket)


def join_probe(spec: ProbeSpec, trig, o_cols, o_meta, lanes, nbl: int,
               cap: int, hdr, o_valid=None, cand=None):
    """(li i32[cap], ri i32[cap], null bool[cap], valid bool[cap]) of one
    step; writes [n_valid, n_current, n_dropped] into `hdr` (i64[3]).
    `trig` are the window's output rows, `o_cols` / `o_meta` the other
    side's ring columns and meta, `lanes` its lane table (None: grid).
    A table other side gives its columns, `o_meta` None and its valid
    column `o_valid`, and on the table fast path `cand` (int32 [B, K],
    -1 where none)."""
    if trig.ts.is_cuda:
        return launch(spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr,
                      o_valid, cand)
    return plain(spec, trig, o_cols, o_meta, lanes, nbl, cap, hdr,
                 o_valid, cand)


def _null_cols(types, n, dev):
    return tuple(torch.full((n,), ev.null_value(t), dtype=ev.dtype_of(t),
                            device=dev) for t in types)


def plain(spec: ProbeSpec, trig, o_cols, o_meta, lanes, nbl: int, cap: int,
          hdr, o_valid=None, cand=None):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = trig.ts.device
    R = trig.ts.shape[0]
    C = o_cols[0].shape[0]
    data = torch.logical_and(trig.valid, torch.logical_or(
        trig.kind == ev.CURRENT, trig.kind == ev.EXPIRED))
    head = 0
    if cand is not None:
        bix = torch.clamp(trig.cols[-1].to(torch.int64), 0,
                          cand.shape[0] - 1)
        j = cand[bix].to(torch.int64)               # [R, K]
        ok = (j >= 0) & (j < C)
        j = torch.where(ok, j, 0)
        ok = ok & o_valid[j]
    elif o_valid is not None:
        j = torch.arange(C, dtype=torch.int64, device=dev)[None, :].expand(
            R, C)
        ok = o_valid[None, :].expand(R, C)
    elif lanes is not None:
        head = int(o_meta[0])
        b = torch.where(data, torch.remainder(trig.cols[-1].to(torch.int64),
                                              nbl), 0)
        lane = lanes[b].to(torch.int64)             # [R, k]
        ok = lane < C
        j = torch.where(ok, lane, 0)
    else:
        head, tail = (int(x) for x in o_meta[:2].tolist())
        n = tail - head
        j = torch.arange(n, dtype=torch.int64, device=dev)[None, :].expand(
            R, n)
        ok = torch.ones(j.shape, dtype=torch.bool, device=dev)
    phys = torch.remainder(head + j, C)
    this_cols = tuple(c[:, None] for c in trig.cols[:spec.visible_this])
    other_cols = tuple(c[phys] for c in o_cols[:spec.visible_other])
    env = {spec.this_key: this_cols, spec.other_key: other_cols,
           "__ts__": trig.ts[:, None]}
    m = torch.logical_and(ok, data[:, None])
    if spec.on is not None:
        m = torch.logical_and(m, torch.broadcast_to(spec.on.fn(env),
                                                    m.shape))
    emit = m
    if spec.having is not None:
        emit = torch.logical_and(m, torch.broadcast_to(spec.having.fn(env),
                                                       m.shape))
    Q = m.shape[1]
    pflat = torch.nonzero(emit.reshape(-1)).flatten()
    li = [torch.div(pflat, max(Q, 1), rounding_mode="floor")]
    ri = [phys.reshape(-1)[pflat]]
    nul = [torch.zeros(pflat.shape[0], dtype=torch.bool, device=dev)]
    if spec.emit_unmatched:
        un = torch.logical_and(data, torch.logical_not(m.any(dim=1)))
        if spec.having is not None:
            nenv = {spec.this_key: trig.cols[:spec.visible_this],
                    spec.other_key: _null_cols(
                        spec.other_types[:spec.visible_other], R, dev),
                    "__ts__": trig.ts}
            un = torch.logical_and(un, torch.broadcast_to(
                spec.having.fn(nenv), un.shape))
        uidx = torch.nonzero(un).flatten()
        li.append(uidx)
        ri.append(torch.zeros_like(uidx))
        nul.append(torch.ones(uidx.shape[0], dtype=torch.bool, device=dev))
    li, ri, nul = torch.cat(li), torch.cat(ri), torch.cat(nul)
    total = li.shape[0]
    nv = min(total, cap)
    out_li = torch.zeros(cap, dtype=torch.int32, device=dev)
    out_ri = torch.zeros(cap, dtype=torch.int32, device=dev)
    out_null = torch.ones(cap, dtype=torch.bool, device=dev)
    out_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    out_li[:nv] = li[:nv].to(torch.int32)
    out_ri[:nv] = ri[:nv].to(torch.int32)
    out_null[:nv] = nul[:nv]
    out_valid[:nv] = True
    ncur = int((trig.kind[li[:nv]] == ev.CURRENT).sum())
    hdr.copy_(torch.tensor([nv, ncur, total - nv], dtype=torch.int64))
    return out_li, out_ri, out_null, out_valid


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class ProbePlan(ctypes.Structure):
    """Mirrors `struct ProbePlan` in csrc/join_probe.cu."""
    _fields_ = (
        [("R", _L), ("C", _L), ("cap", _L), ("nbl", _L), ("lane_k", _L),
         ("nscan", _L),
         ("ncols_this", _I), ("ncols_other", _I), ("on_len", _I),
         ("hv_len", _I), ("emit_unmatched", _I), ("jslot_col", _I),
         ("t_ty", _I * MAX_COLS), ("t_bytes", _I * MAX_COLS),
         ("o_ty", _I * MAX_COLS), ("o_bytes", _I * MAX_COLS),
         ("on_code", _I * MAX_CODE), ("hv_code", _I * MAX_CODE),
         ("o_null", _L * MAX_COLS),
         ("t_kind", _P), ("t_valid", _P), ("t_col", _P * MAX_COLS),
         ("o_col", _P * MAX_COLS), ("o_meta", _P), ("lanes", _P),
         ("pc", _P), ("uc", _P), ("sums_p", _P), ("sums_u", _P),
         ("out_li", _P), ("out_ri", _P), ("out_null", _P),
         ("out_valid", _P), ("hdr", _P),
         ("o_valid", _P), ("cand", _P), ("cand_b", _L), ("cand_k", _L)])


def launch(spec: ProbeSpec, trig, o_cols, o_meta, lanes, nbl: int,
           cap: int, hdr, o_valid=None, cand=None):
    """Launch the probe on the current stream."""
    global launches, grid_table_launches, index_launches
    if spec.on_code is None:
        raise NotImplementedError(
            "this probe plan has no bytecode (planned for another device)")
    dev = trig.ts.device
    R = trig.ts.shape[0]
    C = o_cols[0].shape[0]
    table = o_valid is not None
    for x, d in ((trig.kind, torch.int32), (trig.valid, torch.bool),
                 (o_valid if table else o_meta,
                  torch.bool if table else torch.int64),
                 (hdr, torch.int64)):
        if x.device != dev or x.dtype != d or not x.is_contiguous():
            raise ValueError("join_probe: an input has the wrong device, "
                             "dtype or layout")
    if len(trig.cols) != len(spec.this_types) or \
            len(o_cols) != len(spec.other_types):
        raise ValueError("join_probe: column count differs from the plan")
    pl = ProbePlan()
    pl.R, pl.C, pl.cap = R, C, cap
    pl.nbl = nbl if lanes is not None else 0
    pl.lane_k = lanes.shape[1] if lanes is not None else 0
    pl.nscan = (R + SCAN_BLOCK - 1) // SCAN_BLOCK
    pl.ncols_this, pl.ncols_other = len(trig.cols), len(o_cols)
    pl.on_len, pl.hv_len = len(spec.on_code), len(spec.having_code or ())
    for j, w in enumerate(spec.on_code):
        pl.on_code[j] = w
    for j, w in enumerate(spec.having_code or ()):
        pl.hv_code[j] = w
    pl.emit_unmatched = int(spec.emit_unmatched)
    pl.jslot_col = len(trig.cols) - 1 \
        if lanes is not None or cand is not None else -1
    if table:
        if o_valid.shape[0] != C:
            raise ValueError("join_probe: table valid column")
        pl.o_valid = o_valid.data_ptr()
    if cand is not None:
        if not table or cand.device != dev or cand.dtype != torch.int32 \
                or cand.dim() != 2 or not cand.is_contiguous() or \
                cand.shape[0] == 0:
            raise ValueError("join_probe: table candidates")
        pl.cand = cand.data_ptr()
        pl.cand_b, pl.cand_k = cand.shape
    for j, (c, t) in enumerate(zip(trig.cols, spec.this_types)):
        if c.device != dev or c.dtype != ev.dtype_of(t) or \
                not c.is_contiguous() or c.shape[0] != R:
            raise ValueError(f"join_probe: trigger column {j}")
        pl.t_ty[j], pl.t_bytes[j] = type_code(t), c.element_size()
        pl.t_col[j] = c.data_ptr()
    for j, (c, t) in enumerate(zip(o_cols, spec.other_types)):
        if c.device != dev or c.dtype != ev.dtype_of(t) or \
                not c.is_contiguous() or c.shape[0] != C:
            raise ValueError(f"join_probe: ring column {j}")
        pl.o_ty[j], pl.o_bytes[j] = type_code(t), c.element_size()
        pl.o_col[j] = c.data_ptr()
        pl.o_null[j] = _nvcc.slot_bits(ev.null_value(t), ev.dtype_of(t))
    if lanes is not None:
        if lanes.device != dev or lanes.dtype != torch.int32 or \
                not lanes.is_contiguous():
            raise ValueError("join_probe: lane table")
        pl.lanes = lanes.data_ptr()
    pc = torch.empty(max(R, 1), dtype=torch.int64, device=dev)
    uc = torch.empty(max(R, 1), dtype=torch.int64, device=dev)
    sums_p = torch.empty(pl.nscan + 1, dtype=torch.int64, device=dev)
    sums_u = torch.empty(pl.nscan + 1, dtype=torch.int64, device=dev)

    def e(d):
        return torch.empty(max(cap, 1), dtype=d, device=dev)
    out_li, out_ri = e(torch.int32), e(torch.int32)
    out_null, out_valid = e(torch.bool), e(torch.bool)
    pl.t_kind, pl.t_valid = trig.kind.data_ptr(), trig.valid.data_ptr()
    pl.o_meta = None if table else o_meta.data_ptr()
    pl.pc, pl.uc = pc.data_ptr(), uc.data_ptr()
    pl.sums_p, pl.sums_u = sums_p.data_ptr(), sums_u.data_ptr()
    pl.out_li, pl.out_ri = out_li.data_ptr(), out_ri.data_ptr()
    pl.out_null, pl.out_valid = out_null.data_ptr(), out_valid.data_ptr()
    pl.hdr = hdr.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("join_probe", "siddhi_join_probe",
                      "siddhi_probe_plan_size", pl, stream)
    launches += 1
    grid_table_launches += int(table and cand is None)
    index_launches += int(cand is not None)
    return out_li[:cap], out_ri[:cap], out_null[:cap], out_valid[:cap]
