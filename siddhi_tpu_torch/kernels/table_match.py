"""Wrapper and plain version of the `table_match` CUDA kernel (K10).

The kernel (`siddhi_tpu_torch/csrc/table_match.cu`) replaces the device
work of the JAX package's `TableRuntime._match` (`siddhi_tpu/core/
table.py:259-316`) and `match_matrix` (:318), which the reference runs
eagerly outside any jitted step: the condition of a delete, an update or
an upsert over (batch row, table row) pairs, reduced to
  * hit bool[C]: a valid batch row matches the valid table row;
  * src int32[C]: the last such batch row, -1 where none;
  * matched_any bool[B]: the valid batch row matches a valid table row.
Dense mode evaluates every pair.  Candidate mode evaluates the host's
[B, K] candidates (int32, -1 where none: the primary-key allocator's slot
or an @Index lane), each checked against the table's valid column and the
full condition, as the reference's indexed branch does.

`table_match` is what `core/table.py` calls: CPU tensors run `plain` (the
condition as a compiled torch expression), CUDA tensors launch the kernel
(the condition as filter bytecode).  `launches` / `plain_calls` count
them, `dense_launches` the dense-mode launches; `reset_counts()` sets all
three to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _nvcc
from .filter_bytecode import LOAD_EV, _OP_LEN

launches = 0
plain_calls = 0
dense_launches = 0

MAX_COLS, MAX_CODE = 16, 256
_PLAIN_CHUNK = 1 << 24     # pairs the plain dense version holds at once
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls, dense_launches
    launches = plain_calls = dense_launches = 0


class MatchSpec:
    """The static part of one table condition: the scope keys of the table
    and of the batch (`other_key`), the condition as a compiled torch
    expression (the plain version) and, for a CUDA table, as bytecode with
    LOAD_EV reading the batch row and LOAD_OTHER the table row (the
    kernel; None when the table lives on the CPU)."""

    def __init__(self, table_key: str, other_key: str, compiled,
                 code: Optional[List[int]]):
        if code is not None and len(code) > MAX_CODE:
            raise NotImplementedError(
                f"a table condition needs {len(code)} bytecode words; the "
                f"kernel takes {MAX_CODE}")
        self.table_key, self.other_key = table_key, other_key
        self.compiled = compiled
        self.code = code


def table_match(spec: MatchSpec, ev_cols: Sequence, ev_ts, ev_valid,
                tab_cols: Sequence, tab_valid, cand=None):
    """(hit bool[C], src int32[C], matched_any bool[B]) of a batch
    (`ev_*`, [B]) against a table (`tab_*`, [C]); `cand` (int32 [B, K]) is
    the indexed path's candidates, None the dense path."""
    if tab_valid.is_cuda:
        return launch(spec, ev_cols, ev_valid, tab_cols, tab_valid, cand)
    return plain(spec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid, cand)


def plain(spec: MatchSpec, ev_cols, ev_ts, ev_valid, tab_cols, tab_valid,
          cand=None):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = tab_valid.device
    B, C = ev_valid.shape[0], tab_valid.shape[0]
    if cand is not None:
        c = cand.to(torch.int64)
        safe = torch.clamp(c, 0, max(C - 1, 0))
        ok = (c >= 0) & ev_valid[:, None] & tab_valid[safe]
        env = {spec.table_key: tuple(t[safe] for t in tab_cols),
               spec.other_key: tuple(e[:, None] for e in ev_cols),
               "__ts__": ev_ts[:, None]}
        ok = ok & torch.broadcast_to(spec.compiled.fn(env), ok.shape)
        hit = torch.zeros(C, dtype=torch.bool, device=dev)
        src = torch.full((C,), -1, dtype=torch.int64, device=dev)
        rows = safe[ok]
        hit[rows] = True
        bs = torch.arange(B, device=dev)[:, None].expand(ok.shape)[ok]
        src.scatter_reduce_(0, rows, bs, "amax")
        return hit, src.to(torch.int32), ok.any(dim=1)
    # dense: every pair, a chunk of batch rows at a time
    hit = torch.zeros(C, dtype=torch.bool, device=dev)
    src = torch.full((C,), -1, dtype=torch.int64, device=dev)
    anyb = torch.zeros(B, dtype=torch.bool, device=dev)
    step = max(1, _PLAIN_CHUNK // max(C, 1))
    tab = tuple(t[None, :] for t in tab_cols)
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        env = {spec.table_key: tab,
               spec.other_key: tuple(e[b0:b1, None] for e in ev_cols),
               "__ts__": ev_ts[b0:b1, None]}
        m = torch.broadcast_to(spec.compiled.fn(env), (b1 - b0, C))
        m = m & tab_valid[None, :] & ev_valid[b0:b1, None]
        hit |= m.any(dim=0)
        rid = torch.arange(b0, b1, device=dev)[:, None]
        src = torch.maximum(src, torch.where(m, rid, -1).max(dim=0).values)
        anyb[b0:b1] = m.any(dim=1)
    return hit, src.to(torch.int32), anyb


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class MatchPlan(ctypes.Structure):
    """Mirrors `struct MatchPlan` in csrc/table_match.cu."""
    _fields_ = (
        [("B", _L), ("C", _L), ("K", _L),
         ("ncols_ev", _I), ("ncols_tab", _I), ("code_len", _I),
         ("ev_used", _I),
         ("ev_bytes", _I * MAX_COLS), ("tab_bytes", _I * MAX_COLS),
         ("code", _I * MAX_CODE),
         ("ev_col", _P * MAX_COLS), ("tab_col", _P * MAX_COLS),
         ("ev_valid", _P), ("tab_valid", _P), ("cand", _P),
         ("hit", _P), ("src", _P), ("any", _P)])


def ev_columns_used(code: List[int]) -> int:
    """Bit j set: the bytecode loads batch column j."""
    used, pc = 0, 0
    while pc < len(code):
        if code[pc] == LOAD_EV:
            used |= 1 << code[pc + 1]
        pc += _OP_LEN[code[pc]]
    return used


def _check(x, what, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"table_match: {what} must be a contiguous {shape} {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on "
            f"{x.device})")


def launch(spec: MatchSpec, ev_cols, ev_valid, tab_cols, tab_valid,
           cand=None):
    """Launch the match on the current stream."""
    global launches, dense_launches
    if spec.code is None:
        raise NotImplementedError(
            "this table condition has no bytecode (planned for another "
            "device)")
    dev = tab_valid.device
    B, C = ev_valid.shape[0], tab_valid.shape[0]
    if len(ev_cols) > MAX_COLS or len(tab_cols) > MAX_COLS:
        raise ValueError(f"table_match: more than {MAX_COLS} columns")
    _check(ev_valid, "batch valid", torch.bool, (B,), dev)
    _check(tab_valid, "table valid", torch.bool, (C,), dev)
    pl = MatchPlan()
    pl.B, pl.C = B, C
    pl.ncols_ev, pl.ncols_tab = len(ev_cols), len(tab_cols)
    pl.code_len = len(spec.code)
    for j, w in enumerate(spec.code):
        pl.code[j] = w
    pl.ev_used = ev_columns_used(spec.code)
    for j, c in enumerate(ev_cols):
        _check(c, f"batch column {j}", c.dtype, (B,), dev)
        pl.ev_bytes[j], pl.ev_col[j] = c.element_size(), c.data_ptr()
    for j, c in enumerate(tab_cols):
        _check(c, f"table column {j}", c.dtype, (C,), dev)
        pl.tab_bytes[j], pl.tab_col[j] = c.element_size(), c.data_ptr()
    if cand is not None:
        _check(cand, "candidates", torch.int32, tuple(cand.shape), dev)
        if cand.dim() != 2 or cand.shape[0] != B or cand.shape[1] == 0:
            raise ValueError("table_match: candidates must be [B, K], "
                             "K > 0")
        pl.K = cand.shape[1]
        pl.cand = cand.data_ptr()
    hit = torch.empty(C, dtype=torch.bool, device=dev)
    src = torch.empty(C, dtype=torch.int32, device=dev)
    anyb = torch.empty(B, dtype=torch.bool, device=dev)
    pl.ev_valid, pl.tab_valid = ev_valid.data_ptr(), tab_valid.data_ptr()
    pl.hit, pl.src, pl.any = hit.data_ptr(), src.data_ptr(), anyb.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("table_match", "siddhi_table_match",
                      "siddhi_match_plan_size", pl, stream)
    launches += 1
    dense_launches += int(cand is None)
    return hit, src, anyb
