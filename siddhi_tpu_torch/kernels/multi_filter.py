"""Wrapper and plain version of the `multi_filter` CUDA kernel (K29).

The kernel (`siddhi_tpu_torch/csrc/multi_filter.cu`) evaluates P filter
programs over S staged batches in one launch sequence: the pre-window
filters of a fused stack (`@fuse`, `core/fusion.py`: one program, S
batches, a plain query or a join side), of a merge group (`optimizer/
mqo.py`: one program per unit, one batch) or of a fused merge group (both).
It replaces P x S runs of kernel K1 (`kernels/filter_compact.py`), whose
output each (program, batch) pair's output equals: the rows compacted
stably, kept rows first, numbered from the program's seq counter when it
has one (batch after batch), and the kept count, kept on the card.

The window processors take those rows through `Prefiltered`: a filter
spec that carries one (program, batch)'s compacted rows, which
`filter_compact` hands back in place of running K1 (`core/window.py`
`_arrivals`).

`multi_filter` is what the dispatchers call.  Given CPU tensors it runs
`plain` (K1's plain version per (program, batch), in batch order); given
CUDA tensors it launches the kernel, and a plan without bytecode raises.

`launches` counts launch sequences and `plain_calls` calls of the plain
version; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import event as ev
from ..core.window import Rows
from . import _nvcc
from .filter_bytecode import type_code
from .filter_compact import MAX_CODE, MAX_COLS, FilterSpec
from .filter_compact import plain as k1_plain
from .in_probe import MAX_IN, InSet, fill_sets

launches = 0
plain_calls = 0

MAX_P, BLOCK = 8, 256
_I, _P = ctypes.c_int, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class MultiPlan(ctypes.Structure):
    """Mirrors `struct MultiPlan` in csrc/multi_filter.cu."""
    _fields_ = (
        [("P", _I), ("S", _I), ("B", _I), ("ncols", _I),
         ("write_seq_mask", _I), ("keep_expired_mask", _I),
         ("col_ty", _I * MAX_COLS), ("code_len", _I * MAX_P),
         ("codes", _P), ("ts", _P), ("kind", _P), ("valid", _P),
         ("col", _P * MAX_COLS), ("gslot", _P * MAX_P), ("seq", _P * MAX_P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("counts", _P), ("flags", _P), ("block_sums", _P),
         ("in_sets", (InSet * MAX_IN) * MAX_P)])


class Prefiltered(FilterSpec):
    """A filter spec whose rows were already filtered and compacted (by
    K29): `filter_compact` returns `rows` and `count` instead of running
    K1.  `seq_written` tells whether the rows were numbered from the
    window's seq counter (and the counter advanced)."""

    def __init__(self, spec: FilterSpec, rows: Rows, count: torch.Tensor,
                 seq_written: bool):
        super().__init__(spec.types, spec.compiled, spec.bytecode,
                         spec.scope_key, spec.in_keys, spec.in_tabs)
        self.rows, self.count, self.seq_written = rows, count, seq_written

    def bind(self, in_tabs) -> "Prefiltered":
        return self

    def take(self, seq: Optional[torch.Tensor], keep_expired: bool):
        if (seq is not None) != self.seq_written:
            raise RuntimeError(
                "multi_filter: the rows were compacted for another window "
                "(seq counter use differs)")
        return self.rows, self.count


_codes: Dict[Tuple, torch.Tensor] = {}


def _codes_for(specs: Sequence[FilterSpec], dev) -> torch.Tensor:
    """The programs' bytecode as [P, MAX_CODE] int32 on the card, uploaded
    once per program set."""
    key = (dev, tuple(tuple(s.bytecode) for s in specs))
    t = _codes.get(key)
    if t is None:
        if len(_codes) > 256:
            _codes.clear()
        host = torch.zeros((len(specs), MAX_CODE), dtype=torch.int32)
        for p, s in enumerate(specs):
            if s.bytecode:
                host[p, :len(s.bytecode)] = torch.tensor(s.bytecode,
                                                         dtype=torch.int32)
        t = _codes[key] = host.to(dev)
    return t


def multi_filter(specs: Sequence[FilterSpec], ts, kind, valid, cols,
                 gslots, nows: Sequence[int],
                 seqs: Sequence[Optional[torch.Tensor]],
                 keep_expired: Sequence[bool]) -> List[List[Tuple]]:
    """Programs `specs` over the stacked batches ts / kind / valid / cols
    ([S, B] each; bool columns as bool), each program with its group-slot
    column `gslots[p]` ([S, B] int32), seq counter `seqs[p]` (i64[1] or
    None) and `keep_expired[p]`.  Returns out[p][s] = (Rows, kept count
    i64[1]) as K1 gives them for program p on batch s."""
    if ts.is_cuda:
        out: List[List[Tuple]] = []
        for lo in range(0, len(specs), MAX_P):
            hi = lo + MAX_P
            out.extend(launch(specs[lo:hi], ts, kind, valid, cols,
                              gslots[lo:hi], seqs[lo:hi],
                              keep_expired[lo:hi]))
        return out
    return plain(specs, ts, kind, valid, cols, gslots, nows, seqs,
                 keep_expired)


def plain(specs, ts, kind, valid, cols, gslots, nows, seqs, keep_expired):
    """The plain PyTorch version: K1's plain version per (program, batch),
    batch after batch, each program's counter threaded through."""
    global plain_calls
    plain_calls += 1
    S = ts.shape[0]
    out = []
    for spec, g, seq, kx in zip(specs, gslots, seqs, keep_expired):
        out.append([k1_plain(spec, ts[s], kind[s], valid[s], g[s],
                             tuple(c[s] for c in cols), nows[s], seq, kx)
                    for s in range(S)])
    return out


def _check(x, name, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"multi_filter: {name} must be a contiguous {list(shape)} "
            f"{dtype} tensor on {dev} (got {tuple(x.shape)} {x.dtype} on "
            f"{x.device})")


def launch(specs, ts, kind, valid, cols, gslots, seqs, keep_expired):
    global launches
    P = len(specs)
    if P > MAX_P:
        raise ValueError(f"multi_filter: at most {MAX_P} programs a launch")
    types = specs[0].types
    for s in specs:
        if s.bytecode is None:
            raise NotImplementedError(
                "this filter plan has no bytecode (planned for another "
                "device)")
        if s.types != types:
            raise ValueError("multi_filter: the programs read different "
                             "columns")
    dev = ts.device
    S, B = ts.shape
    _check(ts, "ts", torch.int64, (S, B), dev)
    _check(kind, "kind", torch.int32, (S, B), dev)
    _check(valid, "valid", torch.bool, (S, B), dev)
    if len(cols) != len(types) or len(cols) > MAX_COLS:
        raise ValueError("multi_filter: column count differs from plan")
    pl = MultiPlan()
    pl.P, pl.S, pl.B, pl.ncols = P, S, B, len(cols)
    keep_alive, outs = [], []
    for c, (col, t) in enumerate(zip(cols, types)):
        d = ev.dtype_of(t)
        if d == torch.bool:
            col = col.to(torch.int32)
            keep_alive.append(col)
            d = torch.int32
        _check(col, f"column {c}", d, (S, B), dev)
        o = torch.empty((P, S, B), dtype=d, device=dev)
        outs.append(o)
        pl.col_ty[c] = type_code(t)
        pl.col[c] = col.data_ptr()
        pl.out_col[c] = o.data_ptr()
    codes = _codes_for(specs, dev)
    pl.codes = codes.data_ptr()
    held = []
    for p, (spec, g, seq, kx) in enumerate(zip(specs, gslots, seqs,
                                               keep_expired)):
        pl.code_len[p] = len(spec.bytecode)
        _check(g, f"gslot {p}", torch.int32, (S, B), dev)
        pl.gslot[p] = g.data_ptr()
        if seq is not None:
            _check(seq, f"seq {p}", torch.int64, (1,), dev)
            pl.seq[p] = seq.data_ptr()
            pl.write_seq_mask |= 1 << p
        if kx:
            pl.keep_expired_mask |= 1 << p
        held.append(fill_sets(pl.in_sets[p], spec.in_keys, spec.in_tabs))
    out_ts = torch.empty((P, S, B), dtype=torch.int64, device=dev)
    out_kind = torch.empty((P, S, B), dtype=torch.int32, device=dev)
    out_valid = torch.empty((P, S, B), dtype=torch.bool, device=dev)
    out_seq = torch.empty((P, S, B), dtype=torch.int64, device=dev)
    out_gslot = torch.empty((P, S, B), dtype=torch.int32, device=dev)
    counts = torch.zeros((P, S), dtype=torch.int64, device=dev)
    nb = (B + BLOCK - 1) // BLOCK
    flags = torch.empty((P, S, B), dtype=torch.uint8, device=dev)
    block_sums = torch.empty((P * S, nb + 1), dtype=torch.int64, device=dev)
    pl.ts, pl.kind, pl.valid = ts.data_ptr(), kind.data_ptr(), \
        valid.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    pl.out_seq, pl.out_gslot = out_seq.data_ptr(), out_gslot.data_ptr()
    pl.counts, pl.flags = counts.data_ptr(), flags.data_ptr()
    pl.block_sums = block_sums.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("multi_filter", "siddhi_multi_filter",
                      "siddhi_multi_plan_size", pl, stream)
    launches += 1
    del keep_alive, held
    res = []
    for p, spec in enumerate(specs):
        row = []
        for s in range(S):
            ocols = tuple(o[p, s] != 0 if ev.dtype_of(t) == torch.bool
                          else o[p, s] for o, t in zip(outs, types))
            row.append((Rows(ts=out_ts[p, s], kind=out_kind[p, s],
                             valid=out_valid[p, s], seq=out_seq[p, s],
                             gslot=out_gslot[p, s], cols=ocols),
                        counts[p, s:s + 1]))
        res.append(row)
    return res


def prefiltered(specs, results, seqs) -> List[List[Prefiltered]]:
    """`Prefiltered` specs of a `multi_filter` result, per program and
    batch."""
    return [[Prefiltered(spec, rows, n, seq is not None)
             for rows, n in row]
            for spec, row, seq in zip(specs, results, seqs)]
