"""Wrapper and plain version of the `filter_compact` CUDA kernel (K1).

The kernel (`siddhi_tpu_torch/csrc/filter_compact.cu`) replaces the JAX
package's pre-window filter chain and pass-through window
(`siddhi_tpu/core/planner.py` `_apply_chain` filters, `stage_body`, and
`siddhi_tpu/core/window.py` `NoWindow.process` with `sort_rows`): it
evaluates each row's filters (the typed postfix bytecode of
`kernels/filter_bytecode.py`, one thread per row) and writes a STABLE
compaction of the rows that are valid, CURRENT (or EXPIRED, with
`keep_expired`: a query reading a named window, the reference's
`PassAllWindow`, `siddhi_tpu/core/window.py:199`) and pass: kept rows first in
input order, then the others in input order, marked invalid.  It writes the
kept count to a device scalar and, for a pass-through window, numbers the
kept rows `seq0 + rank` and advances the seq counter by the count.

`filter_compact` is what the window processors call.  Given CPU tensors it
runs `plain` (the filters as compiled torch expressions); given CUDA
tensors it launches the kernel, and a plan without bytecode raises.

`launches` counts kernel launches and `plain_calls` calls of the plain
version; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core import event as ev
from ..core.window import BIG_SEQ, Rows, sort_rows
from . import _nvcc
from .filter_bytecode import type_code
from .in_probe import MAX_IN, InSet, fill_sets, probe_env

launches = 0
plain_calls = 0

MAX_COLS, MAX_CODE, BLOCK = 16, 256, 256
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class FilterPlan(ctypes.Structure):
    """Mirrors `struct FilterPlan` in csrc/filter_compact.cu."""
    _fields_ = (
        [("B", _I), ("ncols", _I), ("code_len", _I), ("write_seq", _I),
         ("keep_expired", _I), ("aligned", _I), ("col_ty", _I * MAX_COLS),
         ("code", _I * MAX_CODE),
         ("ts", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("col", _P * MAX_COLS),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_seq", _P), ("out_gslot", _P), ("out_col", _P * MAX_COLS),
         ("count", _P), ("seq", _P), ("flags", _P), ("block_sums", _P),
         ("in_sets", InSet * MAX_IN)])


class FilterSpec:
    """The static part of one query's filter step: the stream's column
    types, the filters as compiled torch expressions (the plain version)
    and, on CUDA, as bytecode (the kernel).  `bytecode` is None when the
    plan was made for the CPU.  `in_keys` are the (table, compare type)
    pairs of the bytecode's `in` probes; `in_tabs` the tables a step's
    probes read (`bind`)."""

    def __init__(self, types: Sequence[str], compiled, bytecode,
                 scope_key: str, in_keys=(), in_tabs=None):
        if bytecode is not None and len(bytecode) > MAX_CODE:
            raise NotImplementedError(
                f"the filters need {len(bytecode)} bytecode words; the "
                f"kernel takes {MAX_CODE}")
        if len(in_keys) > MAX_IN:
            raise NotImplementedError(
                f"the filters probe {len(in_keys)} (table, type) pairs; "
                f"the kernels take {MAX_IN}")
        self.types = list(types)
        self.compiled = list(compiled)
        self.bytecode = bytecode
        self.scope_key = scope_key
        self.in_keys = list(in_keys)
        self.in_tabs = in_tabs or {}

    def bind(self, in_tabs) -> "FilterSpec":
        """This spec with the tables its `in` probes read at one step."""
        if not in_tabs:
            return self
        return FilterSpec(self.types, self.compiled, self.bytecode,
                          self.scope_key, self.in_keys, in_tabs)

    def env(self, cols, ts, now: int, kind) -> dict:
        """The compiled filters' env over one batch (the plain version)."""
        env = {self.scope_key: tuple(cols), "__ts__": ts, "__now__": now,
               "__kind__": kind}
        env.update(probe_env(self.in_tabs))
        return env


def filter_compact(spec: FilterSpec, ts, kind, valid, gslot, cols,
                   now: int, seq: Optional[torch.Tensor] = None,
                   keep_expired: bool = False, aligned: bool = False):
    """(Rows of the same capacity, kept count i64[1]).  `seq` (i64[1]) is
    the pass-through window's counter: given, kept rows get
    `seq0 + rank` and the counter advances; otherwise every row's seq is
    its input index.  With `keep_expired` EXPIRED rows are kept as
    CURRENT ones are.  `aligned` leaves every row at its input position
    (valid where kept) instead of compacting.  A `Prefiltered` spec
    (`kernels/multi_filter.py`) carries rows K29 already compacted: they
    are returned as they are."""
    take = getattr(spec, "take", None)
    if take is not None:
        return take(seq, keep_expired)
    if ts.is_cuda:
        return launch(spec, ts, kind, valid, gslot, cols, seq, keep_expired,
                      aligned)
    return plain(spec, ts, kind, valid, gslot, cols, now, seq, keep_expired,
                 aligned)


def plain(spec: FilterSpec, ts, kind, valid, gslot, cols, now: int,
          seq: Optional[torch.Tensor] = None, keep_expired: bool = False,
          aligned: bool = False):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    data = kind == ev.CURRENT
    if keep_expired:
        data = torch.logical_or(data, kind == ev.EXPIRED)
    keep = torch.logical_and(valid, data)
    env = spec.env(cols, ts, now, kind)
    for c in spec.compiled:
        keep = torch.logical_and(keep, c.fn(env))
    n = keep.sum().reshape(1)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    seq0 = seq if seq is not None else 0
    key = torch.where(keep, seq0 + rank, torch.full_like(rank, BIG_SEQ))
    rows = Rows(ts=ts, kind=kind, valid=keep, seq=key, gslot=gslot,
                cols=tuple(cols))
    if not aligned:
        rows = sort_rows(rows)
    if seq is not None:
        seq.add_(n)
    elif aligned:
        rows = rows._replace(seq=torch.arange(ts.shape[0],
                                              device=ts.device))
    else:
        # without a counter each row's seq is its input index
        rows = rows._replace(seq=torch.argsort(key, stable=True))
    return rows, n


def _check(x, name, dtype, n, dev):
    if x.device != dev or x.dtype != dtype or x.dim() != 1 or \
            x.shape[0] != n or not x.is_contiguous():
        raise ValueError(
            f"filter_compact: {name} must be a contiguous [{n}] {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on "
            f"{x.device})")


def launch(spec: FilterSpec, ts, kind, valid, gslot, cols,
           seq: Optional[torch.Tensor] = None, keep_expired: bool = False,
           aligned: bool = False):
    global launches
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    dev = ts.device
    B = ts.shape[0]
    _check(ts, "ts", torch.int64, B, dev)
    _check(kind, "kind", torch.int32, B, dev)
    _check(valid, "valid", torch.bool, B, dev)
    _check(gslot, "gslot", torch.int32, B, dev)
    if len(cols) != len(spec.types):
        raise ValueError("filter_compact: column count differs from plan")
    pl = FilterPlan()
    pl.B, pl.ncols = B, len(cols)
    pl.code_len = len(spec.bytecode)
    for j, w in enumerate(spec.bytecode):
        pl.code[j] = w
    # bool columns travel as int32 (the bytecode's value slots) both ways;
    # the converted inputs must live until the kernel is queued
    keep_alive, outs = [], []
    for c, (col, t) in enumerate(zip(cols, spec.types)):
        d = ev.dtype_of(t)
        if d == torch.bool:
            col = col.to(torch.int32)
            keep_alive.append(col)
            d = torch.int32
        _check(col, f"column {c}", d, B, dev)
        out = torch.empty(B, dtype=d, device=dev)
        outs.append(out)
        pl.col_ty[c] = type_code(t)
        pl.col[c] = col.data_ptr()
        pl.out_col[c] = out.data_ptr()
    out_ts = torch.empty(B, dtype=torch.int64, device=dev)
    out_kind = torch.empty(B, dtype=torch.int32, device=dev)
    out_valid = torch.empty(B, dtype=torch.bool, device=dev)
    out_seq = torch.empty(B, dtype=torch.int64, device=dev)
    out_gslot = torch.empty(B, dtype=torch.int32, device=dev)
    # the launcher queues nothing for an empty batch: its count is 0 here
    count = (torch.zeros if B == 0 else torch.empty)(1, dtype=torch.int64,
                                                     device=dev)
    nb = (B + BLOCK - 1) // BLOCK
    flags = torch.empty(B, dtype=torch.uint8, device=dev)
    block_sums = torch.empty(nb + 1, dtype=torch.int64, device=dev)
    if seq is not None:
        _check(seq, "seq", torch.int64, 1, dev)
    pl.write_seq = int(seq is not None)
    pl.keep_expired = int(keep_expired)
    pl.aligned = int(aligned)
    pl.ts, pl.kind, pl.valid, pl.gslot = (ts.data_ptr(), kind.data_ptr(),
                                          valid.data_ptr(), gslot.data_ptr())
    pl.out_ts, pl.out_kind, pl.out_valid = (out_ts.data_ptr(),
                                            out_kind.data_ptr(),
                                            out_valid.data_ptr())
    pl.out_seq, pl.out_gslot = out_seq.data_ptr(), out_gslot.data_ptr()
    pl.count = count.data_ptr()
    pl.seq = seq.data_ptr() if seq is not None else None
    pl.flags, pl.block_sums = flags.data_ptr(), block_sums.data_ptr()
    held = fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("filter_compact", "siddhi_filter_compact",
                      "siddhi_filter_plan_size", pl, stream)
    launches += 1
    ocols = tuple(o != 0 if ev.dtype_of(t) == torch.bool else o
                  for o, t in zip(outs, spec.types))
    del keep_alive, held
    return Rows(ts=out_ts, kind=out_kind, valid=out_valid, seq=out_seq,
                gslot=out_gslot, cols=ocols), count
