"""Wrapper and plain version of the `agg_base` CUDA kernel (K27).

The kernel (`siddhi_tpu_torch/csrc/agg_base.cu`) replaces the JAX
package's incremental-aggregation `step` (`siddhi_tpu/core/
aggregation.py:483-506`): over one batch, each row's `keep` flag (valid,
CURRENT and passing every filter of the aggregation's input) and, for
every base aggregation, its f64 value:
  * 1.0 for a `count()` base (ONE);
  * 1.0 where the argument is not null, else 0.0, for a non-null count
    (NONNULL);
  * the argument in f64, its in-band null (INT_MIN, LONG_MIN or NaN)
    replaced by the base's identity (0, +inf or -inf), for a sum, min or
    max (VALUE).
Every row gets its values, kept or not, as the reference computes them;
the merge (K28) drops the rows the host gave no slot.

The filters and arguments reach the kernel as the typed postfix bytecode
of `kernels/filter_bytecode.py` (`compile_filter`, `compile_value`): it is
CUDA rather than Triton because it runs the port's runtime-compiled
expressions through `csrc/bytecode.cuh`'s interpreter, as K1 does.  The
plain version runs the same filters and arguments as compiled torch
expressions.

`agg_base` is what `AggregationRuntime.process_staged` calls: CPU tensors
run `plain`, CUDA tensors launch the kernel, and a spec without bytecode
raises.  `launches` / `plain_calls` count them; `reset_counts()` sets both
to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..core import event as ev
from . import _nvcc
from .filter_bytecode import compile_value, type_code

launches = 0
plain_calls = 0

MAX_COLS, MAX_CODE, MAX_BASE, MAX_VCODE = 16, 256, 16, 256
ONE, NONNULL, VALUE = range(3)
_I, _L, _P, _D = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, \
    ctypes.c_double


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class BaseSpec:
    """The static part of an aggregation's base step: the input's column
    types and scope key, the filters (compiled torch expressions, and on
    CUDA their bytecode `fcode`), and per base its mode, compiled argument
    (None for ONE), identity and, on CUDA, the argument's bytecode with its
    result type code and null kind."""

    def __init__(self, types: Sequence[str], scope_key: str, filters,
                 fcode: Optional[List[int]], modes, srcs, idents,
                 vcodes=None, vtypes=None, vnks=None):
        self.types = list(types)
        self.scope_key = scope_key
        self.filters = list(filters)
        self.fcode = fcode
        self.modes, self.srcs, self.idents = list(modes), list(srcs), \
            list(idents)
        self.vcodes, self.vtypes, self.vnks = vcodes, vtypes, vnks

    @classmethod
    def build(cls, types, scope_key: str, filters, fcode, bases,
              scope) -> "BaseSpec":
        """From an AggregationRuntime's bases (`core/aggregation.py`
        `_BaseAgg`); with `fcode` (a CUDA plan) each argument is compiled
        to bytecode too, and a plan outside the kernel's limits raises."""
        from ..core.executor import CompileError
        modes = [b.mode for b in bases]
        srcs = [b.src for b in bases]
        idents = [b.identity() for b in bases]
        if fcode is None:
            return cls(types, scope_key, filters, None, modes, srcs, idents)
        why = None
        if len(types) > MAX_COLS:
            why = f"{len(types)} input columns (K27 takes {MAX_COLS})"
        elif len(bases) > MAX_BASE:
            why = f"{len(bases)} base aggregations (K27 takes {MAX_BASE})"
        elif len(fcode) > MAX_CODE:
            why = f"{len(fcode)} filter words (K27 takes {MAX_CODE})"
        vcodes, vtypes, vnks = [], [], []
        for b in bases:
            if b.mode == ONE:
                vcodes.append([])
                vtypes.append(0)
                vnks.append(0)
                continue
            try:
                code, t, nk = compile_value(b.expr, scope, scope_key)
            except CompileError as exc:
                why = why or str(exc)
                break
            vcodes.append(code)
            vtypes.append(t)
            vnks.append(nk)
        if why is None and sum(len(c) for c in vcodes) > MAX_VCODE:
            why = f"the arguments need more than {MAX_VCODE} bytecode words"
        if why is not None:
            raise NotImplementedError(
                f"the aggregation is outside the CUDA kernels' subset: "
                f"{why}")
        return cls(types, scope_key, filters, fcode, modes, srcs, idents,
                   vcodes, vtypes, vnks)


def agg_base(spec: BaseSpec, batch, now: int):
    """(keep bool[B], vals f64[n_base, B]) of one batch (`ev.EventBatch`
    on the device)."""
    if batch.ts.is_cuda:
        return launch(spec, batch)
    return plain(spec, batch, now)


def plain(spec: BaseSpec, batch, now: int):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    B = batch.ts.shape[0]
    dev = batch.ts.device
    env = {spec.scope_key: tuple(batch.cols), "__ts__": batch.ts,
           "__now__": now, "__kind__": batch.kind}
    keep = torch.logical_and(batch.valid, batch.kind == ev.CURRENT)
    for f in spec.filters:
        keep = torch.logical_and(keep, f.fn(env))
    vals = torch.empty((len(spec.modes), B), dtype=torch.float64, device=dev)
    for b, (mode, src, ident) in enumerate(zip(spec.modes, spec.srcs,
                                               spec.idents)):
        if mode == ONE:
            vals[b] = 1.0
            continue
        raw = torch.as_tensor(src.fn(env), device=dev).expand(B)
        nul = ev.null_mask(raw, src.type)
        if mode == NONNULL:
            vals[b] = torch.where(nul, 0.0, 1.0)
        else:
            vals[b] = torch.where(nul, ident, raw.to(torch.float64))
    return keep, vals


class BasePlan(ctypes.Structure):
    """Mirrors `struct BasePlan` in csrc/agg_base.cu."""
    _fields_ = (
        [("B", _L), ("ncols", _I), ("nbase", _I), ("fcode_len", _I),
         ("pad", _I), ("col_ty", _I * MAX_COLS), ("fcode", _I * MAX_CODE),
         ("vcode", _I * MAX_VCODE), ("voff", _I * MAX_BASE),
         ("vlen", _I * MAX_BASE), ("mode", _I * MAX_BASE),
         ("vty", _I * MAX_BASE), ("vnk", _I * MAX_BASE),
         ("ident", _D * MAX_BASE),
         ("kind", _P), ("valid", _P), ("col", _P * MAX_COLS),
         ("keep", _P), ("vals", _P)])


def launch(spec: BaseSpec, batch):
    global launches
    if spec.fcode is None:
        raise NotImplementedError(
            "this aggregation plan has no bytecode (planned for another "
            "device)")
    dev = batch.ts.device
    B = int(batch.ts.shape[0])
    if len(batch.cols) != len(spec.types):
        raise ValueError("agg_base: column count differs from plan")
    for x, d, name in ((batch.kind, torch.int32, "kind"),
                       (batch.valid, torch.bool, "valid")):
        if x.device != dev or x.dtype != d or tuple(x.shape) != (B,) or \
                not x.is_contiguous():
            raise ValueError(f"agg_base: {name} must be a contiguous [{B}] "
                             f"{d} tensor on {dev}")
    pl = BasePlan()
    pl.B, pl.ncols, pl.nbase = B, len(spec.types), len(spec.modes)
    pl.fcode_len = len(spec.fcode)
    for j, w in enumerate(spec.fcode):
        pl.fcode[j] = w
    off = 0
    for b, code in enumerate(spec.vcodes):
        pl.voff[b], pl.vlen[b] = off, len(code)
        for j, w in enumerate(code):
            pl.vcode[off + j] = w
        off += len(code)
        pl.mode[b], pl.vty[b], pl.vnk[b] = spec.modes[b], spec.vtypes[b], \
            spec.vnks[b]
        pl.ident[b] = spec.idents[b]
    # bool columns travel as int32 (the bytecode's value slots); the
    # converted columns must live until the kernel is queued
    keep_alive = []
    for j, (c, tp) in enumerate(zip(batch.cols, spec.types)):
        d = ev.dtype_of(tp)
        if d == torch.bool:
            c, d = c.to(torch.int32), torch.int32
        c = c.contiguous()
        if c.device != dev or c.dtype != d or tuple(c.shape) != (B,):
            raise ValueError(f"agg_base: column {j} must be a [{B}] {d} "
                             f"tensor on {dev}")
        keep_alive.append(c)
        pl.col_ty[j] = type_code(tp)
        pl.col[j] = c.data_ptr()
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    vals = torch.empty((len(spec.modes), B), dtype=torch.float64, device=dev)
    pl.kind, pl.valid = batch.kind.data_ptr(), batch.valid.data_ptr()
    pl.keep, pl.vals = keep.data_ptr(), vals.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("agg_base", "siddhi_agg_base",
                      "siddhi_agg_base_plan_size", pl, stream)
    launches += 1
    del keep_alive
    return keep, vals
