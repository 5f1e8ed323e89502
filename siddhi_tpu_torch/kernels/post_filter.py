"""Wrapper and plain version of the `post_filter` CUDA kernel (K15): the
filters after a single-stream query's window.

The kernel (`siddhi_tpu_torch/csrc/post_filter.cu`) replaces the JAX
package's `_apply_chain` over the post-window chain
(`siddhi_tpu/core/planner.py:124`) in `select_body` (`:501-516`) and in
the keyed step `kstep` (`:574-580`): over the window's output rows, a
CURRENT or EXPIRED row stays valid only if it was valid and passes every
filter; TIMER and RESET rows keep their flag.  One kernel serves both
steps, because the keyed step runs the same `select_body`.  The filters
reach it as the typed postfix bytecode of `kernels/filter_bytecode.py`,
in a `FilterSpec` whose `compiled` expressions are the plain version's.

`post_filter` is what `select_body` calls: CPU tensors run `plain`, CUDA
tensors launch the kernel, and a plan without bytecode raises.
`launches` / `plain_calls` count them; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import event as ev
from ..core.window import Rows
from . import _nvcc
from .filter_bytecode import type_code
from .filter_compact import FilterSpec
from .in_probe import MAX_IN, InSet, fill_sets

launches = 0
plain_calls = 0

MAX_COLS, MAX_CODE = 16, 256
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def post_filter(spec: FilterSpec, rows: Rows, now: int) -> torch.Tensor:
    """The rows' new valid flags."""
    if rows.ts.is_cuda:
        return launch(spec, rows)
    return plain(spec, rows, now)


def plain(spec: FilterSpec, rows: Rows, now: int) -> torch.Tensor:
    """The plain PyTorch version (the kernel's reference): the compiled
    filters over the rows, each gating only CURRENT and EXPIRED rows."""
    global plain_calls
    plain_calls += 1
    env = spec.env(rows.cols, rows.ts, now, rows.kind)
    data_row = torch.logical_or(rows.kind == ev.CURRENT,
                                rows.kind == ev.EXPIRED)
    keep = rows.valid
    for c in spec.compiled:
        keep = torch.logical_and(
            keep, torch.logical_or(torch.logical_not(data_row), c.fn(env)))
    return keep


class PostPlan(ctypes.Structure):
    """Mirrors `struct PostPlan` in csrc/post_filter.cu."""
    _fields_ = (
        [("R", _L), ("ncols", _I), ("code_len", _I),
         ("col_ty", _I * MAX_COLS), ("code", _I * MAX_CODE),
         ("kind", _P), ("valid", _P), ("col", _P * MAX_COLS),
         ("out_valid", _P), ("in_sets", InSet * MAX_IN)])


def launch(spec: FilterSpec, rows: Rows) -> torch.Tensor:
    global launches
    if spec.bytecode is None:
        raise NotImplementedError(
            "this filter plan has no bytecode (planned for another device)")
    dev = rows.ts.device
    R = int(rows.ts.shape[0])
    if len(rows.cols) != len(spec.types) or len(rows.cols) > MAX_COLS:
        raise ValueError("post_filter: column count differs from plan")
    for x, d, name in ((rows.kind, torch.int32, "kind"),
                       (rows.valid, torch.bool, "valid")):
        if x.device != dev or x.dtype != d or tuple(x.shape) != (R,) or \
                not x.is_contiguous():
            raise ValueError(f"post_filter: {name} must be a contiguous "
                             f"[{R}] {d} tensor on {dev}")
    pl = PostPlan()
    pl.R, pl.ncols = R, len(rows.cols)
    pl.code_len = len(spec.bytecode)
    for j, w in enumerate(spec.bytecode):
        pl.code[j] = w
    # bool columns travel as int32 (the bytecode's value slots); the
    # converted columns must live until the kernel is queued
    keep_alive = []
    for j, (c, tp) in enumerate(zip(rows.cols, spec.types)):
        d = ev.dtype_of(tp)
        if d == torch.bool:
            c = c.to(torch.int32)
            d = torch.int32
        c = c.contiguous()
        if c.device != dev or c.dtype != d or tuple(c.shape) != (R,):
            raise ValueError(f"post_filter: column {j} must be a [{R}] {d} "
                             f"tensor on {dev}")
        keep_alive.append(c)
        pl.col_ty[j] = type_code(tp)
        pl.col[j] = c.data_ptr()
    out = torch.empty(max(R, 1), dtype=torch.bool, device=dev)
    pl.kind, pl.valid, pl.out_valid = rows.kind.data_ptr(), \
        rows.valid.data_ptr(), out.data_ptr()
    held = fill_sets(pl.in_sets, spec.in_keys, spec.in_tabs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("post_filter", "siddhi_post_filter",
                      "siddhi_post_plan_size", pl, stream)
    launches += 1
    del keep_alive, held
    return out[:R]
