"""Wrapper and plain version of the `table_write` CUDA kernel (K9).

The kernel (`siddhi_tpu_torch/csrc/table_write.cu`) replaces the JAX
package's two jitted table steps (`siddhi_tpu/core/table.py`):
  * `_write_impl` (:133), here `write`: each valid batch row whose slot
    lies in the table writes its columns (cast to the table column's
    dtype: on-demand writes stage integers as LONG), its ts, and valid;
  * `_masked_delete_impl` (:144), here `masked_delete`: valid &= ~kill.
Both update the table's tensors in place (the reference returned new,
donated arrays).

Duplicate slots in one batch: the last valid row of the batch writes (the
JAX package's CPU scatter applies rows in batch order, and the tier-1
tests hold the port to it).  The kernel picks that row with an atomicMax
claim into `win`, an int32[C] scratch the table owns, -1 between launches;
the plain version with a scatter-max.

`write` / `masked_delete` are what `core/table.py` calls: CPU tensors run
the plain versions, CUDA tensors launch the kernel.  `launches` /
`plain_calls` count the writes, `delete_launches` / `delete_plain_calls`
the deletes; `reset_counts()` sets all four to 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .filter_bytecode import _DTYPE_CODE

launches = 0
plain_calls = 0
delete_launches = 0
delete_plain_calls = 0

MAX_COLS = 16
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls, delete_launches, delete_plain_calls
    launches = plain_calls = delete_launches = delete_plain_calls = 0


class WritePlan(ctypes.Structure):
    """Mirrors `struct WritePlan` in csrc/table_write.cu."""
    _fields_ = (
        [("B", _L), ("C", _L), ("ncols", _I), ("pad_", _I),
         ("dst_ty", _I * MAX_COLS), ("src_ty", _I * MAX_COLS),
         ("dst", _P * MAX_COLS), ("src", _P * MAX_COLS),
         ("ts", _P), ("valid", _P), ("new_ts", _P), ("slots", _P),
         ("row_valid", _P), ("win", _P), ("kill", _P)])


def write(cols, ts, valid, win, new_cols, new_ts, slots, row_valid) -> None:
    """Scatter the valid batch rows into their slots, in place.  `cols`,
    `ts` (i64) and `valid` (bool) are the table's [C] tensors, `win` its
    int32[C] scratch (all -1), `new_cols` / `new_ts` / `slots` (i32) /
    `row_valid` (bool) the batch's [B] tensors."""
    if ts.is_cuda:
        launch_write(cols, ts, valid, win, new_cols, new_ts, slots,
                     row_valid)
    else:
        plain_write(cols, ts, valid, new_cols, new_ts, slots, row_valid)


def masked_delete(valid, kill) -> None:
    """valid &= ~kill over the table's [C] rows, in place."""
    if valid.is_cuda:
        launch_delete(valid, kill)
    else:
        plain_delete(valid, kill)


def plain_write(cols, ts, valid, new_cols, new_ts, slots, row_valid) -> None:
    """The plain PyTorch version of the write (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    C = ts.shape[0]
    s = slots.to(torch.int64)
    rows = torch.nonzero(row_valid & (s >= 0) & (s < C)).flatten()
    tgt = s[rows]
    # the last row of the batch wins a slot that several rows share
    win = torch.full((C,), -1, dtype=torch.int64, device=ts.device)
    win.scatter_reduce_(0, tgt, rows, "amax")
    keep = win[tgt] == rows
    rows, tgt = rows[keep], tgt[keep]
    for c, nc in zip(cols, new_cols):
        c[tgt] = nc[rows].to(c.dtype)
    ts[tgt] = new_ts[rows]
    valid[tgt] = True


def plain_delete(valid, kill) -> None:
    """The plain PyTorch version of the masked delete."""
    global delete_plain_calls
    delete_plain_calls += 1
    valid.logical_and_(kill.logical_not())


def _check(x, what, dtype, n, dev):
    if x.device != dev or x.dtype != dtype or x.dim() != 1 or \
            x.shape[0] != n or not x.is_contiguous():
        raise ValueError(
            f"table_write: {what} must be a contiguous [{n}] {dtype} tensor "
            f"on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device})")


def launch_write(cols, ts, valid, win, new_cols, new_ts, slots,
                 row_valid) -> None:
    """Launch the write on the current stream."""
    global launches
    dev = ts.device
    C, B = ts.shape[0], new_ts.shape[0]
    if len(cols) != len(new_cols) or len(cols) > MAX_COLS:
        raise ValueError("table_write: column counts differ or exceed "
                         f"{MAX_COLS}")
    _check(ts, "ts", torch.int64, C, dev)
    _check(valid, "valid", torch.bool, C, dev)
    _check(win, "win", torch.int32, C, dev)
    _check(new_ts, "new_ts", torch.int64, B, dev)
    _check(slots, "slots", torch.int32, B, dev)
    _check(row_valid, "row_valid", torch.bool, B, dev)
    pl = WritePlan()
    pl.B, pl.C, pl.ncols = B, C, len(cols)
    for j, (c, nc) in enumerate(zip(cols, new_cols)):
        _check(c, f"table column {j}", c.dtype, C, dev)
        _check(nc, f"batch column {j}", nc.dtype, B, dev)
        pl.dst_ty[j], pl.src_ty[j] = _DTYPE_CODE[c.dtype], \
            _DTYPE_CODE[nc.dtype]
        pl.dst[j], pl.src[j] = c.data_ptr(), nc.data_ptr()
    pl.ts, pl.valid, pl.win = ts.data_ptr(), valid.data_ptr(), \
        win.data_ptr()
    pl.new_ts, pl.slots = new_ts.data_ptr(), slots.data_ptr()
    pl.row_valid = row_valid.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("table_write", "siddhi_table_write",
                      "siddhi_write_plan_size", pl, stream)
    launches += 1


def launch_delete(valid, kill) -> None:
    """Launch the masked delete on the current stream."""
    global delete_launches
    dev = valid.device
    C = valid.shape[0]
    _check(valid, "valid", torch.bool, C, dev)
    _check(kill, "kill", torch.bool, C, dev)
    pl = WritePlan()
    pl.C = C
    pl.valid, pl.kill = valid.data_ptr(), kill.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("table_write", "siddhi_table_delete",
                      "siddhi_write_plan_size", pl, stream)
    delete_launches += 1
