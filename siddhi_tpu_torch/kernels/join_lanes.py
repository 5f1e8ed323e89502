"""Wrapper and plain version of the `join_lanes` CUDA kernel (K6).

The kernel (`siddhi_tpu_torch/csrc/join_lanes.cu`) replaces the JAX
package's `_bucket_lanes` (`siddhi_tpu/core/join.py:775-792`): the
per-bucket candidate lane table of one side of an equi-join, rebuilt from
that side's window every step.  Every row alive in the ring (logical
offset j from the head, which is the reference's buffer position: its
buffers are compacted by add_seq, the rings are kept in add_seq order)
goes to bucket `jslot % nbl`, where `jslot` is the key-slot column the
ring carries last; a bucket's lane holds its rows' offsets ascending, and
C (the ring's capacity) where the lane is empty.  The table is
`[nbl, k]` int32.

The reference slices rows past lane width k away and relies on the host's
`JoinKeyTracker` to have grown k first.  Here both versions count those
rows into `overflow` (the join header's lane-overflow word) and the
runtime raises: a short lane never loses a candidate silently.

`join_lanes` is what the join step calls: CPU tensors run `plain`, CUDA
tensors launch the kernel.  `launches` / `plain_calls` count them;
`reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

launches = 0
plain_calls = 0

_L, _P = ctypes.c_longlong, ctypes.c_void_p
SCAN_BLOCK = 1024


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def join_lanes(jslot, meta, nbl: int, k: int, overflow):
    """The lane table `[nbl, k]` of a ring whose key-slot column is
    `jslot` (i32[C]) and whose `meta` is [head, tail, ...]; the rows past
    lane width k are counted into `overflow` (i64[1], overwritten)."""
    if jslot.is_cuda:
        return launch(jslot, meta, nbl, k, overflow)
    return plain(jslot, meta, nbl, k, overflow)


def plain(jslot, meta, nbl: int, k: int, overflow):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = jslot.device
    C = jslot.shape[0]
    head, tail = (int(x) for x in meta[:2].tolist())
    n = tail - head
    j = torch.arange(n, dtype=torch.int64, device=dev)
    b = torch.remainder(jslot[torch.remainder(head + j, C)].to(torch.int64),
                        nbl)
    sb, order = torch.sort(b, stable=True)
    first = torch.searchsorted(sb, sb, side="left")
    rank = j - first
    keep = rank < k
    lanes = torch.full((nbl, k), C, dtype=torch.int32, device=dev)
    lanes[sb[keep], rank[keep]] = order[keep].to(torch.int32)
    overflow.copy_(torch.logical_not(keep).sum().reshape(1))
    return lanes


class LanePlan(ctypes.Structure):
    """Mirrors `struct LanePlan` in csrc/join_lanes.cu."""
    _fields_ = [("C", _L), ("nbl", _L), ("k", _L), ("jslot", _P),
                ("meta", _P), ("lanes", _P), ("cnt", _P), ("fill", _P),
                ("tmp", _P), ("sums", _P), ("overflow", _P)]


def launch(jslot, meta, nbl: int, k: int, overflow):
    """Launch the table build on the current stream."""
    global launches
    dev = jslot.device
    C = jslot.shape[0]
    for x, d, n in ((jslot, torch.int32, C), (meta, torch.int64, None),
                    (overflow, torch.int64, 1)):
        if x.device != dev or x.dtype != d or not x.is_contiguous() or \
                (n is not None and x.shape[0] != n):
            raise ValueError("join_lanes: an input has the wrong device, "
                             "dtype, shape or layout")
    if nbl <= 0 or k <= 0 or C <= 0:
        raise ValueError("join_lanes: empty table or ring")
    lanes = torch.empty((nbl, k), dtype=torch.int32, device=dev)
    cnt = torch.empty(nbl + 1, dtype=torch.int64, device=dev)
    fill = torch.empty(nbl, dtype=torch.int32, device=dev)
    tmp = torch.empty(C, dtype=torch.int32, device=dev)
    sums = torch.empty((nbl + SCAN_BLOCK) // SCAN_BLOCK + 1,
                       dtype=torch.int64, device=dev)
    pl = LanePlan()
    pl.C, pl.nbl, pl.k = C, nbl, k
    pl.jslot, pl.meta, pl.lanes = jslot.data_ptr(), meta.data_ptr(), \
        lanes.data_ptr()
    pl.cnt, pl.fill, pl.tmp = cnt.data_ptr(), fill.data_ptr(), \
        tmp.data_ptr()
    pl.sums, pl.overflow = sums.data_ptr(), overflow.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("join_lanes", "siddhi_join_lanes",
                      "siddhi_lane_plan_size", pl, stream)
    launches += 1
    return lanes
