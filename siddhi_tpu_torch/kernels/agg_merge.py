"""Wrapper and plain version of the `agg_merge` CUDA kernel (K28).

The kernel (`siddhi_tpu_torch/csrc/agg_merge.cu`) replaces the JAX
package's incremental-aggregation `merge` (`siddhi_tpu/core/
aggregation.py:510-525`), one launch for all D durations of a send: the
batch's base values vals f64 [n_base, B] merge into each duration's slab,
slabs f64 [D, n_base, capacity], at the host's slots i32 [D, B]; slot -1
drops the row (the reference's `mode="drop"`).  Each base merges by its
kind: add, min or max (XLA's: NaN wins, -0.0 is below +0.0).

Sum order.  XLA's CPU scatter applies a slot's updates in row order, so a
slot's sum is `((s + v0) + v1) + ...`; f64 addition is not associative,
so atomics cannot reproduce it.  The kernel compacts the (duration, row)
pairs that have a slot, sorts them by (duration, slot) with the stable LSD
radix sort of `csrc/radix.cuh` (so a slot's rows stay in row order), and
one thread per (duration, slot) segment walks its rows in order for every
base.  The plain version is order-fixed by construction: it sorts the
rows by slot (stable) and adds the k-th row of every segment in round k,
each round a gather and a scatter over distinct slots; it relies on no
`index_add_` / `scatter_reduce_` order.

`agg_merge` is what `AggregationRuntime.process_staged` calls: CPU
tensors run `plain`, CUDA tensors launch the kernel.  Both update the
slabs in place.  `launches` / `plain_calls` count them; `reset_counts()`
sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _nvcc

launches = 0
plain_calls = 0

MAX_BASE = 16
KIND_CODE = {"sum": 0, "count": 0, "min": 1, "max": 2}
RADIX, RADIX_TILE, SCAN_BLOCK = 256, 2048, 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def agg_merge(slabs: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor,
              kinds: Sequence[str]) -> None:
    """Merge vals [n_base, B] into slabs [D, n_base, cap] at slots [D, B]
    in place; `kinds` names each base's merge ('sum', 'count', 'min',
    'max')."""
    if slabs.is_cuda:
        launch(slabs, slots, vals, kinds)
    else:
        plain(slabs, slots, vals, kinds)


def xla_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min as XLA computes it: NaN if either is NaN; of -0.0 and +0.0 the
    -0.0."""
    take_b = (b < a) | ((b == a) & torch.signbit(b)) | torch.isnan(b)
    return torch.where(take_b & ~torch.isnan(a), b, a)


def xla_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max as XLA computes it: NaN if either is NaN; of -0.0 and +0.0 the
    +0.0."""
    take_b = (b > a) | ((b == a) & torch.signbit(a)) | torch.isnan(b)
    return torch.where(take_b & ~torch.isnan(a), b, a)


def plain(slabs: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor,
          kinds: Sequence[str]) -> None:
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    codes = torch.tensor([KIND_CODE[k] for k in kinds],
                         device=vals.device)[:, None]
    for d in range(slabs.shape[0]):
        s = slots[d].to(torch.int64)
        rows = torch.nonzero(s >= 0).flatten()
        if rows.numel() == 0:
            continue
        rows = rows[torch.argsort(s[rows], stable=True)]
        keys = s[rows]
        head = torch.ones_like(keys, dtype=torch.bool)
        head[1:] = keys[1:] != keys[:-1]
        seg = torch.cumsum(head.to(torch.int64), 0) - 1
        starts = torch.nonzero(head).flatten()
        rank = torch.arange(keys.numel(), device=keys.device) - starts[seg]
        uniq = keys[starts]
        acc = slabs[d][:, uniq]
        for r in range(int(rank.max()) + 1):
            m = rank == r
            sg, rr = seg[m], rows[m]
            a, v = acc[:, sg], vals[:, rr]
            acc[:, sg] = torch.where(codes == 0, a + v, torch.where(
                codes == 1, xla_min(a, v), xla_max(a, v)))
        slabs[d][:, uniq] = acc


class MergePlan(ctypes.Structure):
    """Mirrors `struct MergePlan` in csrc/agg_merge.cu."""
    _fields_ = (
        [("B", _L), ("cap", _L), ("D", _I), ("nbase", _I), ("bits", _I),
         ("pad", _I), ("kind", _I * MAX_BASE),
         ("slots", _P), ("vals", _P), ("slab", _P),
         ("flags", _P), ("sums", _P), ("key", _P * 2), ("idx", _P * 2),
         ("hist", _P), ("hist_sums", _P)])


def launch(slabs: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor,
           kinds: Sequence[str]) -> None:
    global launches
    dev = slabs.device
    D, nb, cap = slabs.shape
    B = int(vals.shape[1])
    if len(kinds) != nb or nb > MAX_BASE or tuple(vals.shape) != (nb, B):
        raise ValueError("agg_merge: vals / kinds do not match the slabs")
    for x, d, shape, name in ((slabs, torch.float64, (D, nb, cap), "slabs"),
                              (slots, torch.int32, (D, B), "slots"),
                              (vals, torch.float64, (nb, B), "vals")):
        if x.device != dev or x.dtype != d or tuple(x.shape) != shape or \
                not x.is_contiguous():
            raise ValueError(f"agg_merge: {name} must be a contiguous "
                             f"{list(shape)} {d} tensor on {dev}")
    n = D * B
    if n == 0:
        return
    tiles = (n + RADIX_TILE - 1) // RADIX_TILE
    pl = MergePlan()
    pl.B, pl.cap, pl.D, pl.nbase = B, cap, D, nb
    pl.bits = max(1, (D * cap - 1).bit_length())
    for b, k in enumerate(kinds):
        pl.kind[b] = KIND_CODE[k]
    flags = torch.empty(n, dtype=torch.int64, device=dev)
    sums = torch.empty((n + SCAN_BLOCK - 1) // SCAN_BLOCK + 1,
                       dtype=torch.int64, device=dev)
    keys = torch.empty((2, n), dtype=torch.int64, device=dev)
    idx = torch.empty((2, n), dtype=torch.int32, device=dev)
    hist = torch.empty(RADIX * tiles, dtype=torch.int64, device=dev)
    hist_sums = torch.empty((RADIX * tiles + SCAN_BLOCK - 1) // SCAN_BLOCK
                            + 1, dtype=torch.int64, device=dev)
    pl.slots, pl.vals, pl.slab = slots.data_ptr(), vals.data_ptr(), \
        slabs.data_ptr()
    pl.flags, pl.sums = flags.data_ptr(), sums.data_ptr()
    pl.key[0], pl.key[1] = keys[0].data_ptr(), keys[1].data_ptr()
    pl.idx[0], pl.idx[1] = idx[0].data_ptr(), idx[1].data_ptr()
    pl.hist, pl.hist_sums = hist.data_ptr(), hist_sums.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("agg_merge", "siddhi_agg_merge",
                      "siddhi_agg_merge_plan_size", pl, stream)
    launches += 1
