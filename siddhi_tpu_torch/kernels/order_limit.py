"""Wrapper and plain version of the `order_limit` CUDA kernel (K13): a
selector's `order by` / `limit` / `offset`.

The kernel (`siddhi_tpu_torch/csrc/order_limit.cu`) replaces the JAX
package's `SelectorExec._order_limit` (`siddhi_tpu/core/selector.py:545`):
stable argsorts by each order-by key, the last key first, DESC by negation
in the key's own dtype (a bool by logical not; an int null wraps to
itself, so it sorts first under DESC), invalid rows last; then the valid
rows ranked by a cumsum and those in [offset, offset + limit) kept.  It
runs over every valid CURRENT and EXPIRED row of the step, before the
output type's cut.  Floats order as the reference's sort does: -0.0 equal
to +0.0 and every NaN after +inf.  A STRING key orders by interned id.

Only valid rows are delivered and the reference sorts invalid rows last,
so both versions compact the valid rows first and order those: the
output's first rows are the kept rows in order, the rest invalid and zero.
Its capacity is the input's, or the limit where that is smaller.  The
plain version is the reference's loop of `torch.argsort(stable=True)`.

`order_limit` is what the selector calls: CPU tensors run `plain`, CUDA
tensors launch the kernel.  `launches` / `plain_calls` count them;
`reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _nvcc

launches = 0
plain_calls = 0

MAX_COLS = 16
BLOCK, TILE, RADIX, SCAN_BLOCK = 256, 2048, 256, 1024
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_KEY_TY = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.bool: 3}


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def out_capacity(n: int, limit: Optional[int]) -> int:
    return n if limit is None else min(n, limit)


def order_limit(keys: Sequence[Tuple[torch.Tensor, bool]], lo: int,
                limit: Optional[int], ts, kind, valid, cols):
    """`keys`: (column, desc) per order-by key, in order-by order.
    Returns (ts, kind, valid, cols) with the kept rows first, in order."""
    if ts.is_cuda:
        return launch(keys, lo, limit, ts, kind, valid, cols)
    return plain(keys, lo, limit, ts, kind, valid, cols)


def plain(keys, lo: int, limit: Optional[int], ts, kind, valid, cols):
    """The plain PyTorch version (the kernel's reference)."""
    global plain_calls
    plain_calls += 1
    dev = ts.device
    idx = torch.nonzero(valid).flatten()
    for col, desc in reversed(list(keys)):
        k = col[idx]
        if desc:
            k = torch.logical_not(k) if k.dtype == torch.bool else -k
        if k.dtype == torch.bool:
            k = k.to(torch.int32)
        idx = idx[torch.argsort(k, stable=True)]
    kept = idx[lo:] if limit is None else idx[lo:lo + limit]
    cap = out_capacity(ts.shape[0], limit)
    m = kept.shape[0]

    def out(x):
        o = torch.zeros((cap,), dtype=x.dtype, device=dev)
        o[:m] = x[kept]
        return o
    ovalid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    ovalid[:m] = True
    return out(ts), out(kind), ovalid, tuple(out(c) for c in cols)


class OrderPlan(ctypes.Structure):
    """Mirrors `struct OrderPlan` in csrc/order_limit.cu."""
    _fields_ = (
        [(n, _L) for n in ("N", "cap", "lo", "limit")] +
        [("ncols", _I), ("pad", _I), ("col_bytes", _I * MAX_COLS),
         ("ts", _P), ("kind", _P), ("valid", _P), ("col", _P * MAX_COLS),
         ("flags", _P), ("block_sums", _P), ("idx", _P * 2), ("key", _P * 2),
         ("hist", _P), ("hist_sums", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_col", _P * MAX_COLS)])


def launch(keys, lo: int, limit: Optional[int], ts, kind, valid, cols):
    global launches
    dev = ts.device
    N = int(ts.shape[0])
    cap = out_capacity(N, limit)
    if len(cols) > MAX_COLS:
        raise ValueError("order_limit: column count")
    for x, d in ((ts, torch.int64), (kind, torch.int32),
                 (valid, torch.bool)):
        if x.dtype != d or x.device != dev or x.shape[0] != N or \
                not x.is_contiguous():
            raise ValueError("order_limit: row dtype, device or shape")

    def e(d, n):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    cols = [c.contiguous() for c in cols]
    out_ts, out_kind, out_valid = e(torch.int64, cap), e(torch.int32, cap), \
        e(torch.bool, cap)
    out_cols = [e(c.dtype, cap) for c in cols]
    if N == 0:
        return out_ts[:0], out_kind[:0], out_valid[:0], \
            tuple(c[:0] for c in out_cols)
    pl = OrderPlan()
    pl.N, pl.cap, pl.lo = N, cap, int(lo)
    pl.limit = -1 if limit is None else int(limit)
    pl.ncols = len(cols)
    for j, (c, o) in enumerate(zip(cols, out_cols)):
        if c.shape[0] != N or c.device != dev:
            raise ValueError("order_limit: column shape or device")
        pl.col_bytes[j] = c.element_size()
        pl.col[j], pl.out_col[j] = c.data_ptr(), o.data_ptr()
    nb = (N + BLOCK - 1) // BLOCK
    tiles = (N + TILE - 1) // TILE
    flags = e(torch.uint8, N)
    block_sums = e(torch.int64, nb + 1)
    idx = [e(torch.int32, N) for _ in range(2)]
    key = [e(torch.int64, N) for _ in range(2)]
    hist = e(torch.int64, RADIX * tiles)
    hist_sums = e(torch.int64, (RADIX * tiles + SCAN_BLOCK - 1) //
                  SCAN_BLOCK + 1)
    pl.ts, pl.kind, pl.valid = ts.data_ptr(), kind.data_ptr(), \
        valid.data_ptr()
    pl.flags, pl.block_sums = flags.data_ptr(), block_sums.data_ptr()
    for b in range(2):
        pl.idx[b], pl.key[b] = idx[b].data_ptr(), key[b].data_ptr()
    pl.hist, pl.hist_sums = hist.data_ptr(), hist_sums.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    # the keys, the last order-by key first (the reference's loop)
    kcols: List[torch.Tensor] = []
    for col, desc in reversed(list(keys)):
        if col.dtype not in _KEY_TY or col.shape[0] != N or \
                col.device != dev:
            raise ValueError(f"order_limit: key column {col.dtype} "
                             f"{tuple(col.shape)}")
        kcols.append((col.contiguous(), desc))
    nk = len(kcols)
    kp = (_P * max(nk, 1))(*[c.data_ptr() for c, _ in kcols])
    kt = (_I * max(nk, 1))(*[_KEY_TY[c.dtype] for c, _ in kcols])
    kd = (_I * max(nk, 1))(*[int(bool(d)) for _, d in kcols])
    lib = _nvcc.build("order_limit")
    fn = lib.siddhi_order_limit
    if not getattr(fn, "_siddhi_checked", False):
        fn.restype = _I
        fn.argtypes = [_P, _I, _P, _P, _P, _P]
        size = lib.siddhi_order_plan_size
        size.restype = _I
        if size() != ctypes.sizeof(OrderPlan):
            raise RuntimeError("OrderPlan layout mismatch")
        fn._siddhi_checked = True
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.check_launch(fn(ctypes.byref(pl), nk, kp, kt, kd, stream),
                       "order_limit")
    launches += 1
    del kcols, cols
    return (out_ts[:cap], out_kind[:cap], out_valid[:cap],
            tuple(c[:cap] for c in out_cols))
