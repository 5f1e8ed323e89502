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

The kernel has two modes (`mode`): top-k when a limit is given and
m = offset + limit <= TOPK_MAX (no compaction and no sort: each block keeps
its rows' K least, K the power of two >= m, and one more level or two
reduce the blocks' candidates and write the output), a radix sort of the
compacted valid rows otherwise (`compose` packs consecutive keys into
64-bit words; a word of 32 bits or fewer sorts as a 32-bit key).

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

MAX_COLS, MAX_KEYS = 16, 16
MAX_PASSES = 8 * MAX_KEYS
BLOCK, RADIX = 256, 256
# top-k mode: m = offset + limit at most TOPK_MAX; TK_T items a block holds;
# at most TK_GRID blocks read the rows; a level of candidates above
# TK_LEVEL items takes one more level of blocks
TOPK_MAX, TK_T, TK_GRID = 256, 4096, 256
TK_LEVEL = 4 * TK_T
# sort mode: keys a pass tile
PTILE = 2048
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_KEY_TY = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.bool: 3}
_KEY_BITS = {torch.int32: 32, torch.int64: 64, torch.float32: 32,
             torch.bool: 1}


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


def mode(n: int, lo: int, limit: Optional[int]) -> Tuple[str, int]:
    """The kernel's mode for n rows: ("topk", K) when a limit is given and
    m = lo + limit <= TOPK_MAX (K the power of two >= m), else
    ("sort", 0); ("none", 0) when the output is empty."""
    if n <= 0 or out_capacity(n, limit) == 0:
        return "none", 0
    if limit is not None and lo + limit <= TOPK_MAX:
        return "topk", 1 << max(lo + limit - 1, 0).bit_length()
    return "sort", 0


def topk_grids(n: int, K: int) -> Tuple[int, int]:
    """Top-k mode's blocks: those that read the n rows, and those of the
    level after them (1 when it is the last)."""
    g1 = min(TK_GRID, max(1, -(-n // TK_T)))
    return g1, max(1, -(-(g1 * K) // TK_LEVEL))


def compose(dtypes) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Each key's (word, shift) and each word's width: consecutive keys
    share a 64-bit word while their widths fit, the first the most
    significant."""
    groups: List[List[int]] = []
    width = 0
    for q, d in enumerate(dtypes):
        b = _KEY_BITS[d]
        if groups and width + b <= 64:
            groups[-1].append(q)
            width += b
        else:
            groups.append([q])
            width = b
    where: List[Tuple[int, int]] = [(0, 0)] * len(dtypes)
    bits = []
    for w, qs in enumerate(groups):
        sh = sum(_KEY_BITS[dtypes[q]] for q in qs)
        bits.append(sh)
        for q in qs:
            sh -= _KEY_BITS[dtypes[q]]
            where[q] = (w, sh)
    return where, bits


def passes(bits: Sequence[int]) -> List[Tuple[int, int]]:
    """Sort mode's LSD passes in the order they run: (word, shift), the
    last word first, 8 bits a pass."""
    return [(w, 8 * k) for w in reversed(range(len(bits)))
            for k in range(-(-bits[w] // 8))]


class OrderPlan(ctypes.Structure):
    """Mirrors `struct OrderPlan` in csrc/order_limit.cu."""
    _fields_ = (
        [(n, _L) for n in ("N", "cap", "lo", "limit", "nb", "ptiles")] +
        [(n, _I) for n in ("ncols", "nkeys", "nwords", "npass", "topk_k",
                           "topk_grid1", "topk_grid2")] +
        [("col_bytes", _I * MAX_COLS)] +
        [(n, _I * MAX_KEYS) for n in ("key_ty", "key_desc", "key_word",
                                      "key_shift", "word_pass0", "word_np")] +
        [(n, _I * MAX_PASSES) for n in ("pass_word", "pass_shift",
                                        "pass_wide")] +
        [("key_col", _P * MAX_KEYS), ("ts", _P), ("kind", _P),
         ("valid", _P), ("col", _P * MAX_COLS), ("cand_key", _P * 2),
         ("cand_idx", _P * 2), ("flags", _P), ("block_sums", _P),
         ("idx", _P * 2), ("key", _P * 2), ("ghist", _P), ("status", _P),
         ("tile_ctr", _P), ("zero_bytes", _L), ("pinfo", _P),
         ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
         ("out_col", _P * MAX_COLS)])


def launch(keys, lo: int, limit: Optional[int], ts, kind, valid, cols):
    global launches
    dev = ts.device
    N = int(ts.shape[0])
    cap = out_capacity(N, limit)
    if len(cols) > MAX_COLS or len(keys) > MAX_KEYS:
        raise ValueError("order_limit: column or key count")
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
    md, K = mode(N, lo, limit)
    if md == "none":
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
    kcols: List[torch.Tensor] = []
    for q, (col, desc) in enumerate(keys):
        if col.dtype not in _KEY_TY or col.shape[0] != N or \
                col.device != dev:
            raise ValueError(f"order_limit: key column {col.dtype} "
                             f"{tuple(col.shape)}")
        col = col.contiguous()
        kcols.append(col)
        pl.key_col[q], pl.key_ty[q] = col.data_ptr(), _KEY_TY[col.dtype]
        pl.key_desc[q] = int(bool(desc))
    where, bits = compose([c.dtype for c in kcols])
    pl.nkeys, pl.nwords = len(kcols), len(bits)
    for q, (w, sh) in enumerate(where):
        pl.key_word[q], pl.key_shift[q] = w, sh
    pl.ts, pl.kind, pl.valid = ts.data_ptr(), kind.data_ptr(), \
        valid.data_ptr()
    pl.out_ts, pl.out_kind, pl.out_valid = out_ts.data_ptr(), \
        out_kind.data_ptr(), out_valid.data_ptr()
    if md == "topk":
        g1, g2 = topk_grids(N, K)
        pl.topk_k, pl.topk_grid1, pl.topk_grid2 = K, g1, g2
        cand = [e(torch.int64, g1 * K), e(torch.int64, g2 * K)]
        cidx = [e(torch.int32, g1 * K), e(torch.int32, g2 * K)]
        scratch = (cand, cidx)
        for b in range(2):
            pl.cand_key[b], pl.cand_idx[b] = cand[b].data_ptr(), \
                cidx[b].data_ptr()
    else:
        nb = (N + BLOCK - 1) // BLOCK
        ptiles = (N + PTILE - 1) // PTILE
        ps = passes(bits)
        pl.nb, pl.ptiles, pl.npass = nb, ptiles, len(ps)
        for w in range(len(bits)):
            pl.word_np[w] = -(-bits[w] // 8)
            pl.word_pass0[w] = next(p for p, (pw, _) in enumerate(ps)
                                    if pw == w)
        for p, (w, sh) in enumerate(ps):
            pl.pass_word[p], pl.pass_shift[p] = w, sh
            pl.pass_wide[p] = int(bits[w] > 32)
        flags = e(torch.uint8, N)
        block_sums = e(torch.int64, nb + 1)
        idx = [e(torch.int32, N) for _ in range(2)]
        key = [e(torch.int64, N) for _ in range(2)]
        # the digit counts, the look-back words and the tile counters: one
        # span the launch zeroes
        nzero = len(ps) * RADIX * (1 + ptiles) + len(ps)
        zero = e(torch.int64, nzero)
        pinfo = e(torch.int32, 4 * len(ps) + 1)
        scratch = (flags, block_sums, idx, key, zero, pinfo)
        pl.flags, pl.block_sums = flags.data_ptr(), block_sums.data_ptr()
        for b in range(2):
            pl.idx[b], pl.key[b] = idx[b].data_ptr(), key[b].data_ptr()
        pl.ghist = zero.data_ptr()
        pl.status = pl.ghist + 8 * len(ps) * RADIX
        pl.tile_ctr = pl.status + 8 * len(ps) * RADIX * ptiles
        pl.zero_bytes = 8 * nzero
        pl.pinfo = pinfo.data_ptr()
    lib = _nvcc.build("order_limit")
    fn = lib.siddhi_order_limit
    if not getattr(fn, "_siddhi_checked", False):
        fn.restype = _I
        fn.argtypes = [_P, _P]
        size = lib.siddhi_order_plan_size
        size.restype = _I
        if size() != ctypes.sizeof(OrderPlan):
            raise RuntimeError("OrderPlan layout mismatch")
        fn._siddhi_checked = True
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.check_launch(fn(ctypes.byref(pl), stream), "order_limit")
    launches += 1
    del kcols, cols, scratch
    return (out_ts[:cap], out_kind[:cap], out_valid[:cap],
            tuple(c[:cap] for c in out_cols))
