"""Wrapper and plain version of the `in_probe` CUDA kernel (K14): the
`x in Table` probe.

The reference (`siddhi_tpu/core/planner.py` `_probe_env`, its copy in
`kstep`, `siddhi_tpu/core/pattern.py` `PatternExec._build_env` and the
block step's `probe_env` in `pattern_block.py`) computes, for each operand
value v, `any(v == col0[c] & valid[c])` over the table's C rows as one
dense compare, broadcasting over the operand's shape ([B] in plain
queries, [P, K] in the pattern slab).  The compare promotes the operand
and the column as the executor's comparisons do
(`core.executor.compare_dtype`); NaN equals nothing, -0.0 equals +0.0, and
an in-band null is a value like any other.

On CUDA the kernel (`csrc/in_probe.cu`) builds an open-addressing hash set
of the valid rows' first-column values in the probe's compare type, once
per table version (`TableRuntime.version`, bumped by every write, delete
and update), and each probe is a lookup: `OP_IN` inside the filter kernels
(K1, K11, `pattern_step`, K8; `device_sets` fills their plans) or the
lookup launch of `probe` for a probe the torch projection evaluates.  The
plain version is the reference's dense compare, chunked over the operand
so that no [b, C] block exceeds 256 MB; it is what the CPU runs.

`launches` counts the kernel's launches (builds and lookups, each one),
`plain_calls` calls of the plain version; `reset_counts()` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from ..core.executor import compare_dtype
from . import _nvcc
from .filter_bytecode import _DTYPE_CODE

launches = 0
plain_calls = 0

MAX_IN = 4                       # sets one kernel plan carries (bytecode.cuh)
CHUNK_BYTES = 256 << 20          # the plain compare's largest [b, C] block
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class InSet(ctypes.Structure):
    """Mirrors `struct InSet` in csrc/bytecode.cuh."""
    _fields_ = [("slots", _P), ("has_empty", _P), ("mask", _L)]


class InTab:
    """What a probe of one table sees at one step: the table's first
    column and valid flags as they stand (the reference's `in_probe_tables`
    snapshot), and on CUDA the table's hash sets, one per compare type."""

    __slots__ = ("table", "col0", "valid")

    def __init__(self, table):
        self.table = table
        self.col0 = table.cols[0]
        self.valid = table.valid


def plain(vals: torch.Tensor, col0: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """The reference's dense compare, chunked over the operand: bool of
    vals' shape."""
    global plain_calls
    plain_calls += 1
    ct = compare_dtype(vals.dtype, col0.dtype)
    v = vals.reshape(-1).to(ct)
    t = col0.to(ct)
    C = max(int(t.shape[0]), 1)
    rows = max(1, CHUNK_BYTES // C)
    out = torch.empty(v.shape[0], dtype=torch.bool, device=v.device)
    for lo in range(0, v.shape[0], rows):
        blk = v[lo:lo + rows, None] == t[None, :]
        out[lo:lo + rows] = torch.any(blk & valid[None, :], dim=1)
    return out.reshape(vals.shape)


def compare_code(val_dtype: torch.dtype, col_dtype: torch.dtype) -> int:
    """The bytecode type code of the probe's compare type."""
    return _DTYPE_CODE[compare_dtype(val_dtype, col_dtype)]


class _Set:
    """One table's hash set under one compare type."""

    __slots__ = ("slots", "has_empty", "version")

    def __init__(self, nslots: int, dev):
        self.slots = torch.empty(nslots, dtype=torch.int64, device=dev)
        self.has_empty = torch.empty(1, dtype=torch.int32, device=dev)
        self.version = -1


def _nslots(C: int) -> int:
    n = 2
    while n < 2 * max(C, 1):
        n <<= 1
    return n


def device_set(tab: InTab, ct: int) -> _Set:
    """The table's hash set under compare type `ct`, rebuilt (one build
    launch) when the table changed since it was built."""
    global launches
    table = tab.table
    sets: Dict[int, _Set] = table.in_sets
    s = sets.get(ct)
    dev = tab.col0.device
    C = int(tab.col0.shape[0])
    if s is None:
        s = sets[ct] = _Set(_nslots(C), dev)
    if s.version == table.version:
        return s
    col = tab.col0
    if col.dtype == torch.bool:
        col = col.to(torch.int32)
    col_ty = _DTYPE_CODE[col.dtype]
    lib = _nvcc.build("in_probe")
    fn = lib.siddhi_in_build
    fn.restype = _I
    fn.argtypes = [_P, _I, _P, _L, _I, _P, _L, _P, _P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.check_launch(fn(col.data_ptr(), col_ty, tab.valid.data_ptr(), C,
                          ct, s.slots.data_ptr(), s.slots.shape[0],
                          s.has_empty.data_ptr(), stream), "in_probe build")
    launches += 1
    s.version = table.version
    del col
    return s


def fill_sets(dst, in_keys: List[Tuple[str, int]],
              in_tabs: Dict[str, InTab]) -> list:
    """Fill a kernel plan's InSet array for the (table, compare type)
    pairs its bytecode's OP_IN words index; returns the sets, which must
    stay referenced until the launch is queued."""
    if len(in_keys) > MAX_IN:
        raise NotImplementedError(
            f"the filters probe {len(in_keys)} (table, type) pairs; the "
            f"kernels take {MAX_IN}")
    held = []
    for j, (dep, ct) in enumerate(in_keys):
        s = device_set(in_tabs[dep], ct)
        dst[j].slots = s.slots.data_ptr()
        dst[j].has_empty = s.has_empty.data_ptr()
        dst[j].mask = s.slots.shape[0] - 1
        held.append(s)
    return held


def lookup(vals: torch.Tensor, tab: InTab) -> torch.Tensor:
    """The lookup launch: bool of vals' shape."""
    global launches
    ct = compare_code(vals.dtype, tab.col0.dtype)
    s = device_set(tab, ct)
    v = vals.reshape(-1)
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    v = v.contiguous()
    out = torch.empty(v.shape[0], dtype=torch.bool, device=v.device)
    lib = _nvcc.build("in_probe")
    fn = lib.siddhi_in_lookup
    fn.restype = _I
    fn.argtypes = [_P, _I, _L, _I, _P, _L, _P, _P, _P]
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _nvcc.check_launch(fn(v.data_ptr(), _DTYPE_CODE[v.dtype], v.shape[0], ct,
                          s.slots.data_ptr(), s.slots.shape[0],
                          s.has_empty.data_ptr(), out.data_ptr(), stream),
                       "in_probe lookup")
    launches += 1
    return out.reshape(vals.shape)


def probe(vals: torch.Tensor, tab: InTab) -> torch.Tensor:
    """`vals in table`: the plain compare on the CPU, the kernel on CUDA."""
    if vals.is_cuda:
        return lookup(vals, tab)
    return plain(vals, tab.col0, tab.valid)


def probe_env(in_tabs: Dict[str, InTab]) -> Dict[str, object]:
    """`__in__:<table>` probe closures for a compiled expression's env
    (`core.executor` compiles `x in T` to a call of one)."""
    return {"__in__:" + dep: (lambda vals, _t=tab: probe(vals, _t))
            for dep, tab in in_tabs.items()}
