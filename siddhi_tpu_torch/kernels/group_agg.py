"""Wrapper and plain version of the `group_agg` CUDA kernel (K4).

The kernel (`siddhi_tpu_torch/csrc/group_agg.cu`) replaces the JAX
package's `AggregatorBank.process` (`siddhi_tpu/core/selector.py:320`,
with `_segmented_scan` at :61).  Input: the window's rows in seq order, a
sign per row (+1 CURRENT, -1 EXPIRED, 0 otherwise), each row's group slot
(rows without one, -1, take slot 0; a slot must be below K, and both
versions stop on a larger one: torch's index check in the plain version,
a device assert in the kernel) and one contribution column per
accumulator spec.  A row's epoch is the number of valid RESET rows before
it.  For every spec the kernel computes, over the contributing rows (sign
!= 0), the inclusive scan of the spec's op within each (slot, epoch)
segment, in seq order, with the carry `state[slot]` folded into the head
of each epoch-0 segment; and the new state per slot: the value after the
slot's last contributing row of the final epoch, else the spec's identity
if any RESET occurred, else the old value.  A row that contributes nothing
gets the identity: the reference gives it its segment's running value,
which no consumer reads (the selector outputs CURRENT and EXPIRED rows
only, and those always contribute).

Both versions scan each segment strictly left to right, so they agree bit
for bit; the reference's `lax.associative_scan` adds in a tree order, so
float sums agree with it exactly only where every order is exact.

Design: a stable counting sort by slot (tile histograms, a scan of the
(slot, tile) counts, a block-local stable rank) puts each slot's rows
together in seq order; one thread per (slot, epoch) segment then walks it.
The sort's [K] histograms limit it to MAX_SLOTS slots; above that the
contributing rows are compacted in row order and sorted by slot with a
stable LSD radix sort (`csrc/radix.cuh`, one pass per byte of K - 1),
which keeps each slot's rows in seq order, and the same walk follows.
Run mode (`runs=True`) is for rows in which every (slot, epoch) segment is
already one run of consecutive contributing rows (a keyed window's
key-major rows grouped by the partition key alone): the contributing rows
are compacted in row order, with no sort.  The plain version computes the
same function in every mode.

distinctCount's refcount pass (`pair=True`) is this scan over pair slots
(8K of them, so radix mode above 512 group slots); its per-row results
feed the group pass as contributions on the device.

`group_agg_scan` is what the selector calls: CPU tensors run `plain`, CUDA
tensors launch the kernel.  `launches` / `plain_calls` count them, and
`mode_launches` the launches by mode: MODE_PAIR for a refcount pass over
pair slots (whatever its sort), else MODE_SORT, MODE_RUNS or MODE_RADIX;
`reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch

from ..core import event as ev
from . import _nvcc

launches = 0
plain_calls = 0
mode_launches = [0, 0, 0, 0]

MODE_SORT, MODE_RUNS, MODE_RADIX, MODE_PAIR = range(4)

MAX_SPECS, MAX_SLOTS, TILE, SCAN_BLOCK = 16, 4096, 1024, 1024
RADIX, RADIX_TILE = 256, 2048
OP_ADD, OP_MIN, OP_MAX = 0, 1, 2
_DT_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0, 0, 0]


class ScanSpec(NamedTuple):
    """One accumulator column: its op (OP_ADD / OP_MIN / OP_MAX), dtype
    and identity."""
    op: int
    dtype: torch.dtype
    init: object


def _combine(op: int, a, b):
    if op == OP_ADD:
        return a + b
    return torch.minimum(a, b) if op == OP_MIN else torch.maximum(a, b)


def _segmented_scan(vals, segs, op: int):
    """Inclusive scan of `op` within runs of equal `segs` (sorted), each
    run strictly left to right: one step along every run at a time."""
    n = vals.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=vals.device)
    head[1:] = segs[1:] != segs[:-1]
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    offs = torch.arange(n, device=vals.device) - \
        torch.nonzero(head).flatten()[run]
    out = vals.clone()
    for i in range(1, int(offs.max()) + 1 if n else 0):
        p = torch.nonzero(offs == i).flatten()
        out[p] = _combine(op, out[p - 1], out[p])
    return out


def group_agg_scan(specs: Sequence[ScanSpec], state, vals, sign, kind,
                   valid, gslot, runs: bool = False, pair: bool = False):
    """(new state per spec [K], running value per spec per row); `pair`
    marks a distinctCount refcount pass (`gslot` are pair slots)."""
    if sign.is_cuda:
        return launch(specs, state, vals, sign, kind, valid, gslot, runs,
                      pair)
    return plain(specs, state, vals, sign, kind, valid, gslot)


def plain(specs: Sequence[ScanSpec], state, vals, sign, kind, valid, gslot):
    """The plain PyTorch version (the kernel's reference): a true segmented
    scan, one step along every segment at a time."""
    global plain_calls
    plain_calls += 1
    dev = sign.device
    is_reset = torch.logical_and(valid, kind == ev.RESET).to(torch.int64)
    epoch = torch.cumsum(is_reset, 0) - is_reset
    total = int(is_reset.sum())
    rows = torch.nonzero(sign != 0).flatten()      # contributing rows
    slot = torch.where(gslot >= 0, gslot, 0).to(torch.int64)[rows]
    # segment id: (slot, epoch), as the reference keys its sort
    seg = slot * (sign.shape[0] + 2) + epoch[rows]
    order = torch.argsort(seg, stable=True)
    rows, s_slot, seg = rows[order], slot[order], seg[order]
    head = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    head[1:] = seg[1:] != seg[:-1]
    final = epoch[rows] == total
    last_of_final = final.clone()
    last_of_final[:-1] &= s_slot[1:] != s_slot[:-1]
    carry = torch.logical_and(head, epoch[rows] == 0)
    new_state, results = [], []
    for spec, st, v in zip(specs, state, vals):
        v_s = v[rows]
        v_s = torch.where(carry, _combine(spec.op, st[s_slot], v_s), v_s)
        v_s = _segmented_scan(v_s, seg, spec.op)
        res = torch.full_like(v, spec.init)
        res[rows] = v_s
        results.append(res)
        ns = torch.full_like(st, spec.init) if total else st.clone()
        ns[s_slot[last_of_final]] = v_s[last_of_final]
        new_state.append(ns)
    return tuple(new_state), tuple(results)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class AggPlan(ctypes.Structure):
    """Mirrors `struct AggPlan` in csrc/group_agg.cu."""
    _fields_ = (
        [("B", _L), ("K", _L), ("nspec", _I), ("ntiles", _I),
         ("op", _I * MAX_SPECS), ("dt", _I * MAX_SPECS),
         ("init", _L * MAX_SPECS),
         ("sign", _P), ("kind", _P), ("valid", _P), ("gslot", _P),
         ("vals", _P * MAX_SPECS), ("state", _P * MAX_SPECS),
         ("new_state", _P * MAX_SPECS), ("res", _P * MAX_SPECS),
         ("hist", _P), ("hist_sums", _P), ("tile_resets", _P),
         ("perm", _P), ("s_slot", _P), ("s_epoch", _P),
         ("r_perm", _P), ("r_slot", _P), ("r_epoch", _P),
         ("r_key", _P * 2), ("r_idx", _P * 2), ("r_hist", _P),
         ("r_hist_sums", _P)])


def launch(specs: Sequence[ScanSpec], state, vals, sign, kind, valid,
           gslot, runs: bool = False, pair: bool = False):
    """Run mode when `runs`, else the counting sort up to MAX_SLOTS
    slots and the radix sort above."""
    global launches
    dev = sign.device
    B = sign.shape[0]
    if len(specs) > MAX_SPECS:
        raise NotImplementedError(
            f"group_agg takes at most {MAX_SPECS} accumulator columns")
    for x, d, name in ((sign, torch.int32, "sign"), (kind, torch.int32,
                                                      "kind"),
                       (valid, torch.bool, "valid"),
                       (gslot, torch.int32, "gslot")):
        if x.device != dev or x.dtype != d or x.shape != (B,) or \
                not x.is_contiguous():
            raise ValueError(f"group_agg: {name} must be a contiguous [{B}] "
                             f"{d} tensor on {dev}")
    K = state[0].shape[0] if state else 1
    radix = not runs and K > MAX_SLOTS
    pl = AggPlan()
    pl.B, pl.K, pl.nspec = B, K, len(specs)
    ntiles = max(1, (B + TILE - 1) // TILE)
    pl.ntiles = ntiles
    new_state: List[torch.Tensor] = []
    results: List[torch.Tensor] = []
    for j, (spec, st, v) in enumerate(zip(specs, state, vals)):
        if v.dtype != spec.dtype or st.dtype != spec.dtype or \
                v.shape != (B,) or st.shape != (K,) or v.device != dev or \
                not v.is_contiguous() or not st.is_contiguous():
            raise ValueError(f"group_agg: spec {j} value or state tensor")
        pl.op[j], pl.dt[j] = spec.op, _DT_CODE[spec.dtype]
        pl.init[j] = _nvcc.slot_bits(spec.init, spec.dtype)
        ns = torch.empty(K, dtype=spec.dtype, device=dev)
        r = torch.empty(max(B, 1), dtype=spec.dtype, device=dev)
        new_state.append(ns)
        results.append(r[:B])
        pl.vals[j], pl.state[j] = v.data_ptr(), st.data_ptr()
        pl.new_state[j], pl.res[j] = ns.data_ptr(), r.data_ptr()
    def e(n, d=torch.int32):
        return torch.empty(max(n, 1), dtype=d, device=dev)
    nh = ntiles + 1 if runs or radix else K * ntiles
    hist = e(nh, torch.int64)
    hist_sums = e((nh + SCAN_BLOCK - 1) // SCAN_BLOCK + 1, torch.int64)
    tile_resets = e(ntiles + 1, torch.int64)
    perm, s_slot, s_epoch = e(B), e(B), e(B)
    pl.sign, pl.kind, pl.valid, pl.gslot = sign.data_ptr(), \
        kind.data_ptr(), valid.data_ptr(), gslot.data_ptr()
    pl.hist, pl.hist_sums = hist.data_ptr(), hist_sums.data_ptr()
    pl.tile_resets = tile_resets.data_ptr()
    pl.perm, pl.s_slot, pl.s_epoch = perm.data_ptr(), s_slot.data_ptr(), \
        s_epoch.data_ptr()
    held = []
    if radix:
        rtiles = (B + RADIX_TILE - 1) // RADIX_TILE
        held = [e(B), e(B), e(B), e(B, torch.int64), e(B, torch.int64),
                e(B), e(B), e(RADIX * rtiles, torch.int64),
                e((RADIX * rtiles + SCAN_BLOCK - 1) // SCAN_BLOCK + 1,
                  torch.int64)]
        (pl.r_perm, pl.r_slot, pl.r_epoch, pl.r_key[0], pl.r_key[1],
         pl.r_idx[0], pl.r_idx[1], pl.r_hist, pl.r_hist_sums) = \
            (x.data_ptr() for x in held)
    entry = "siddhi_group_agg_runs" if runs else \
        "siddhi_group_agg_radix" if radix else "siddhi_group_agg"
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("group_agg", entry, "siddhi_agg_plan_size", pl, stream)
    launches += 1
    mode_launches[MODE_PAIR if pair else MODE_RUNS if runs else
                  MODE_RADIX if radix else MODE_SORT] += 1
    del held
    return tuple(new_state), tuple(results)
