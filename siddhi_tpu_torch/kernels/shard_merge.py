"""Wrapper, build and plain version of the `shard_merge` CUDA kernel (K32):
the one-card form of the psum / pmin that combine a mesh-sharded step's
shards.

The kernel (`siddhi_tpu_torch/csrc/shard_merge.cu`) replaces the
collectives of the JAX package's shard_map bodies:

- `merge_rows`: `_merge_rows` (`siddhi_tpu/core/planner.py:141-148`), the
  sum over shards of `where(ovalid, col, 0)` for each output column (bools
  as an int32 sum > 0) and of the valid flags.  The shards' rows are
  either aligned (row r of every shard) or compacted with their merged
  positions (`pos`, kernel K31's place mode).  On two or more shards an
  owned -0.0 comes out +0.0, as the owner's value plus the other shards'
  zeros does;
- `merge_delta`: the keyed step's `dmerge` (`:242-254`), `old + sum_d
  where(new_d != old, new_d - old, 0)` in the element's type (bools
  through int32), and unmasked, `old + sum_d (new_d - old)`, the pattern
  path's scalar counters (`siddhi_tpu/core/pattern_planner.py:520-523`)
  and the NoWindow seq counter (`planner.py:209-212`);
- `merge_header`: the psum of the step headers and the pmin of the wakes.

Inputs may lie on the shards' own devices; the combine runs on the first
shard's device, and the inputs from other devices are copied there first.
Given CPU tensors each function runs its plain PyTorch version; given
CUDA tensors it launches the kernel.  `launches` counts launches and
`mode_launches` them by mode (rows, delta, header), `plain_calls` calls of
the plain versions; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _nvcc

launches = 0
mode_launches = [0, 0, 0]
plain_calls = 0

MAX_SHARDS, MAX_HDR = 16, 8
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_TY = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3,
       torch.bool: 4}


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0, 0]


class MergePlan(ctypes.Structure):
    """Mirrors `struct MergePlan` in csrc/shard_merge.cu."""
    _fields_ = [("n", _I), ("mode", _I), ("ty", _I), ("masked", _I),
                ("hdr_len", _I), ("min_mask", _I), ("R", _L),
                ("rows", _L * MAX_SHARDS), ("src", _P * MAX_SHARDS),
                ("valid", _P * MAX_SHARDS), ("pos", _P * MAX_SHARDS),
                ("old", _P), ("out", _P), ("out_valid", _P)]


def _launch(pl: MergePlan, mode: int, dev) -> None:
    global launches
    if not 1 <= pl.n <= MAX_SHARDS:
        raise ValueError(f"shard_merge: {pl.n} shards (at most "
                         f"{MAX_SHARDS})")
    pl.mode = mode
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("shard_merge", "siddhi_shard_merge",
                      "siddhi_merge_plan_size", pl, stream)
    launches += 1
    mode_launches[mode] += 1


def _on(xs: Sequence[torch.Tensor], dev) -> list:
    """The tensors on `dev`, contiguous (a copy only where they are not)."""
    return [x.to(dev).contiguous() for x in xs]


def _ty(dtype) -> int:
    t = _TY.get(dtype)
    if t is None:
        raise ValueError(f"shard_merge: no merge for {dtype}")
    return t


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def merge_rows(cols: Sequence[Sequence[torch.Tensor]],
               valids: Sequence[torch.Tensor], R: int,
               pos: Optional[Sequence[torch.Tensor]] = None):
    """(merged columns, merged valid [R]) of n shards' rows: `cols[d]` the
    columns of shard d, `valids[d]` its valid flags; aligned ([R] each)
    when `pos` is None, else compacted, shard d's row j going to merged
    row `pos[d][j]`."""
    dev = valids[0].device
    if dev.type != "cuda":
        return plain_merge_rows(cols, valids, R, pos)
    n = len(valids)
    valids = _on(valids, dev)
    pos = None if pos is None else _on(pos, dev)
    ncols = len(cols[0])
    shard_cols = [_on([c[j] for c in cols], dev) for j in range(ncols)]
    # placed rows leave the rows no shard fills zero and invalid
    alloc = torch.empty if pos is None else torch.zeros
    out_valid = alloc(R, dtype=torch.bool, device=dev)
    outs = [alloc(R, dtype=sc[0].dtype, device=dev) for sc in shard_cols]
    for j in range(max(ncols, 1)):
        pl = MergePlan(n=n, R=R)
        for d in range(n):
            pl.valid[d] = valids[d].data_ptr()
            pl.rows[d] = valids[d].shape[0]
            if pos is not None:
                pl.pos[d] = pos[d].data_ptr()
        if ncols:
            pl.ty = _ty(shard_cols[j][0].dtype)
            for d in range(n):
                pl.src[d] = shard_cols[j][d].data_ptr()
            pl.out = outs[j].data_ptr()
        else:
            pl.ty = _ty(torch.bool)
            for d in range(n):
                pl.src[d] = valids[d].data_ptr()
        if j == 0:
            pl.out_valid = out_valid.data_ptr()
        _launch(pl, 0, dev)
    return tuple(outs), out_valid


def plain_merge_rows(cols, valids, R: int, pos=None):
    global plain_calls
    plain_calls += 1
    dev = valids[0].device
    n = len(valids)
    valids = _on(valids, dev)
    ncols = len(cols[0])
    if pos is not None:
        # compacted rows: scatter each shard's rows to its merged rows, so
        # every merged row has one source and the others add their zeros
        pos = _on(pos, dev)
        aligned_v, aligned_c = [], [[] for _ in range(ncols)]
        for d in range(n):
            p = pos[d].long()
            v = torch.zeros(R, dtype=torch.bool, device=dev)
            v[p] = valids[d]
            aligned_v.append(v)
            for j in range(ncols):
                x = cols[d][j].to(dev)
                a = torch.zeros(R, dtype=x.dtype, device=dev)
                a[p] = x
                aligned_c[j].append(a)
        cols = [[aligned_c[j][d] for j in range(ncols)] for d in range(n)]
        valids = aligned_v
    out = []
    for j in range(ncols):
        xs = _on([c[j] for c in cols], dev)
        is_bool = xs[0].dtype == torch.bool
        acc = None
        for d in range(n):
            x = xs[d].to(torch.int32) if is_bool else xs[d]
            t = torch.where(valids[d], x, torch.zeros((), dtype=x.dtype,
                                                      device=dev))
            acc = t if acc is None else acc + t
        out.append(acc > 0 if is_bool else acc)
    vsum = None
    for d in range(n):
        v = valids[d].to(torch.int32)
        vsum = v if vsum is None else vsum + v
    return tuple(out), vsum > 0


# ---------------------------------------------------------------------------
# delta
# ---------------------------------------------------------------------------

def merge_delta(old: torch.Tensor, news: Sequence[torch.Tensor],
                masked: bool = True,
                finite_old: bool = False) -> torch.Tensor:
    """The replicated leaf after a sharded step: `old + sum_d delta_d`,
    delta_d = new_d - old (masked: 0 where new_d == old), in the leaf's
    type; a bool leaf through int32.  With `finite_old` (masked only), a
    changed element whose old value is NaN or +-inf takes the last
    changed copy: the JAX package's dmerge turns a min / max identity
    into NaN there.  A new tensor on `old`'s device."""
    dev = old.device
    if dev.type != "cuda":
        return plain_merge_delta(old, news, masked, finite_old)
    n = len(news)
    oldc = old.contiguous()
    news = _on(news, dev)
    out = torch.empty_like(oldc)
    pl = MergePlan(n=n, R=oldc.numel(), ty=_ty(old.dtype),
                   masked=2 if masked and finite_old else int(masked),
                   old=oldc.data_ptr(),
                   out=out.data_ptr())
    for d in range(n):
        pl.src[d] = news[d].data_ptr()
    if oldc.numel():
        _launch(pl, 1, dev)
    return out


def plain_merge_delta(old, news, masked: bool = True,
                      finite_old: bool = False):
    global plain_calls
    plain_calls += 1
    dev = old.device
    is_bool = old.dtype == torch.bool
    o = old.to(torch.int32) if is_bool else old
    acc, last, changed = None, o, torch.zeros_like(o, dtype=torch.bool)
    for x in _on(news, dev):
        x = x.to(torch.int32) if is_bool else x
        c = x != o
        t = x - o
        if masked:
            t = torch.where(c, t, torch.zeros((), dtype=t.dtype,
                                              device=dev))
        acc = t if acc is None else acc + t
        last = torch.where(c, x, last)
        changed = changed | c
    m = o + acc
    if masked and finite_old:
        m = torch.where(changed & ~torch.isfinite(o), last, m)
    return m != 0 if is_bool else m


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

def merge_header(hdrs: Sequence[torch.Tensor], min_words=()) -> torch.Tensor:
    """The merged step header i64[H] of n shards' headers: each word the
    sum over shards, the words in `min_words` (the wakes) the min."""
    dev = hdrs[0].device
    if dev.type != "cuda":
        return plain_merge_header(hdrs, min_words)
    hdrs = _on([h.to(torch.int64) for h in hdrs], dev)
    H = hdrs[0].numel()
    if H > MAX_HDR:
        raise ValueError(f"shard_merge: a header of {H} words (at most "
                         f"{MAX_HDR})")
    out = torch.empty(H, dtype=torch.int64, device=dev)
    mask = 0
    for w in min_words:
        mask |= 1 << w
    pl = MergePlan(n=len(hdrs), hdr_len=H, min_mask=mask,
                   out=out.data_ptr())
    for d, h in enumerate(hdrs):
        pl.src[d] = h.data_ptr()
    _launch(pl, 2, dev)
    return out


def plain_merge_header(hdrs, min_words=()):
    global plain_calls
    plain_calls += 1
    dev = hdrs[0].device
    st = torch.stack(_on([h.to(torch.int64) for h in hdrs], dev))
    out = st.sum(0)
    for w in min_words:
        out[w] = st[:, w].min()
    return out
