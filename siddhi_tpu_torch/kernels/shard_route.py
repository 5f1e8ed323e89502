"""Wrapper, build and plain version of the `shard_route` CUDA kernel (K31):
each shard's view of a batch on a mesh of n shards.

The kernel (`siddhi_tpu_torch/csrc/shard_route.cu`) replaces the ownership
arithmetic of the JAX package's shard_map bodies
(`siddhi_tpu/core/planner.py:193-195`, `_shard_plain_step`; `:269-270`,
`_shard_keyed_step`), in one launch over the shards:

- `route_plain`: the rows a windowless group-by shard owns, `lvalid[d] =
  valid & (gslot % n == d)`, at local slot `gslot // n` (0 where not
  owned);
- `route_keyed`: the key rows a keyed-window shard owns, `key_l[d] =
  key_idx // n` where `key_idx % n == d` and `key_idx < K`, else the
  shard slab's row count, which every keyed window step drops;
- `place`: where a shard's compacted rows go in the merged, key-row-major
  output, from the shards' per-key-row output counts (the port's keyed
  steps emit exactly their rows, where the JAX package's stay aligned to
  a [Kb, cap] grid).

Given CPU tensors each function runs its plain PyTorch version; given CUDA
tensors it launches the kernel.  `launches` counts launches and
`mode_launches` them by mode (plain, keyed, place), `plain_calls` calls of
the plain versions; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

launches = 0
mode_launches = [0, 0, 0]
plain_calls = 0

MAX_SHARDS = 16
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    mode_launches[:] = [0, 0, 0]


class RoutePlan(ctypes.Structure):
    """Mirrors `struct RoutePlan` in csrc/shard_route.cu."""
    _fields_ = [("B", _L), ("n", _I), ("mode", _I), ("K", _L),
                ("sentinel", _L), ("gslot", _P), ("valid", _P),
                ("lvalid", _P), ("local", _P), ("key_idx", _P),
                ("key_l", _P), ("counts", _P), ("pos", _P)]


def _launch(pl: RoutePlan, mode: int, dev) -> None:
    global launches
    if not 1 <= pl.n <= MAX_SHARDS:
        raise ValueError(f"shard_route: {pl.n} shards (at most "
                         f"{MAX_SHARDS})")
    pl.mode = mode
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("shard_route", "siddhi_shard_route",
                      "siddhi_route_plan_size", pl, stream)
    launches += 1
    mode_launches[mode] += 1


def _check(x, name, dtype, dev):
    if x.dtype != dtype or x.device != dev or not x.is_contiguous():
        raise ValueError(f"shard_route: {name} must be a contiguous "
                         f"{dtype} tensor on {dev}")


# ---------------------------------------------------------------------------
# plain mode
# ---------------------------------------------------------------------------

def route_plain(gslot: torch.Tensor, valid: torch.Tensor, n: int):
    """(lvalid [n, B] bool, local [n, B] int32) of a batch's group slots
    `gslot` [B] int32 and valid flags [B] bool."""
    if not gslot.is_cuda:
        return plain_route_plain(gslot, valid, n)
    dev = gslot.device
    _check(gslot, "gslot", torch.int32, dev)
    _check(valid, "valid", torch.bool, dev)
    B = gslot.shape[0]
    lvalid = torch.empty((n, B), dtype=torch.bool, device=dev)
    local = torch.empty((n, B), dtype=torch.int32, device=dev)
    pl = RoutePlan(B=B, n=n, gslot=gslot.data_ptr(),
                   valid=valid.data_ptr(), lvalid=lvalid.data_ptr(),
                   local=local.data_ptr())
    _launch(pl, 0, dev)
    return lvalid, local


def plain_route_plain(gslot, valid, n: int):
    global plain_calls
    plain_calls += 1
    d = torch.arange(n, device=gslot.device)[:, None]
    g = gslot.to(torch.int64)[None, :]
    owned = torch.remainder(g, n) == d
    lvalid = owned & valid[None, :]
    local = torch.where(owned, torch.div(g, n, rounding_mode="floor"),
                        torch.zeros_like(g)).to(torch.int32)
    return lvalid, local


# ---------------------------------------------------------------------------
# keyed mode
# ---------------------------------------------------------------------------

def route_keyed(key_idx: torch.Tensor, n: int, K: int) -> torch.Tensor:
    """key_l [n, Kb] int32: each shard's local row of the key rows it owns
    in `key_idx` [Kb] int32 (global slots, K for a padding row), the
    sentinel K // n elsewhere."""
    if not key_idx.is_cuda:
        return plain_route_keyed(key_idx, n, K)
    dev = key_idx.device
    _check(key_idx, "key_idx", torch.int32, dev)
    Kb = key_idx.shape[0]
    key_l = torch.empty((n, Kb), dtype=torch.int32, device=dev)
    pl = RoutePlan(B=Kb, n=n, K=K, sentinel=K // n,
                   key_idx=key_idx.data_ptr(), key_l=key_l.data_ptr())
    _launch(pl, 1, dev)
    return key_l


def plain_route_keyed(key_idx, n: int, K: int):
    global plain_calls
    plain_calls += 1
    d = torch.arange(n, device=key_idx.device)[:, None]
    k = key_idx.to(torch.int64)[None, :]
    owned = (torch.remainder(k, n) == d) & (k < K)
    return torch.where(owned, torch.div(k, n, rounding_mode="floor"),
                       torch.full_like(k, K // n)).to(torch.int32)


# ---------------------------------------------------------------------------
# place mode
# ---------------------------------------------------------------------------

def place(counts: torch.Tensor, total: int) -> torch.Tensor:
    """pos [total] int64: the merged row of each shard row, shard after
    shard, from `counts` [n, Kb] int64 (shard d's output rows of key row
    k; at most one shard has rows for a key row).  The merged rows are
    key-row-major, each key row's rows in its shard's order."""
    if not counts.is_cuda:
        return plain_place(counts, total)
    dev = counts.device
    _check(counts, "counts", torch.int64, dev)
    n, Kb = counts.shape
    pos = torch.empty(max(total, 1), dtype=torch.int64, device=dev)
    pl = RoutePlan(B=Kb, n=n, counts=counts.data_ptr(), pos=pos.data_ptr())
    _launch(pl, 2, dev)
    return pos[:total]


def plain_place(counts, total: int):
    global plain_calls
    plain_calls += 1
    n, Kb = counts.shape
    dev = counts.device
    per_key = counts.sum(0)
    g_off = torch.cumsum(per_key, 0) - per_key           # [Kb]
    d_off = torch.cumsum(counts, 1) - counts             # [n, Kb]
    out = []
    ar = torch.arange(Kb, device=dev)
    for d in range(n):
        c = counts[d]
        key = torch.repeat_interleave(ar, c)
        rank = torch.arange(key.shape[0], device=dev) - d_off[d][key]
        out.append(g_off[key] + rank)
    pos = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)
    if pos.shape[0] != total:
        raise ValueError(f"shard_route: the counts hold {pos.shape[0]} "
                         f"rows, not {total}")
    return pos
