"""Wrapper and plain versions of the `ring` CUDA kernels (K30): the
serving loop's emission ring on the card (`serving/ring.py`).

A ring generation holds S slots of one output signature: the header words
([S, H] int64), the valid flags ([S, R] bool) and each row leaf (ts, kind,
the output columns: [S, R] each).  `append` copies one step's output block
into a slot in one launch (the JAX package's `_set`: one update per leaf);
`pack_fetch` packs the valid rows of the m oldest slots into one staging
buffer in one launch and brings the slots' headers and valid counts, then
the packed rows, to the host: two device-to-host transfers a drain round
(the JAX package's `_read` per slot, then a fetch of every slot).

Given CPU tensors both run their plain versions (`append_plain`: one
index copy per leaf; `pack_plain`: the valid rows gathered per leaf);
given CUDA tensors they launch the kernels.

`launches` counts `append` launches, `pack_launches` pack launches,
`d2h_transfers` the device-to-host copies `pack_fetch` made and
`plain_calls` calls of the plain versions; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc

launches = 0
pack_launches = 0
d2h_transfers = 0
plain_calls = 0

MAX_LEAVES = 40
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, pack_launches, d2h_transfers, plain_calls
    launches = pack_launches = d2h_transfers = plain_calls = 0


class AppendPlan(ctypes.Structure):
    """Mirrors `struct AppendPlan` in csrc/ring.cu."""
    _fields_ = [("n", _I), ("slot", _I), ("bytes", _L * MAX_LEAVES),
                ("src", _P * MAX_LEAVES), ("dst", _P * MAX_LEAVES)]


class PackPlan(ctypes.Structure):
    """Mirrors `struct PackPlan` in csrc/ring.cu."""
    _fields_ = [(n, _I) for n in ("n_leaves", "m", "S", "tail", "R", "H",
                                  "row_stride", "nch")] + [
        ("esize", _I * MAX_LEAVES), ("off", _I * MAX_LEAVES),
        ("leaf", _P * MAX_LEAVES), ("valid", _P), ("header", _P),
        ("counts", _P), ("meta", _P), ("packed", _P)]


def block_leaves(block) -> List[torch.Tensor]:
    """The leaves of an output block (header, ts, kind, valid, cols) in
    ring order: header, valid, then the row leaves."""
    header, ts, kind, valid, cols = block
    return [header, valid, ts, kind, *cols]


def alloc(block, slots: int) -> List[torch.Tensor]:
    """[S, ...] zeros for every leaf of `block` (one generation)."""
    return [torch.zeros((slots,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device) for x in block_leaves(block)]


def append(ring: List[torch.Tensor], block, slot: int) -> None:
    """Copy `block` into slot `slot` of `ring` (from `alloc`)."""
    leaves = block_leaves(block)
    if leaves[0].is_cuda:
        launch_append(ring, leaves, slot)
    else:
        append_plain(ring, leaves, slot)


def append_plain(ring, leaves, slot: int) -> None:
    """The plain version: one index copy per leaf."""
    global plain_calls
    plain_calls += 1
    for dst, src in zip(ring, leaves):
        dst[slot].copy_(src)


def launch_append(ring, leaves, slot: int) -> None:
    global launches
    if len(leaves) > MAX_LEAVES:
        raise NotImplementedError(
            f"ring: an output block of {len(leaves)} leaves (the kernel "
            f"takes {MAX_LEAVES})")
    pl = AppendPlan()
    pl.n, pl.slot = len(leaves), int(slot)
    kept = []
    for j, (dst, src) in enumerate(zip(ring, leaves)):
        if not src.is_contiguous():
            src = src.contiguous()
            kept.append(src)
        if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape[1:]):
            raise ValueError("ring: a leaf differs from the ring's "
                             "signature")
        pl.bytes[j] = src.numel() * src.element_size()
        pl.src[j] = src.data_ptr()
        pl.dst[j] = dst.data_ptr()
    stream = torch.cuda.current_stream(leaves[0].device).cuda_stream
    _nvcc.launch_plan("ring", "siddhi_ring_append",
                      "siddhi_ring_append_plan_size", pl, stream)
    launches += 1
    del kept


def _layout(ring) -> Tuple[List[int], int]:
    """Byte offsets of the row leaves in a packed row, and its stride
    (each element aligned to its size, the row to 8 bytes)."""
    offs, o = [], 0
    for t in ring[2:]:
        es = t.element_size()
        o = (o + es - 1) // es * es
        offs.append(o)
        o += es
    return offs, max(8, (o + 7) // 8 * 8)


def pack_fetch(ring, tail: int, m: int, staging=None, after=None):
    """The m oldest slots (from `tail`) on the host: (meta int64 [m, H + 1]
    = each slot's header words and valid-row count, [packed rows of each
    row leaf as numpy, in slot and row order]).  `staging` holds the
    drainer's reusable buffers (`PackStaging`) on CUDA; `after` is the
    CUDA event recorded after the newest of those slots' appends, which
    the pack waits on."""
    if ring[0].is_cuda:
        return launch_pack(ring, tail, m, staging or PackStaging(), after)
    return pack_plain(ring, tail, m)


def pack_plain(ring, tail: int, m: int):
    """The plain version: each slot's valid rows gathered per leaf."""
    global plain_calls
    plain_calls += 1
    header, valid, rows = ring[0], ring[1], ring[2:]
    S = header.shape[0]
    meta, parts = [], [[] for _ in rows]
    for j in range(m):
        slot = (tail + j) % S
        idx = torch.nonzero(valid[slot]).reshape(-1)
        meta.append(torch.cat([header[slot],
                               idx.numel() * torch.ones(1, dtype=torch.int64,
                                                        device=idx.device)]))
        for p, leaf in zip(parts, rows):
            p.append(leaf[slot][idx])
    return (torch.stack(meta).cpu().numpy(),
            [torch.cat(p).cpu().numpy() for p in parts])


class PackStaging:
    """A drainer's reusable buffers: the packed rows on the card, their
    pinned host copy, the meta words on the card and pinned, and the
    drainer's own stream."""

    def __init__(self):
        self.dev_packed = self.host_packed = None
        self.dev_meta = self.host_meta = None
        self.counts = None
        self.stream = None

    def get(self, device, meta_words: int, packed_bytes: int,
            count_words: int = 1):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        if self.counts is None or self.counts.numel() < count_words:
            self.counts = torch.empty(max(count_words, 1024),
                                      dtype=torch.int64, device=device)
        if self.dev_meta is None or self.dev_meta.numel() < meta_words:
            n = max(meta_words, 256)
            self.dev_meta = torch.empty(n, dtype=torch.int64, device=device)
            self.host_meta = torch.empty(n, dtype=torch.int64,
                                         pin_memory=True)
        if self.dev_packed is None or self.dev_packed.numel() < packed_bytes:
            n = max(packed_bytes, 1 << 20)
            self.dev_packed = torch.empty(n, dtype=torch.uint8, device=device)
            self.host_packed = torch.empty(n, dtype=torch.uint8,
                                           pin_memory=True)
        return self


PACK_BLOCK = 1024


def pack_kernels(ring, tail: int, m: int, st: PackStaging, stream) -> Tuple:
    """Queue the pack of the m oldest slots into `st`'s buffers on
    `stream` (kernels only).  Returns the row layout (offsets, stride)."""
    global pack_launches
    header, valid, rows = ring[0], ring[1], ring[2:]
    if len(rows) > MAX_LEAVES:
        raise NotImplementedError(
            f"ring: {len(rows)} row leaves (the kernel takes {MAX_LEAVES})")
    S, H = header.shape
    R = valid.shape[1]
    offs, stride = _layout(ring)
    nch = (R + PACK_BLOCK - 1) // PACK_BLOCK
    st.get(header.device, m * (H + 1), m * R * stride, m * nch + 1)
    pl = PackPlan()
    pl.n_leaves, pl.m, pl.S, pl.tail, pl.R, pl.H = len(rows), m, S, tail, \
        R, H
    pl.row_stride, pl.nch = stride, nch
    for j, (t, o) in enumerate(zip(rows, offs)):
        pl.esize[j] = t.element_size()
        pl.off[j] = o
        pl.leaf[j] = t.data_ptr()
    pl.valid, pl.header = valid.data_ptr(), header.data_ptr()
    pl.counts = st.counts.data_ptr()
    pl.meta, pl.packed = st.dev_meta.data_ptr(), st.dev_packed.data_ptr()
    _nvcc.launch_plan("ring", "siddhi_ring_pack",
                      "siddhi_ring_pack_plan_size", pl, stream.cuda_stream)
    pack_launches += 1
    return offs, stride


def launch_pack(ring, tail: int, m: int, staging: PackStaging,
                after=None):
    global d2h_transfers
    header, rows = ring[0], ring[2:]
    H = header.shape[1]
    dev = header.device
    staging.get(dev, 1, 1)
    s = staging.stream
    # the pack reads slots the producer's stream appended
    if after is not None:
        s.wait_event(after)
    else:
        s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        offs, stride = pack_kernels(ring, tail, m, staging, s)
        st = staging
        nm = m * (H + 1)
        st.host_meta[:nm].copy_(st.dev_meta[:nm], non_blocking=True)
        d2h_transfers += 1
        s.synchronize()
        meta = st.host_meta[:nm].numpy().reshape(m, H + 1).copy()
        total = int(meta[:, H].sum())
        nb = total * stride
        if nb:
            st.host_packed[:nb].copy_(st.dev_packed[:nb], non_blocking=True)
            d2h_transfers += 1
            s.synchronize()
    return meta, unpack_rows(st.host_packed[:nb].numpy(), rows, offs,
                             stride, total)


def unpack_rows(buf: np.ndarray, rows: Sequence[torch.Tensor], offs,
                stride: int, total: int) -> List[np.ndarray]:
    """The packed rows' leaves as numpy arrays of `total` elements."""
    mat = buf[:total * stride].reshape(total, stride)
    out = []
    for t, o in zip(rows, offs):
        es = t.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(np.ascontiguousarray(mat[:, o:o + es]).view(dt)
                   .reshape(total))
    return out
