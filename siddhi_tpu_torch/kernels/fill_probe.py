"""Wrapper and plain version of the `fill_probe` CUDA kernel (K33): the
state observatory's window-fill probe (`observability/stateobs.py`).

The JAX package counts the `alive` mask of every window Buffer in a query's
state.  The port's window states keep that fill in their own layouts, so
each state's `fill_sources()` gives, in the JAX package's leaf order, one
`FillSource` a JAX leaf, with that leaf's capacity (`prod(alive.shape)`):

  ("mask", x)        the nonzero elements of x (bool / uint8 / int64)
  ("count", x, i)    the counter x[i]
  ("diff", x, i, j)  x[i] - x[j] (a ring's tail - head)

`fill_counts(sources)` returns the int64[n] counts on the sources' device:
given CUDA tensors it launches K33 once (the descriptor table passed by
value, no host-to-device copy); given CPU tensors it runs
`fill_counts_plain`.

`launches` counts K33 launches and `plain_calls` calls of the plain
version; `reset_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch

from . import _nvcc

launches = 0
plain_calls = 0

MAX_SOURCES = 16
_KINDS = {"mask": 0, "count": 1, "diff": 2}
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


class FillSource(NamedTuple):
    """One JAX `alive` leaf's fill in a port state (see the module
    docstring); `cap` is that leaf's capacity."""
    kind: str
    x: torch.Tensor
    cap: int
    i: int = 0
    j: int = 0


def mask(x: torch.Tensor, cap: int = None) -> FillSource:
    return FillSource("mask", x, x.numel() if cap is None else int(cap))


def count(x: torch.Tensor, i: int, cap: int) -> FillSource:
    return FillSource("count", x, int(cap), int(i))


def diff(x: torch.Tensor, i: int, j: int, cap: int) -> FillSource:
    return FillSource("diff", x, int(cap), int(i), int(j))


class FillPlan(ctypes.Structure):
    """Mirrors `struct FillPlan` in csrc/fill_probe.cu."""
    _fields_ = [("n", _I), ("kind", _I * MAX_SOURCES),
                ("esize", _I * MAX_SOURCES), ("nelem", _L * MAX_SOURCES),
                ("a", _P * MAX_SOURCES), ("b", _P * MAX_SOURCES),
                ("out", _P)]


def fill_counts(sources: Sequence[FillSource]) -> torch.Tensor:
    """int64[len(sources)]: each source's fill (see the module
    docstring)."""
    if sources and sources[0].x.is_cuda:
        return launch(sources)
    return fill_counts_plain(sources)


def fill_counts_plain(sources: Sequence[FillSource]) -> torch.Tensor:
    """The plain version: one torch reduction or read per source."""
    global plain_calls
    plain_calls += 1
    out: List[torch.Tensor] = []
    for s in sources:
        if s.kind == "mask":
            out.append(torch.count_nonzero(s.x).to(torch.int64))
        elif s.kind == "count":
            out.append(s.x[s.i].to(torch.int64))
        else:
            out.append((s.x[s.i].to(torch.int64) -
                        s.x[s.j].to(torch.int64)))
    if not out:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack(out)


def launch(sources: Sequence[FillSource]) -> torch.Tensor:
    global launches
    if len(sources) > MAX_SOURCES:
        raise NotImplementedError(
            f"fill_probe: {len(sources)} window leaves (the kernel takes "
            f"{MAX_SOURCES})")
    dev = sources[0].x.device
    out = torch.empty(len(sources), dtype=torch.int64, device=dev)
    pl = FillPlan()
    pl.n = len(sources)
    kept = []
    for l, s in enumerate(sources):
        x = s.x
        if x.device != dev:
            raise ValueError("fill_probe: sources on different devices")
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        es = x.element_size()
        pl.kind[l] = _KINDS[s.kind]
        pl.esize[l] = es
        if s.kind == "mask":
            if es not in (1, 8):
                raise ValueError(f"fill_probe: a {x.dtype} mask")
            if not x.is_contiguous():
                x = x.contiguous()
                kept.append(x)
            pl.nelem[l] = x.numel()
            pl.a[l] = x.data_ptr()
        else:
            if es not in (4, 8) or x.dtype.is_floating_point or \
                    x.dim() != 1 or not (0 <= s.i < x.shape[0] and
                                         0 <= s.j < x.shape[0]):
                raise ValueError(f"fill_probe: counter {s.i} / {s.j} of a "
                                 f"{x.dtype} {tuple(x.shape)} tensor")
            pl.a[l] = x.data_ptr() + s.i * x.stride(0) * es
            pl.b[l] = x.data_ptr() + s.j * x.stride(0) * es
    pl.out = out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _nvcc.launch_plan("fill_probe", "siddhi_fill_probe",
                      "siddhi_fill_probe_plan_size", pl, stream)
    launches += 1
    del kept
    return out
