"""Build and load the port's CUDA kernels: `nvcc` into a shared library
with a plain C interface, named by a hash of the sources and flags, under
`kernels/_build/`, loaded with `ctypes`.

Each `.cu` file under `csrc/` is one library.  `build(name)` compiles one
source on first use (once per source hash); `build_all()` starts one
`nvcc` per source at the same time and waits for all of them, so a caller
that needs every kernel pays for the slowest build, not for their sum.
Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
SOURCES = ("pattern_step", "filter_compact", "time_window", "length_batch",
           "group_agg", "length_window", "join_lanes", "join_probe",
           "block_nfa", "table_write", "table_match", "keyed_window",
           "in_probe", "time_batch", "order_limit", "post_filter",
           "ext_window", "sort_window", "hop_window", "frequent",
           "keyed_ext", "keyed_freq", "expr_window", "agg_base",
           "agg_merge", "multi_filter", "ring", "shard_route",
           "shard_merge", "fill_probe")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """The library of `name`, keyed by the source, the shared headers of
    `csrc/` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source(name)] + sorted(
            os.path.join(CSRC, x) for x in os.listdir(CSRC)
            if x.endswith(".cuh")):
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    so = library_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source(name)}:\n{out}")
    with open(so + ".ptxas.txt", "w") as fh:
        fh.write(out)
    os.replace(tmp, so)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path(name))
    _libs[name] = lib
    return lib


def build(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load one kernel library."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        return _load(name)


def build_all(names=SOURCES) -> List[ctypes.CDLL]:
    """Compile every named source in parallel (one nvcc each) and load
    them all."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        return [_libs.get(n) or _load(n) for n in names]


def ptxas_report(name: str) -> str:
    """What `nvcc -Xptxas -v` said about the built library (registers,
    local memory, spill bytes)."""
    with open(library_path(name) + ".ptxas.txt") as fh:
        return fh.read()


def check_launch(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def launch_plan(name: str, entry: str, size_fn: str, plan, stream) -> None:
    """Call `entry(const Plan*, stream)` of library `name` and raise on a
    CUDA error.  On the first call, check that the C struct (`size_fn()`
    returns its size) and its ctypes mirror `plan` have one layout."""
    lib = build(name)
    fn = getattr(lib, entry)
    if not getattr(fn, "_siddhi_checked", False):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        size = getattr(lib, size_fn)
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(plan):
            raise RuntimeError(f"{type(plan).__name__} layout mismatch")
        fn._siddhi_checked = True
    check_launch(fn(ctypes.byref(plan), stream), name)


def slot_bits(v, dtype) -> int:
    """A column value as the kernels' 64-bit slot: a float32's bit
    pattern, an integer as itself."""
    if dtype == torch.float32:
        return int(torch.tensor(float(v), dtype=torch.float32)
                   .view(torch.int32))
    return int(v)
