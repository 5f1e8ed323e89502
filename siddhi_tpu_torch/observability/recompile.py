"""Recompile accounting: the registry and its surfaces (port of
`siddhi_tpu/observability/recompile.py`).

In the JAX package every step is a `jax.jit` program and `jit_step`
records each trace here.  Nothing in the port re-traces per shape: its
steps are plain torch code and kernels built once per source hash.  What a
"recompile" means in the port (an `_nvcc` build, a CUDA-graph capture) is
an open design question (ROADMAP A15), so nothing feeds this registry yet
and every owner's count reads zero.  The registry, `report()["recompiles"]`,
the exposition family and the health rate are in place for that hook.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

_MAX_SIGNATURES = 4     # last-N triggering signatures kept per owner
_MAX_SIG_CHARS = 240


def _describe(x) -> str:
    shape = getattr(x, "shape", None)
    if shape is not None:
        d = str(getattr(x, "dtype", "")).replace("torch.", "")
        return f"{d}{list(shape)}"
    return type(x).__name__


def signature_of(args) -> str:
    """Compact one-line abstract-shape signature of a traced call's args."""
    try:
        from .memory import tree_leaves
        leaves = tree_leaves(args)
    except Exception:  # noqa: BLE001 — accounting must never throw
        leaves = []
    s = " ".join(_describe(v) for v in leaves)
    if len(s) > _MAX_SIG_CHARS:
        s = s[:_MAX_SIG_CHARS] + "..."
    return s


class RecompileRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._sigs: Dict[str, deque] = {}
        self._last_ms: Dict[str, int] = {}

    def record(self, owner: str, args) -> None:
        sig = signature_of(args)
        with self._lock:
            self._counts[owner] = self._counts.get(owner, 0) + 1
            dq = self._sigs.get(owner)
            if dq is None:
                dq = self._sigs[owner] = deque(maxlen=_MAX_SIGNATURES)
            dq.append(sig)
            self._last_ms[owner] = int(time.time() * 1000)

    def count(self, owner: str) -> int:
        return self._counts.get(owner, 0)

    def snapshot(self, owners: Optional[List[str]] = None) -> Dict:
        """{owner: {count, last_ms, signatures}} — all owners, or just the
        requested ones (an app projecting its own queries)."""
        with self._lock:
            keys = list(self._counts) if owners is None else \
                [o for o in owners if o in self._counts]
            return {o: {"count": self._counts[o],
                        "last_ms": self._last_ms.get(o, 0),
                        "signatures": list(self._sigs.get(o, ()))}
                    for o in keys}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sigs.clear()
            self._last_ms.clear()


RECOMPILES = RecompileRegistry()
