"""State-memory accounting: bytes per device-state component (port of
`siddhi_tpu/observability/memory.py`).  Walks each runtime's state (tensors
inside tuples, dicts and the port's state objects) and sums
`numel * element_size` from metadata only: no device fetch, no sync.  The
owner and component names are the JAX package's (queries by name with a
component label, `table:<id>`, `window:<id>`, `agg:<id>`,
`merged:<group>`); the byte counts are of the port's own tensors.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def leaf_nbytes(x) -> int:
    """Bytes of one state leaf from metadata only (no device access)."""
    try:
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is None or dtype is None:
            # host scalar / python object leaf
            return int(np.asarray(x).nbytes) if np.isscalar(x) else 0
        n = 1
        for d in shape:
            n *= int(d)
        return n * int(np.dtype(dtype).itemsize)
    except Exception:  # noqa: BLE001 — metrics must not throw
        return 0


def tree_leaves(tree) -> List:
    """The tensors and numpy arrays of a state: nested tuples, lists and
    dicts, and the port's state objects (a `tensors()` method, else
    their attributes), each object visited once."""
    out: List = []
    seen = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, (torch.Tensor, np.ndarray)):
            out.append(node)
            continue
        if node is None or isinstance(node, (str, bytes, int, float,
                                             bool, np.generic)):
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
        elif callable(getattr(node, "tensors", None)):
            stack.extend(reversed(list(node.tensors())))
        elif hasattr(node, "__dict__"):
            stack.extend(reversed(list(vars(node).values())))
    return out


def tree_nbytes(tree) -> int:
    """Total bytes of a state, metadata-only."""
    try:
        return sum(leaf_nbytes(leaf) for leaf in tree_leaves(tree))
    except Exception:  # noqa: BLE001 — metrics must not throw
        return 0


def _kind_components(qr) -> Dict[str, int]:
    """Split a query runtime's state tuple into named components.  The
    state layouts are (window, selector) for planned single queries,
    ((b32, b64, scalars), selector) for patterns, and the join's
    (left window, right window, selector...) tuple; anything that doesn't
    match falls back to positional names so the total always adds up."""
    mg = getattr(qr, "_merged", None)
    if mg is not None:
        # merged member (optimizer/mqo.py): report only this query's
        # EXCLUSIVE bytes — the shared window buffer is accounted ONCE,
        # under the group owner (component_bytes adds `merged:<group>`),
        # never per member (the MEM001 double-count fix)
        return mg.member_components(qr)
    state = qr.state
    p = qr.planned
    names = None
    if hasattr(p, "steps") and isinstance(getattr(p, "steps", None), dict):
        names = ("pattern_slots", "selector")
    elif hasattr(p, "step_left"):
        names = ("window_left", "window_right", "selector")
    elif isinstance(state, tuple) and len(state) == 2:
        names = ("window", "selector")
    out: Dict[str, int] = {}
    if isinstance(state, tuple) and names is not None and \
            len(state) <= len(names) + 1:
        for i, part in enumerate(state):
            label = names[i] if i < len(names) else f"state[{i}]"
            out[label] = tree_nbytes(part)
    else:
        out["state"] = tree_nbytes(state)
    # @fuse stack buffers hold K-1 staged host batches awaiting dispatch
    fb = getattr(qr, "_fuse", None)
    if fb is not None and fb.items:
        total = 0
        for args in fb.items:
            for a in args:
                staged = a if hasattr(a, "cols") else None
                if staged is not None:
                    total += leaf_nbytes(staged.ts) + \
                        leaf_nbytes(staged.kind) + leaf_nbytes(staged.valid)
                    total += sum(leaf_nbytes(c) for c in staged.cols)
        if total:
            out["fuse_stack"] = total
    # serving emission ring (serving/ring.py): device-resident output
    # slots awaiting the async drainer — metadata-only walk of the
    # ring's generation buffers
    ring = qr.__dict__.get("_serve_ring")
    if ring is not None:
        try:
            total = sum(tree_nbytes(s) for s in ring.state_leaves())
        except Exception:  # noqa: BLE001 — metrics must not throw
            total = 0
        if total:
            out["serve_ring"] = total
    return out


def query_component_bytes(qr) -> Dict[str, int]:
    """{component: nbytes} for one query runtime (metadata-only walk)."""
    try:
        return _kind_components(qr)
    except Exception:  # noqa: BLE001 — metrics must not throw
        return {}


def component_bytes(rt) -> Dict[str, Dict[str, int]]:
    """{owner: {component: nbytes}} across an app: every query runtime
    plus shared tables, named windows, and aggregations."""
    out: Dict[str, Dict[str, int]] = {}
    for name, qr in list(getattr(rt, "query_runtimes", {}).items()):
        comps = query_component_bytes(qr)
        if comps:
            out[name] = comps
    for gid, mg in list(getattr(rt, "merged_groups", {}).items()):
        try:
            comps = mg.shared_components()
        except Exception:  # noqa: BLE001 — metrics must not throw
            comps = {}
        if comps:
            out[f"merged:{gid}"] = comps
    for tid, t in list(getattr(rt, "tables", {}).items()):
        n = sum(leaf_nbytes(c) for c in getattr(t, "cols", ())) + \
            leaf_nbytes(getattr(t, "ts", None)) + \
            leaf_nbytes(getattr(t, "valid", None))
        if n:
            out[f"table:{tid}"] = {"rows": n}
    for wid, nw in list(getattr(rt, "named_windows", {}).items()):
        n = tree_nbytes(getattr(nw, "state", None))
        if n:
            out[f"window:{wid}"] = {"buffer": n}
    for aid, agg in list(getattr(rt, "aggregations", {}).items()):
        # one device slab per declared duration (_DurationStore.slab)
        comps = {}
        for dur, store in getattr(agg, "_dstores", {}).items():
            n = tree_nbytes(getattr(store, "slab", None))
            if n:
                comps[dur] = n
        if comps:
            out[f"agg:{aid}"] = comps
    return out


def total_bytes(rt) -> int:
    return sum(n for comps in component_bytes(rt).values()
               for n in comps.values())
