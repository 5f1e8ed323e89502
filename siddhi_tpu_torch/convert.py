"""Carry a pattern query's state across from the JAX package.

The JAX runtime's `PatternQueryRuntime.state` is `((b32, b64, scalars),
sel_state)`.  Its blobs are [W, K] with the key axis minor, and the port's
`StatePacker` lays its rows out identically, so the state converts leaf for
leaf: both packages can then continue from the same mid-stream state.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def state_from_jax(b32, b64, scalars: Sequence, sel_state=(),
                   device=None) -> Tuple[tuple, tuple]:
    """numpy (or array-like) blobs of the JAX runtime -> the port's
    ((b32, b64, scalars), sel_state) on `device`.  Only projection
    selectors are ported, so `sel_state` must be empty."""
    if len(tuple(sel_state)) != 0:
        raise NotImplementedError(
            "selector state (aggregations) is not yet ported (ROADMAP B14)")
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    t32 = torch.from_numpy(np.array(b32, dtype=np.int32, copy=True))
    t64 = torch.from_numpy(np.array(b64, dtype=np.int64, copy=True))
    scal = tuple(torch.from_numpy(np.array(s, copy=True)).to(device)
                 for s in scalars)
    return (t32.to(device), t64.to(device), scal), ()
