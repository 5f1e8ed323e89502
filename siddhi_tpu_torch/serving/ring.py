"""Emission rings on the card: the send path becomes dispatch-only (port of
`siddhi_tpu/serving/ring.py`).

A serving query's emissions append into a persistent ring on the card (one
launch of kernel K30's `ring_append`, no device-to-host transfer) and stay
there until the serving drainer (`serving/drain.py`) packs and fetches
them.  The producer thread never waits on the card.

Ring layout: a generation holds S slots of one output signature, the
header words ([S, H]), the valid flags and every row leaf ([S, R] each;
`kernels/ring.py`).  A CUDA event recorded after each append tells the
drainer when that slot's bytes are on the card.

Overflow: a full ring doubles in one jump (a new generation) up to
`RING_CAP_MAX` slots; past that the producer blocks until the drainer
frees a slot (bounded backpressure, never a silent drop; 30 s without
progress raises).  An output-signature change (an emission-cap growth
replans the step) seals the current generation and opens a fresh one;
sealed generations drain first, so delivery order per query is exactly
send order.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Tuple

import torch

from ..kernels import ring as k30
from ..observability import stateobs as _stateobs

log = logging.getLogger("siddhi_tpu_torch")

# past this the producer blocks instead of growing the ring
RING_CAP_MAX = 1 << 10


def _block(out, header):
    """The ring's view of a step's output: (header, ts, kind, valid,
    cols); a pattern's output carries its counts ahead of the rows."""
    rows = out[2:] if len(out) == 6 else out
    ts, kind, valid, cols = rows
    return (header, ts, kind, valid, tuple(cols))


def _key(block) -> Tuple:
    return tuple((tuple(x.shape), x.dtype) for x in k30.block_leaves(block))


class _Generation:
    """One ring buffer: S slots plus FIFO head / tail.  Appends go to the
    NEWEST generation only; sealed (older) generations drain to empty and
    are dropped."""

    __slots__ = ("bufs", "slots", "head", "tail", "count", "key", "events")

    def __init__(self, block, slots: int):
        self.slots = slots
        self.head = 0          # next write slot
        self.tail = 0          # next read slot
        self.count = 0         # occupied slots (taken ones until freed)
        self.key = _key(block)
        self.bufs = k30.alloc(block, slots)
        self.events: List = [None] * slots

    def append(self, block) -> None:
        slot = self.head
        k30.append(self.bufs, block, slot)
        if self.bufs[0].is_cuda:
            e = torch.cuda.Event()
            e.record(torch.cuda.current_stream(self.bufs[0].device))
            self.events[slot] = e
        self.head = (slot + 1) % self.slots
        self.count += 1


class EmissionRing:
    """Per-runtime emission ring.  `append` is the producer edge (query
    lock held, no device-to-host transfer); `drain` is the drainer edge.
    Bookkeeping is guarded by the ring's own condition, so the drainer
    never needs the query lock: a producer blocked on a full ring cannot
    deadlock against the thread that frees it."""

    def __init__(self, qr, capacity: int = 8, on_highwater=None):
        self.qr = qr
        self.capacity = max(1, int(capacity))
        self._cond = threading.Condition()
        self._gens: List[_Generation] = []
        # (generation, now, deliver, pattern-shaped output) in send order,
        # across generations
        self._meta: List[Tuple] = []
        self._on_highwater = on_highwater
        self.grows_total = 0
        self.appends_total = 0
        self.max_occupancy = 0

    # -- producer edge -------------------------------------------------------
    def append(self, out, header, now: int, deliver) -> None:
        block = _block(out, header)
        with self._cond:
            gen = self._gens[-1] if self._gens else None
            if gen is None or gen.key != _key(block):
                gen = _Generation(block, self.capacity)
                self._gens.append(gen)
            if gen.count >= gen.slots:
                gen = self._make_room(gen, block)
            gen.append(block)
            self._meta.append((gen, now, deliver, len(out) == 6))
            self.appends_total += 1
            occ = len(self._meta)
            self.max_occupancy = max(self.max_occupancy, occ)
            kick = occ >= self._high_water()
        if _stateobs.obs_enabled(self.qr.app):
            # ring depth high-water for the sizing ledger (a host counter:
            # the producer edge stays fetch-free)
            self.qr.app.stats.stateobs.observe(
                self.qr.name, "serve_ring", occ, self.capacity,
                growable=self.capacity < RING_CAP_MAX,
                config_key="serving.ring.capacity")
        if kick and self._on_highwater is not None:
            self._on_highwater()

    def _high_water(self) -> int:
        return max(1, (self.capacity * 3) // 4)

    def _make_room(self, gen: _Generation, block) -> _Generation:
        """Full ring: grow 2x, or block as bounded backpressure until the
        drainer frees a slot.  Called with the cond lock held."""
        new_cap = min(self.capacity * 2, RING_CAP_MAX)
        if new_cap > self.capacity:
            log.warning("%s: emission ring full at %d slots; growing to %d "
                        "(serving.ring.capacity pre-sizes and silences "
                        "this)", self.qr.name, self.capacity, new_cap)
            self.capacity = new_cap
            self.grows_total += 1
            if self.qr.app.stats.enabled:
                self.qr.app.stats.counter_inc(f"{self.qr.name}.ring_grows")
            gen = _Generation(block, new_cap)
            self._gens.append(gen)
            return gen
        if self._on_highwater is not None:
            self._on_highwater()
        waited = 0.0
        while gen.count >= gen.slots:
            if not self._cond.wait(timeout=0.05):
                waited += 0.05
                if waited >= 30.0:
                    raise RuntimeError(
                        f"{self.qr.name}: emission ring full for 30s with "
                        f"no drain progress (drainer dead?)")
                if self._on_highwater is not None:
                    self._on_highwater()
        return gen

    # -- drainer edge --------------------------------------------------------
    def drain(self, staging) -> List[Tuple]:
        """Take every pending entry in send order: per run of one
        generation, one pack and two device-to-host transfers
        (`kernels/ring.py` `pack_fetch`), then free the slots.  Returns
        [(deliver, out, host header, now)] for the caller to deliver."""
        with self._cond:
            metas = list(self._meta)
        out: List[Tuple] = []
        i = 0
        while i < len(metas):
            gen = metas[i][0]
            j = i
            while j < len(metas) and metas[j][0] is gen:
                j += 1
            m = j - i
            with self._cond:
                tail = gen.tail
            last = (tail + m - 1) % gen.slots
            meta, rows = k30.pack_fetch(gen.bufs, tail, m, staging,
                                        after=gen.events[last])
            H = gen.bufs[0].shape[1]
            o = 0
            for r, (_, now, deliver, six) in enumerate(metas[i:j]):
                n = int(meta[r, H])
                ts, kind, *cols = (torch.from_numpy(x[o:o + n])
                                   for x in rows)
                o += n
                valid = torch.ones(n, dtype=torch.bool)
                block = (ts, kind, valid, tuple(cols))
                if six:
                    block = (None, None) + block
                out.append((deliver, block, meta[r, :H].tolist(), now))
            with self._cond:
                gen.tail = (tail + m) % gen.slots
                gen.count -= m
                del self._meta[:m]
                while len(self._gens) > 1 and self._gens[0].count == 0 \
                        and not any(x[0] is self._gens[0]
                                    for x in self._meta):
                    self._gens.pop(0)
                self._cond.notify_all()
            i = j
        return out

    # -- introspection -------------------------------------------------------
    def occupancy(self) -> int:
        return len(self._meta)

    def state_leaves(self):
        """The current generations' device buffers (metadata walks only:
        observability/memory.py counts them under `serve_ring`)."""
        return [g.bufs for g in self._gens]

    def facts(self) -> Dict[str, Any]:
        """The health node of this ring."""
        from ..observability.memory import tree_nbytes
        return {"capacity": self.capacity,
                "occupancy": self.occupancy(),
                "high_water": self._high_water(),
                "appends_total": self.appends_total,
                "overflow_grows": self.grows_total,
                "generation": len(self._gens),
                "nbytes": tree_nbytes(self.state_leaves())}
