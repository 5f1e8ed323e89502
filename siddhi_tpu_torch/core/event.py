"""Columnar event model (PyTorch port of `siddhi_tpu/core/event.py`).

An event micro-batch is a struct of tensors: timestamps i64[B], kind i32[B],
valid bool[B], and one fixed-dtype column per attribute.  The dtype map and
the in-band nulls are the reference package's, exactly, so outputs of the
two packages compare value for value:

  * DOUBLE and FLOAT ride as float32, LONG as int64, INT as int32, STRING
    as an interned int32 id (-1 is null), BOOL as bool.
  * Numeric nulls are in-band: INT_MIN, LONG_MIN and NaN.  BOOL has no spare
    value, so a null bool decodes as False.

Host staging stays numpy (`StagedBatch`); `to_device` moves a staged batch
onto one explicit `torch.device`.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..query_api.definition import AbstractDefinition

# Event kinds (reference: ComplexEvent.Type CURRENT/EXPIRED/TIMER/RESET)
CURRENT = 0
EXPIRED = 1
TIMER = 2
RESET = 3

_DTYPES = {
    "STRING": torch.int32,   # interned id; -1 == null
    "INT": torch.int32,
    "LONG": torch.int64,
    "FLOAT": torch.float32,
    "DOUBLE": torch.float32,
    "BOOL": torch.bool,
    "OBJECT": torch.int32,   # host-side object registry id
}

NULL_ID = -1  # interned id representing null string
NULL_INT = int(np.iinfo(np.int32).min)
NULL_LONG = int(np.iinfo(np.int64).min)


def null_value(attr_type: str):
    """The encoded cell value representing null for this attribute type."""
    t = attr_type.upper()
    if t in ("STRING", "OBJECT"):
        return NULL_ID
    if t == "BOOL":
        return False
    if t in ("FLOAT", "DOUBLE"):
        return float("nan")
    if t == "INT":
        return NULL_INT
    return NULL_LONG


def null_mask(x, attr_type: str):
    """Bool mask of null cells; works on tensors and numpy arrays."""
    t = attr_type.upper()
    host = isinstance(x, np.ndarray)
    if t in ("STRING", "OBJECT"):
        return x == NULL_ID
    if t in ("FLOAT", "DOUBLE"):
        return np.isnan(x) if host else torch.isnan(x)
    if t == "INT":
        return x == NULL_INT
    if t == "LONG":
        return x == NULL_LONG
    if host:
        return np.zeros(np.shape(x), bool)
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def decode_scalar(attr_type: str, v, interner, objects=None):
    """Encoded cell -> Python value at a host boundary."""
    t = attr_type.upper()
    if t == "STRING":
        return interner.lookup(int(v))
    if t == "OBJECT":
        return objects.lookup(int(v)) if objects is not None else None
    if t == "BOOL":
        return bool(v)
    if t in ("FLOAT", "DOUBLE"):
        f = float(v)
        return None if f != f else f            # NaN is the float null
    iv = int(v)
    if iv == (NULL_INT if t == "INT" else NULL_LONG):
        return None
    return iv


_BUCKETS = (8, 32, 128, 512, 2048, 8192, 32768, 131072, 262144, 524288,
            1048576, 2097152)


def bucket_size(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} events exceeds max bucket {_BUCKETS[-1]}")


def dtype_of(attr_type: str) -> torch.dtype:
    return _DTYPES[attr_type.upper()]


def np_dtype(attr_type: str):
    t = attr_type.upper()
    if t in ("STRING", "OBJECT", "INT"):
        return np.int32
    if t == "LONG":
        return np.int64
    if t in ("FLOAT", "DOUBLE"):
        return np.float32
    return np.bool_


def default_value(attr_type: str):
    t = attr_type.upper()
    if t in ("STRING", "OBJECT"):
        return NULL_ID
    if t == "BOOL":
        return False
    if t in ("FLOAT", "DOUBLE"):
        return 0.0
    return 0


class StringInterner:
    """Host-side dictionary encoder shared across an app's streams so ids are
    comparable across streams."""

    def __init__(self):
        self._lock = threading.Lock()
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []

    def intern(self, s: Optional[str]) -> int:
        if s is None:
            return NULL_ID
        got = self._to_id.get(s)
        if got is not None:
            return got
        with self._lock:
            got = self._to_id.get(s)
            if got is None:
                got = len(self._to_str)
                self._to_str.append(s)
                self._to_id[s] = got
            return got

    def lookup(self, i: int) -> Optional[str]:
        if i < 0 or i >= len(self._to_str):
            return None
        return self._to_str[i]

    def __len__(self):
        return len(self._to_str)


class ObjectRegistry:
    """Host-side registry giving OBJECT attributes a device-representable id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objs: List[Any] = []

    def register(self, o: Any) -> int:
        if o is None:
            return NULL_ID
        with self._lock:
            self._objs.append(o)
            return len(self._objs) - 1

    def lookup(self, i: int) -> Any:
        if i < 0 or i >= len(self._objs):
            return None
        return self._objs[i]


class Event:
    """Host-side event (reference: CORE/event/Event.java)."""

    __slots__ = ("timestamp", "data")

    def __init__(self, timestamp: int, data: Sequence[Any]):
        self.timestamp = int(timestamp)
        self.data = list(data)

    def __repr__(self):
        return f"Event({self.timestamp}, {self.data})"

    def __eq__(self, other):
        return (isinstance(other, Event)
                and self.timestamp == other.timestamp
                and self.data == other.data)


class Schema:
    """Runtime view of a definition: attribute order, dtypes, interner."""

    def __init__(self, definition: AbstractDefinition, interner: StringInterner,
                 objects: Optional[ObjectRegistry] = None):
        self.definition = definition
        self.id = definition.id
        self.names: Tuple[str, ...] = tuple(definition.attribute_names)
        self.types: Tuple[str, ...] = tuple(
            a.type for a in definition.attribute_list)
        self.dtypes = tuple(dtype_of(t) for t in self.types)
        self.interner = interner
        self.objects = objects or ObjectRegistry()

    def position(self, name: str) -> int:
        return self.names.index(name)

    def encode_value(self, attr_type: str, v: Any):
        t = attr_type.upper()
        if t == "STRING":
            return self.interner.intern(v) \
                if isinstance(v, str) or v is None else int(v)
        if t == "OBJECT":
            return self.objects.register(v)
        if v is None:
            return null_value(t)
        if t == "BOOL":
            return bool(v)
        if t in ("FLOAT", "DOUBLE"):
            return float(v)
        return int(v)

    def decode_value(self, attr_type: str, v):
        return decode_scalar(attr_type, v, self.interner, self.objects)


class EventBatch:
    """Struct-of-tensors event micro-batch (static shape [B])."""

    __slots__ = ("ts", "kind", "valid", "cols")

    def __init__(self, ts, kind, valid, cols: Tuple):
        self.ts = ts          # i64[B]
        self.kind = kind      # i32[B]
        self.valid = valid    # bool[B]
        self.cols = tuple(cols)


class StagedBatch:
    """Host (numpy) staging of a batch, used for partition-key slot
    computation before the single host->device transfer."""

    __slots__ = ("ts", "kind", "valid", "cols", "n", "jprobe", "dev")

    def __init__(self, ts, kind, valid, cols, n):
        self.ts, self.kind, self.valid, self.cols, self.n = \
            ts, kind, valid, cols, n
        # equi-join key slots of this batch, per (join runtime, side): a
        # junction hands one staged batch to every subscriber, and a
        # self-join sees it on both sides (reference
        # siddhi_tpu/core/event.py:353-360)
        self.jprobe = None
        # an upload started at the junction's accept edge
        # (serving/staging.py): (schema, device, EventBatch, CUDA event)
        self.dev = None

    def to_device(self, schema: Schema, device: torch.device) -> EventBatch:
        pre = self.dev
        if pre is not None and pre[0] is schema and pre[1] == device:
            # adopt the prestaged upload once: its buffers go to one step
            self.dev = None
            if pre[3] is not None:
                torch.cuda.current_stream(device).wait_event(pre[3])
            return pre[2]
        cols = tuple(torch.as_tensor(c).to(device=device, dtype=d)
                     for c, d in zip(self.cols, schema.dtypes))
        return EventBatch(torch.as_tensor(self.ts).to(device),
                          torch.as_tensor(self.kind).to(device),
                          torch.as_tensor(self.valid).to(device), cols)


class StackedBatch:
    """K same-capacity staged batches stacked into [K, B] host arrays for
    one fused dispatch (reference `siddhi_tpu/core/event.py:377`):
    `to_device` ships every leaf, and any extra host arrays the dispatch
    needs (group slots, selections), in ONE host-to-device copy of one
    byte buffer, then views it per leaf.  Capacity equality is the
    caller's contract (the fuse buffer keys its stack on the bucket
    size)."""

    __slots__ = ("ts", "kind", "valid", "cols", "k")

    def __init__(self, staged_list: Sequence["StagedBatch"]):
        self.k = len(staged_list)
        self.ts = np.stack([s.ts for s in staged_list])
        self.kind = np.stack([s.kind for s in staged_list])
        self.valid = np.stack([s.valid for s in staged_list])
        self.cols = tuple(
            np.stack([s.cols[j] for s in staged_list])
            for j in range(len(staged_list[0].cols)))

    def to_device(self, schema: Schema, device: torch.device, extra=()):
        """([K, B] EventBatch on `device`, [each extra array on
        `device`])."""
        leaves = [self.ts, self.kind, self.valid] + [
            np.asarray(c, np_dtype(t)) for c, t in zip(self.cols,
                                                       schema.types)]
        dev = upload(leaves + [np.asarray(x) for x in extra], device)
        return EventBatch(dev[0], dev[1], dev[2], dev[3:3 + len(self.cols)]), \
            dev[3 + len(self.cols):]


def upload(arrays: Sequence[np.ndarray], device: torch.device):
    """Host arrays on `device` through one copy of one byte buffer (each
    array at an 8-byte aligned offset), as typed views of it."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += (a.nbytes + 7) // 8 * 8
    buf = np.empty(max(total, 8), np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    flat = torch.from_numpy(buf).to(device)
    out = []
    for a, o in zip(arrays, offs):
        td = torch.from_numpy(np.empty(0, a.dtype)).dtype
        out.append(flat[o:o + a.nbytes].view(td).view(a.shape))
    return out


def device_get(x) -> np.ndarray:
    """A tensor's host copy (numpy).  Every device-to-host transfer of the
    emission delivery path goes through here (a header's counts, a step's
    rows), so a test can count them per thread: the serving loop's send
    path must make none."""
    if isinstance(x, np.ndarray):
        return x
    return x.cpu().numpy()


def pack_np(schema: Schema, events: Sequence[Event],
            kinds: Optional[Sequence[int]] = None,
            capacity: Optional[int] = None) -> StagedBatch:
    """Encode host events into padded numpy staging arrays."""
    n = len(events)
    cap = capacity if capacity is not None else bucket_size(max(n, 1))
    ts = np.zeros((cap,), np.int64)
    kind = np.zeros((cap,), np.int32)
    valid = np.zeros((cap,), np.bool_)
    raw_cols = [np.zeros((cap,), np_dtype(t)) for t in schema.types]
    for i, e in enumerate(events):
        ts[i] = e.timestamp
        valid[i] = True
        if kinds is not None:
            kind[i] = kinds[i]
        for j, (t, v) in enumerate(zip(schema.types, e.data)):
            raw_cols[j][i] = schema.encode_value(t, v)
    return StagedBatch(ts, kind, valid, raw_cols, n)


def pack(schema: Schema, events: Sequence[Event], device: torch.device,
         kinds: Optional[Sequence[int]] = None,
         capacity: Optional[int] = None) -> EventBatch:
    """Encode host events into a padded columnar batch on `device`."""
    return pack_np(schema, events, kinds, capacity).to_device(schema, device)


def unpack(schema: Schema, batch: EventBatch,
           want_kinds: Tuple[int, ...] = (CURRENT,)) -> List[Tuple[int, Event]]:
    """Decode a batch (tensors or numpy arrays) back to host [(kind, Event)]
    preserving order."""
    kind = _np(batch.kind)
    valid = _np(batch.valid)
    keep = valid & (kind != TIMER) & (kind != RESET)
    if want_kinds is not None:
        sel = np.zeros_like(keep)
        for k in want_kinds:
            sel |= kind == k
        keep &= sel
    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        return []
    ts_l = _np(batch.ts)[idx].tolist()
    kind_l = kind[idx].tolist()
    col_np = [_np(c)[idx] for c in batch.cols]
    col_ls = [c.tolist() for c in col_np]
    decoders = []
    for t, cnp in zip(schema.types, col_np):
        tu = t.upper()
        if tu == "STRING":
            decoders.append(schema.interner.lookup)
        elif tu == "OBJECT":
            decoders.append(schema.objects.lookup)
        elif cnp.size and null_mask(cnp, tu).any():
            # numeric nulls present: reserved values decode to None
            nv = NULL_INT if tu == "INT" else NULL_LONG
            if tu in ("FLOAT", "DOUBLE"):
                decoders.append(lambda v: None if v != v else v)
            else:
                decoders.append(lambda v, _n=nv: None if v == _n else v)
        else:
            decoders.append(None)
    out: List[Tuple[int, Event]] = []
    for i in range(len(idx)):
        data = [c[i] if d is None else d(c[i])
                for c, d in zip(col_ls, decoders)]
        out.append((kind_l[i], Event(ts_l[i], data)))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
