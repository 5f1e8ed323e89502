"""Secondary table indexes + index-aware condition planning (copied from
`siddhi_tpu/core/table_index.py`: host numpy, no device work).

Reference behavior (what): IndexEventHolder keeps one map per @Index
attribute next to the primary-key map (CORE/table/holder/
IndexEventHolder.java:60-127 — indexData TreeMaps :65-66, add/delete
maintenance :94-127), and CollectionExpressionParser
(CORE/util/parser/CollectionExpressionParser.java) rewrites a table
condition into an indexed probe plus a residual exhaustive part, so
`table.attr == v and <rest>` touches only the matching rows.

TPU-native design (how): the per-event TreeMap of the reference becomes a
batched two-level structure. Values hash to dense *bucket* ids through the
same vectorized SlotAllocator used for partition keys (C kernel, no Python
per-row work), and a host [n_buckets, K] lane table maps each bucket to its
row ids. An equality probe for a whole event batch is one vectorized
allocator lookup + one gather — candidates come back as a padded [B, K]
block that the residual condition evaluates on device, replacing the dense
[B, C] broadcast with [B, K] where K is the widest bucket. Range conditions
(<, <=, >, >=) use a lazily re-sorted (value, row) view + searchsorted —
the batched analogue of the reference's TreeMap.subMap scan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..query_api.expression import (And, Compare, Constant, Expression,
                                    Variable, walk)
from .keyslots import SlotAllocator

_GROW = 2


class AttributeIndex:
    """One secondary index: encoded column value -> row ids.

    Maintenance is vectorized per batch: inserts counting-sort rows by
    bucket, deletes swap-remove lanes. `shadow` mirrors the indexed
    column's encoded values on host so deletes/updates never read the
    device."""

    def __init__(self, capacity: int, dtype, name: str = "?"):
        self.capacity = capacity
        self.dtype = dtype
        self.alloc = SlotAllocator(capacity, name=f"index:{name}")
        self.lanes = np.full((capacity, 4), -1, np.int32)  # bucket -> rows
        self.counts = np.zeros(capacity, np.int32)         # rows per bucket
        self.shadow = np.zeros(capacity, dtype)            # row -> value
        self.bucket_of = np.full(capacity, -1, np.int32)   # row -> bucket
        self._sorted_dirty = True
        self._sorted_vals: Optional[np.ndarray] = None
        self._sorted_rows: Optional[np.ndarray] = None

    # -- maintenance -------------------------------------------------------
    def _key_cols(self, values: np.ndarray) -> List[np.ndarray]:
        if np.issubdtype(self.dtype, np.floating):
            # -0.0 and +0.0 must hash identically (dense `==` matches them)
            values = values + np.dtype(self.dtype).type(0.0)
        return [np.ascontiguousarray(values)]

    def on_write(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Rows were inserted or overwritten with `values` (encoded)."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        values = np.asarray(values, self.dtype)
        if rows.size > 1:
            # a batch may hit one row several times (pkey upsert with a
            # repeated key): only the LAST write per row is live — earlier
            # ones would leave stale lane entries and leaked bucket counts
            _, last_rev = np.unique(rows[::-1], return_index=True)
            keep = rows.size - 1 - last_rev
            if keep.size != rows.size:
                rows = rows[keep]
                values = values[keep]
        # drop stale lane entries for rows that already had a value
        stale = self.bucket_of[rows] >= 0
        if stale.any():
            self._remove_lanes(rows[stale])
        valid = np.ones(rows.shape[0], bool)
        buckets = self.alloc.slots_for(self._key_cols(values), valid)
        self.shadow[rows] = values
        self.bucket_of[rows] = buckets
        # counting-sort style lane fill: group rows by bucket
        order = np.argsort(buckets, kind="stable")
        b_sorted = buckets[order]
        r_sorted = rows[order]
        uniq, start, cnt = np.unique(b_sorted, return_index=True,
                                     return_counts=True)
        need = self.counts[uniq] + cnt
        width = self.lanes.shape[1]
        if need.max(initial=0) > width:
            new_w = max(width * _GROW, int(need.max()))
            self.lanes = np.concatenate(
                [self.lanes, np.full((self.capacity, new_w - width),
                                     -1, np.int32)], axis=1)
        for b, s, c in zip(uniq, start, cnt):
            base = self.counts[b]
            self.lanes[b, base:base + c] = r_sorted[s:s + c]
            self.counts[b] = base + c
        self._sorted_dirty = True

    def _remove_lanes(self, rows: np.ndarray) -> None:
        for r in rows:
            b = self.bucket_of[r]
            if b < 0:
                continue
            n = self.counts[b]
            lane = self.lanes[b, :n]
            hit = np.nonzero(lane == r)[0]
            if hit.size:
                i = hit[0]
                lane[i] = lane[n - 1]
                self.lanes[b, n - 1] = -1
                self.counts[b] = n - 1
                if self.counts[b] == 0:
                    self.alloc.purge([int(b)])
        self.bucket_of[rows] = -1

    def on_delete(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._remove_lanes(rows)
        self._sorted_dirty = True

    def rebuild(self, col: np.ndarray, valid: np.ndarray) -> None:
        """Recreate from a full column (restore path)."""
        self.alloc = SlotAllocator(self.capacity,
                                   name=self.alloc.name)
        self.lanes = np.full((self.capacity, 4), -1, np.int32)
        self.counts[:] = 0
        self.bucket_of[:] = -1
        rows = np.nonzero(valid)[0]
        if rows.size:
            self.on_write(rows, np.asarray(col)[rows])
        self._sorted_dirty = True

    # -- probes ------------------------------------------------------------
    def probe_eq(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """values [B] -> (candidates [B, K] int32 row ids padded -1,
        lane-valid [B, K] bool). One allocator lookup + one gather."""
        values = np.asarray(values, self.dtype)
        valid = np.ones(values.shape[0], bool)
        buckets = self.alloc.slots_for(self._key_cols(values), valid,
                                       lookup_only=True)
        safe = np.clip(buckets, 0, self.capacity - 1)
        cand = self.lanes[safe]                       # [B, K]
        lane_ok = cand >= 0
        lane_ok[buckets < 0] = False
        cand = np.where(lane_ok, cand, -1)
        return cand.astype(np.int32), lane_ok

    def rows_eq(self, value) -> np.ndarray:
        cand, ok = self.probe_eq(np.asarray([value], self.dtype))
        return cand[0][ok[0]].astype(np.int64)

    def _ensure_sorted(self, valid_mask: np.ndarray) -> None:
        if not self._sorted_dirty and self._sorted_vals is not None:
            return
        rows = np.nonzero(valid_mask & (self.bucket_of >= 0))[0]
        vals = self.shadow[rows]
        order = np.argsort(vals, kind="stable")
        self._sorted_vals = vals[order]
        self._sorted_rows = rows[order]
        self._sorted_dirty = False

    def rows_range(self, valid_mask: np.ndarray, op: str,
                   value) -> np.ndarray:
        """Rows satisfying `col <op> value` (op in < <= > >=)."""
        self._ensure_sorted(valid_mask)
        bound = np.asarray(value)
        if (np.issubdtype(self.dtype, np.integer)
                and np.issubdtype(bound.dtype, np.floating)):
            # Compare in the value domain: casting a fractional bound to the
            # integer dtype truncates toward zero, which under-approximates
            # strict probes (`v < 27.5` would miss v==27). O(1) exact
            # adjustment: tighten a fractional bound to the adjacent integer
            # (`v < 27.5` == `v <= 27`); out-of-range bounds resolve to
            # all/none rows.
            import math
            fv = float(bound)
            if math.isnan(fv):
                return self._sorted_rows[:0]
            below = op in ("<", "<=")
            if math.isinf(fv):
                everything = below == (fv > 0)
                return self._sorted_rows if everything \
                    else self._sorted_rows[:0]
            b = math.floor(fv) if below else math.ceil(fv)
            if b != fv:
                op = "<=" if below else ">="
            info = np.iinfo(self.dtype)
            if b > info.max:
                return self._sorted_rows if below else self._sorted_rows[:0]
            if b < info.min:
                return self._sorted_rows[:0] if below else self._sorted_rows
            v = np.asarray(b, self.dtype)
        else:
            v = np.asarray(value, self.dtype)
        if op == "<":
            hi = np.searchsorted(self._sorted_vals, v, side="left")
            return self._sorted_rows[:hi]
        if op == "<=":
            hi = np.searchsorted(self._sorted_vals, v, side="right")
            return self._sorted_rows[:hi]
        if op == ">":
            lo = np.searchsorted(self._sorted_vals, v, side="right")
            return self._sorted_rows[lo:]
        if op == ">=":
            lo = np.searchsorted(self._sorted_vals, v, side="left")
            return self._sorted_rows[lo:]
        raise ValueError(op)


# ---------------------------------------------------------------------------
# Condition planning (reference: CollectionExpressionParser's split into
# indexed + exhaustive parts).
# ---------------------------------------------------------------------------

def _refs_table(expr: Expression, table_id: str, table_attrs,
                unqualified_is_table: bool) -> bool:
    for node in walk(expr):
        if isinstance(node, Variable):
            if node.stream_id == table_id:
                return True
            if (unqualified_is_table and node.stream_id is None
                    and node.attribute_name in table_attrs):
                return True
    return False


def _table_var(expr: Expression, table_id: str, table_attrs,
               unqualified_is_table: bool):
    if isinstance(expr, Variable) and (
            expr.stream_id == table_id or
            (unqualified_is_table and expr.stream_id is None
             and expr.attribute_name in table_attrs)):
        return expr
    return None


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


class IndexPlan:
    """One indexed conjunct + the residual condition.

    kind 'eq': probe_pos/rhs gives per-stream-row candidate buckets.
    kind 'range': constant-bound range (on-demand path).
    """

    def __init__(self, kind: str, pos: int, op: str, rhs: Expression,
                 residual: Optional[Expression]):
        self.kind = kind
        self.pos = pos
        self.op = op
        self.rhs = rhs
        self.residual = residual


def split_index_condition(cond: Expression, table_id: str, schema,
                          indexed_positions: Sequence[int],
                          unqualified_is_table: bool = False,
                          ) -> Optional[IndexPlan]:
    """Find one `table.attr <op> rhs` conjunct where attr is indexed and rhs
    never references the table; return it + the AND-residual. Equality wins
    over range (hash probe beats sorted scan).

    `unqualified_is_table`: whether bare attribute names resolve to the table
    (on-demand store queries) or to the other side (streaming table ops,
    where unqualified names bind to the query output — reference:
    OnDemandQueryParser vs OutputParser scoping)."""
    table_attrs = set(schema.names)
    conjuncts: List[Expression] = []

    def flatten(e: Expression):
        if isinstance(e, And):
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)

    flatten(cond)
    indexed = set(indexed_positions)
    best: Optional[Tuple[int, int, str, Expression]] = None  # (rank, i, op, rhs)
    for i, c in enumerate(conjuncts):
        if not isinstance(c, Compare):
            continue
        for lhs, rhs, op in ((c.left, c.right, c.operator),
                             (c.right, c.left, _FLIP.get(c.operator))):
            if op is None:
                continue
            v = _table_var(lhs, table_id, table_attrs, unqualified_is_table)
            if v is None:
                continue
            pos = schema.position(v.attribute_name)
            if pos not in indexed:
                continue
            if _refs_table(rhs, table_id, table_attrs, unqualified_is_table):
                continue
            if op == "==":
                rank = 0
            elif op in ("<", "<=", ">", ">="):
                rank = 1
            else:
                continue
            if best is None or rank < best[0]:
                best = (rank, i, op, rhs)
                if rank == 0:
                    break
        if best is not None and best[0] == 0:
            break
    if best is None:
        return None
    rank, i, op, rhs = best
    rest = conjuncts[:i] + conjuncts[i + 1:]
    residual: Optional[Expression] = None
    for r in rest:
        residual = r if residual is None else And(residual, r)
    v = _table_var(conjuncts[i].left, table_id, table_attrs,
                   unqualified_is_table) or \
        _table_var(conjuncts[i].right, table_id, table_attrs,
                   unqualified_is_table)
    pos = schema.position(v.attribute_name)
    kind = "eq" if op == "==" else "range"
    if kind == "range" and not isinstance(rhs, Constant):
        # batched range probes degrade to the dense path; only the
        # constant-bound (on-demand) form uses the sorted view
        return None
    return IndexPlan(kind, pos, op, rhs, residual)
