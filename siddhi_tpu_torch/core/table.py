"""In-memory tables (port of `TableCondition` and `TableRuntime`,
`siddhi_tpu/core/table.py:33-411`).

Reference behaviour (what): a table is a fixed-capacity columnar store;
`@PrimaryKey` rows map to dense slots through the host `SlotAllocator`, so
a keyed insert overwrites its key's row; `@Index` attributes keep host
lane tables (`core/table_index.py`); delete, update and update-or-insert
run a condition over (batch row, table row) pairs, through an index probe
when one conjunct is `T.attr == <batch expr>` on an indexed attribute.

How the port runs it: the columns, ts and valid live on the table's
device as tensors and are updated in place.  Slot resolution, the
append / free-row bookkeeping and the index probes stay on the host, as in
the reference.  The device work is two kernels, each with its plain
version on the CPU: K9 `table_write` (the row scatter, with the last row
of a batch winning a shared slot, and the masked delete) and K10
`table_match` (hit / src / matched_any, dense or over the host's
candidates).  The set expressions of an update are torch ops over [C].

Not ported, raising: `@store` tables (`RecordTableRuntime`, ROADMAP A15);
table snapshots (`_table_state` / `_restore_table_state`, A13).
"""
from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..query_api.definition import TableDefinition
from ..query_api.expression import Expression
from . import event as ev
from .executor import CompileError, CompiledExpr, Scope, compile_expression
from .keyslots import SlotAllocator
from .table_index import AttributeIndex, IndexPlan, split_index_condition


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class TableCondition:
    """A compiled table condition and its optional index plan (reference:
    CollectionExpressionParser splits a condition into an indexed probe
    and a residual).  `compiled` is the full condition; `spec` its
    `kernels.table_match.MatchSpec` for delete / update / upsert (None for
    an on-demand FIND, which evaluates on the host); `rhs_host` the
    indexed conjunct's batch side compiled for host tensors."""

    def __init__(self, compiled: CompiledExpr,
                 plan: Optional[IndexPlan] = None, rhs_fn=None, spec=None,
                 rhs_host=None):
        self.compiled = compiled
        self.plan = plan
        self.rhs_fn = rhs_fn
        self.spec = spec
        self.rhs_host = rhs_host


class TableRuntime:
    def __init__(self, definition: TableDefinition, schema: ev.Schema,
                 device: torch.device, capacity: int = 4096):
        if definition.get_annotation("store") is not None:
            raise CompileError(
                f"@store table {definition.id!r}: record tables are not yet "
                f"ported (ROADMAP A15)")
        self.definition = definition
        self.schema = schema
        self.device = device
        cap_ann = definition.get_annotation("capacity")
        if cap_ann:
            capacity = int(cap_ann.element("rows", capacity))
        self.capacity = capacity
        self._lock = threading.RLock()

        pk = definition.get_annotation("PrimaryKey")
        self.pkey_positions: Optional[List[int]] = None
        self.allocator: Optional[SlotAllocator] = None
        if pk is not None:
            names = pk.positional_elements()
            self.pkey_positions = [schema.position(n) for n in names]
            self.allocator = SlotAllocator(capacity,
                                           name=f"table:{definition.id}")
        # @Index('a', 'b') declares one secondary index per attribute
        self.indexes: Dict[int, AttributeIndex] = {}
        idx_ann = definition.get_annotation("Index")
        if idx_ann is not None:
            for n in idx_ann.positional_elements():
                p = schema.position(n)
                if self.pkey_positions == [p]:
                    continue  # the primary key is already an index
                self.indexes[p] = AttributeIndex(
                    capacity, ev.np_dtype(schema.types[p]),
                    name=f"{definition.id}.{n}")
        self.index_stats = {"indexed": 0, "dense": 0}
        # device state, updated in place by K9
        self.cols = tuple(
            torch.full((capacity,), ev.default_value(t), dtype=d,
                       device=device)
            for t, d in zip(schema.types, schema.dtypes))
        self.ts = torch.zeros((capacity,), dtype=torch.int64, device=device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool,
                                 device=device)
        # K9's per-slot claim words (-1 between launches)
        self._win = torch.full((capacity,), -1, dtype=torch.int32,
                               device=device) \
            if device.type == "cuda" else None
        self._append_ptr = 0  # non-keyed append position (host-tracked)
        self._free_rows: List[int] = []
        # bumped by every write, delete and update: the `in` probes' hash
        # sets (kernels/in_probe.py, one per compare type) rebuild when
        # they are older
        self.version = 0
        self.in_sets: Dict[int, object] = {}

    # -- row-slot resolution --------------------------------------------------
    def _slots_for_batch(self, staged_cols: Sequence[np.ndarray],
                         valid: np.ndarray, insert: bool) -> np.ndarray:
        """Target row per batch event (primary-key tables)."""
        key_cols = [staged_cols[i] for i in self.pkey_positions]
        return self.allocator.slots_for(key_cols, valid,
                                        lookup_only=not insert)

    def _append_slots(self, n: int) -> np.ndarray:
        """Rows for n appended events: freed rows first, the most recently
        freed first (the reference pops its list's tail one at a time),
        then the append pointer."""
        free = self._free_rows
        k = min(n, len(free))
        out = np.empty((n,), np.int32)
        out[:k] = free[len(free) - k:][::-1]
        del free[len(free) - k:]
        rest = n - k
        if rest > self.capacity - self._append_ptr:
            self._append_ptr = self.capacity
            raise RuntimeError(
                f"table {self.definition.id!r} capacity {self.capacity} "
                f"exhausted; use @capacity(rows='...')")
        out[k:] = np.arange(self._append_ptr, self._append_ptr + rest)
        self._append_ptr += rest
        return out

    # -- public API -----------------------------------------------------------
    def insert(self, batch: ev.EventBatch, staged: ev.StagedBatch) -> None:
        """Insert CURRENT rows (keyed: upsert on primary key; else append).
        UUID() sentinels (the reference's `_materialize_uuids`) cannot
        reach a table before the functions are ported (ROADMAP A4)."""
        from ..kernels.table_write import write
        with self._lock:
            n = int(np.sum(staged.valid))
            if n == 0:
                return
            if self.pkey_positions is not None:
                slots = self._slots_for_batch(staged.cols, staged.valid, True)
            else:
                slots = np.full((staged.valid.shape[0],), -1, np.int32)
                slots[staged.valid] = self._append_slots(n)
            if self.indexes:
                mask = staged.valid & (slots >= 0)
                rows = slots[mask].astype(np.int64)
                for pos, idx in self.indexes.items():
                    idx.on_write(rows, np.asarray(staged.cols[pos])[mask])
            dev = self.device
            write(self.cols, self.ts, self.valid, self._win, batch.cols,
                  batch.ts, _h2d(slots.astype(np.int32), dev),
                  _h2d(staged.valid, dev))
            self.version += 1

    def plan_condition(self, cond_expr: Expression, scope: Scope,
                       table_id: Optional[str] = None,
                       unqualified_is_table: bool = False,
                       other_key: Optional[str] = None) -> TableCondition:
        """Compile a table condition with index-aware planning: if one AND
        conjunct is `table.attr == <stream expr>` on an indexed attribute
        (or a single-column primary key), matches probe that index instead
        of evaluating every pair.  `other_key` names the batch side of a
        delete / update / upsert: its condition also gets the K10 spec (on
        CUDA its bytecode, or NotImplementedError outside the kernels'
        subset).  `table_id` / `unqualified_is_table` override the scoping
        for on-demand queries (alias id, bare names bind to the table)."""
        tkey = table_id or self.definition.id
        compiled = compile_expression(cond_expr, scope)
        spec = None
        if other_key is not None:
            from ..kernels.filter_bytecode import compile_filter
            from ..kernels.table_match import MatchSpec
            code = None
            if self.device.type == "cuda":
                try:
                    code = compile_filter(cond_expr, scope, other_key, {},
                                          tkey)
                except CompileError as exc:
                    raise NotImplementedError(
                        f"the condition on table {self.definition.id!r} is "
                        f"outside the CUDA kernels' subset: {exc}") from exc
            spec = MatchSpec(tkey, other_key, compiled, code)
        probe_positions = list(self.indexes)
        if self.pkey_positions is not None and len(self.pkey_positions) == 1:
            probe_positions.append(self.pkey_positions[0])
        plan = None
        if probe_positions:
            plan = split_index_condition(
                cond_expr, tkey, self.schema, probe_positions,
                unqualified_is_table=unqualified_is_table)
        if plan is None or (plan.kind == "range" and
                            plan.pos not in self.indexes):
            # (the primary key has no sorted view for range probes)
            return TableCondition(compiled, spec=spec)
        rhs_fn = compile_expression(plan.rhs, scope).fn
        host_scope = copy.copy(scope)
        host_scope.device = torch.device("cpu")
        rhs_host = compile_expression(plan.rhs, host_scope).fn
        return TableCondition(compiled, plan, rhs_fn, spec, rhs_host)

    def _probe_candidates(self, pos: int, values: np.ndarray):
        """values [B] -> (cand [B, K] int32, ok [B, K] bool)."""
        values = np.asarray(values).astype(
            ev.np_dtype(self.schema.types[pos]))
        if pos in self.indexes:
            return self.indexes[pos].probe_eq(values)
        # single-column primary key: the slot allocator IS the index
        slots = self.allocator.slots_for(
            [np.ascontiguousarray(values)],
            np.ones(values.shape[0], bool), lookup_only=True)
        cand = slots.astype(np.int32)[:, None]
        return cand, cand >= 0

    def probe_rows(self, pos: int, values: np.ndarray):
        """Index probe for the equi-join fast path: candidate row ids per
        value through the @Index lane table or the primary-key allocator.
        Candidates narrow; the caller's full-condition re-check decides."""
        self.index_stats["indexed"] += 1
        return self._probe_candidates(pos, values)

    def _match(self, cond: TableCondition, other_key: str,
               batch: ev.EventBatch,
               staged: Optional[ev.StagedBatch] = None):
        """(hit bool[C], src int32[C] the last matching batch row or -1,
        and matched_any(), a thunk for the host's [B] mask of batch rows
        that matched), on the table's device: K10, dense or over the
        index probe's candidates."""
        from ..kernels.table_match import table_match
        plan = cond.plan
        if plan is None or plan.kind != "eq":
            self.index_stats["dense"] += 1
            hit, src, anyb = table_match(cond.spec, batch.cols, batch.ts,
                                         batch.valid, self.cols, self.valid)
            return hit, src, lambda: anyb.cpu().numpy()
        self.index_stats["indexed"] += 1
        # batch-side key values [B] on the host: from the staged columns
        # when the caller has them, else one small device read
        if staged is not None:
            env = {other_key: tuple(torch.from_numpy(np.asarray(c))
                                    for c in staged.cols),
                   "__ts__": torch.from_numpy(np.asarray(staged.ts))}
            vals = np.asarray(cond.rhs_host(env))
        else:
            vals = cond.rhs_fn({other_key: batch.cols,
                                "__ts__": batch.ts}).cpu().numpy()
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (batch.ts.shape[0],))
        cand, ok = self._probe_candidates(plan.pos, vals)       # [B, K]
        cand = np.where(ok, cand, -1).astype(np.int32)
        hit, src, anyb = table_match(
            cond.spec, batch.cols, batch.ts, batch.valid, self.cols,
            self.valid, cand=_h2d(cand, self.device))
        return hit, src, lambda: anyb.cpu().numpy()

    def delete_where(self, cond: TableCondition, other_key: str,
                     batch: ev.EventBatch, staged=None) -> None:
        from ..kernels.table_write import masked_delete
        with self._lock:
            kill, _, _ = self._match(cond, other_key, batch, staged)
            masked_delete(self.valid, kill)
            self.version += 1
            self._reclaim(kill.cpu().numpy())

    def _reclaim(self, kill: np.ndarray) -> None:
        killed = np.nonzero(kill)[0]
        if self.pkey_positions is not None:
            if killed.size:
                self.allocator.purge(killed.tolist())
        else:
            self._free_rows.extend(int(x) for x in killed)
        if killed.size:
            for idx in self.indexes.values():
                idx.on_delete(killed)

    def update_where(self, cond: TableCondition, other_key: str,
                     batch: ev.EventBatch,
                     set_fns: List[Tuple[int, Callable]],
                     upsert: bool = False,
                     staged: Optional[ev.StagedBatch] = None,
                     insert_map: Optional[List[int]] = None) -> None:
        """set_fns: [(table_col_pos, fn(env) -> value)], applied from the
        LAST matching batch row of each table row.  Every set expression
        reads the table's columns as they were before the update."""
        with self._lock:
            hit, src, matched_any = self._match(cond, other_key, batch,
                                                staged)
            B = batch.ts.shape[0]
            src_c = torch.clamp(src.to(torch.int64), 0, max(B - 1, 0))
            env = {
                other_key: tuple(c[src_c] for c in batch.cols),
                self.definition.id: self.cols,
                "__ts__": batch.ts[src_c],
            }
            # index maintenance needs host rows only when a set expression
            # writes an indexed column
            touches_index = any(pos in self.indexes for pos, _ in set_fns)
            hit_rows = (np.nonzero(hit.cpu().numpy())[0]
                        if touches_index else None)
            new_vals = []
            for pos, fn in set_fns:
                val = torch.as_tensor(fn(env), device=self.device)
                if val.dim() == 0:      # constant set expressions are 0-d
                    val = torch.broadcast_to(val, (self.capacity,))
                # (a `set T.s = UUID()` would need the reference's
                # `_materialize_uuid_col`; UUID() is ROADMAP A4)
                new_vals.append((pos, torch.where(
                    hit, val.to(self.cols[pos].dtype), self.cols[pos])))
                if pos in self.indexes and hit_rows is not None \
                        and hit_rows.size:
                    self.indexes[pos].on_write(
                        hit_rows, val.cpu().numpy()[hit_rows])
            for pos, v in new_vals:
                self.cols[pos].copy_(v)
            self.version += 1
            if upsert and staged is not None:
                miss = staged.valid & ~matched_any()
                if miss.any():
                    sub_staged = ev.StagedBatch(
                        staged.ts, staged.kind, miss,
                        [staged.cols[i] for i in insert_map]
                        if insert_map else staged.cols, int(miss.sum()))
                    sub_batch = ev.EventBatch(
                        batch.ts, batch.kind, _h2d(miss, self.device),
                        tuple(batch.cols[i] for i in insert_map)
                        if insert_map else batch.cols)
                    self.insert(sub_batch, sub_staged)

    def all_rows_batch(self) -> ev.EventBatch:
        """The table's rows as a batch (on-demand queries)."""
        return ev.EventBatch(self.ts, torch.zeros(self.ts.shape,
                                                  dtype=torch.int32,
                                                  device=self.device),
                             self.valid, self.cols)
