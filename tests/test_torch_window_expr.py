"""The port's expression windows (`core/window_expr.py`, the plain versions
of K25 `expr_window` and K26 `expr_batch` in `kernels/expr_window.py`)
against the JAX package.

Whole apps first (events exact: order, ts, kind, values):
`chip_smoke.X12_CASES` holds the JAX package's events of the slice's
corpus X4 (`tests/test_window_expr.py`'s six apps; `avg` / `min` / `max` /
`first.x` / `last.x` / `eventTimestamp(first|last)`; `%` on negatives; a
weak float constant against an f32 column at its boundary; the clamp at
j = hi - C; a run above C; include.triggering.event and
stream.current.event; a NaN row), each at the top level, in a value
partition and in a range partition; the port gives them, and the JAX
package recomputes them (the top-level cases here, the partition cases
in `test_torch_x4_jax.py`).  Then the top-level step from a JAX
state carried across with `convert.expr_state_from_jax`: every valid
row (ts, kind, seq, group slot, columns) and the window's rows and
counter equal to the JAX `process`'s, over random batches with invalid
rows, NaN and -0.0 values (the JAX step jitted once per window).
Tolerance: exact (integer-valued and quarter-valued data: every f64
prefix sum is exact).  Then JAX's type promotion as the range compiler
copies it, and the expressions that raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.window import Rows as JRows
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core import window_expr as we
from siddhi_tpu_torch.core.window import NO_WAKEUP
from siddhi_tpu_torch.exceptions import CompileError
from siddhi_tpu_torch.kernels import expr_window as ew

CASES = [c for c in chip_smoke.X12_CASES
         if c[0].split()[0] in ("top", "value", "range")
         and "Frequent" not in c[0]]
# the cases recomputed on the JAX package here: every top-level case and
# two partition cases (`test_torch_x4_jax.py` recomputes the others)
JAX_RECHECK = tuple(c[0] for c in CASES if c[0].split()[0] == "top") + \
    ("value clamp at hi - C", "range stream current")


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """The port gives X4's events (the JAX package's) on the CPU."""
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


@pytest.mark.parametrize("name", JAX_RECHECK)
def test_corpus_is_the_jax_events(name):
    """X4's expectations are the JAX package's events."""
    _, ql, qname, sends, want = next(c for c in CASES if c[0] == name)
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want


# -- the top-level step, from a converted state ------------------------------

STEP_QL = """
define stream S (k long, v float, w int, b bool);
@capacity(window='{C}')
@info(name='q') from S#window.{win} select k, v, w insert all events into O;
"""
WINDOWS = {
    "expression('sum(v) < 12.0 and count() <= 6')": 8,
    "expression('max(v) - min(v) < 6.5 or last.w % 3 == 0')": 8,
    "expression('avg(w) >= first.v - 2.0')": 5,
    "expressionBatch('sum(w) < 20', true)": 8,
    "expressionBatch('last.b == first.b', false, true)": 5,
    "expressionBatch('count() <= 9')": 4,
}


@pytest.fixture(scope="module")
def plans():
    """Each window's JAX and port plans and the jitted JAX step, built
    once for the module."""
    cache = {}

    def get(win):
        if win not in cache:
            ql = STEP_QL.format(win=win, C=WINDOWS[win])
            jq = JaxManager().create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            cache[win] = (jq.planned, tq.planned, jq.state[0],
                          jax.jit(jq.planned.window.process))
        return cache[win]
    return get


def _batch(rng, B, t0):
    valid = rng.random(B) >= 0.1
    v = (rng.integers(-8, 24, B) / 4).astype(np.float32)
    v[rng.random(B) < 0.05] = np.nan
    v[rng.random(B) < 0.05] = -0.0
    cols = [rng.integers(0, 5, B).astype(np.int64), v,
            rng.integers(-6, 9, B).astype(np.int32), rng.random(B) < 0.5]
    ts = t0 + np.sort(rng.integers(0, 6, B)).astype(np.int64)
    return ts, valid, cols, (cols[0] % 3).astype(np.int32)


def _same_state(jstate, slab, mode):
    a = convert.keyed_slab_logical(convert._stack_one(jstate), mode)
    b = convert.keyed_slab_logical(slab, mode)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("win", list(WINDOWS))
def test_step_equals_the_jax_step(win, plans):
    """Every step of the port's plain K25 / K26 at the top level (one key
    row whose events are the batch) equals the JAX window's `process`,
    from a state converted after two JAX steps."""
    jp, tp, jstate, jstep = plans(win)
    prm = tp.window.params()
    mode = ew.MODE_EXPRB if prm.batch else ew.MODE_EXPR
    rng = np.random.default_rng(sum(win.encode()))
    slab, rows = None, 0
    for i in range(7):
        B = 12
        ts, valid, cols, gslot = _batch(rng, B, 1000 + 10 * i)
        if i == 2:
            slab = convert.expr_state_from_jax(tp.window, jstate,
                                               tp.in_schema.types)
            _same_state(jstate, slab, mode)
        kind = np.full(B, ev.CURRENT, np.int32)
        jrows = JRows(ts=ts, kind=kind, valid=valid,
                      seq=np.zeros(B, np.int64), gslot=gslot,
                      cols=tuple(cols))
        jstate, jout = jstep(jstate, jrows, np.int64(1000 + 10 * i))
        if i < 2:
            continue
        out, wake = ew.plain(
            slab, tp.filter_spec, torch.from_numpy(ts),
            torch.from_numpy(kind), torch.from_numpy(valid),
            torch.from_numpy(gslot), [torch.from_numpy(c) for c in cols],
            torch.zeros(1, dtype=torch.int32),
            torch.arange(B, dtype=torch.int32).view(1, B), 0, prm)
        jv = np.asarray(jout.rows.valid)
        n = int(jv.sum())
        assert np.array_equal(jv[:n], np.ones(n, np.bool_))
        r = jout.rows
        assert out.ts.tolist() == np.asarray(r.ts)[:n].tolist(), i
        assert out.kind.tolist() == np.asarray(r.kind)[:n].tolist(), i
        assert out.seq.tolist() == np.asarray(r.seq)[:n].tolist(), i
        assert out.gslot.tolist() == np.asarray(r.gslot)[:n].tolist(), i
        for x, y in zip(out.cols, r.cols):
            x, y = x.numpy(), np.asarray(y)[:n]
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), i
        assert wake.tolist() == [NO_WAKEUP, 0]
        _same_state(jstate, slab, mode)
        rows += n
    assert rows > 0


def test_state_round_trip(plans):
    """A JAX top-level state carried across with `expr_state_from_jax`
    and back with `keyed_slab_to_jax` comes back as it was, the
    expressionBatch's previous batch (C + 1 rows) included."""
    for win in ("expression('sum(v) < 12.0 and count() <= 6')",
                "expressionBatch('sum(w) < 20', true)"):
        jp, tp, jstate, jstep = plans(win)
        rng = np.random.default_rng(5)
        for i in range(4):
            ts, valid, cols, gslot = _batch(rng, 12, 1000 + 10 * i)
            cols[1] = np.nan_to_num(cols[1])     # no NaN empties the window
            jstate, _ = jstep(jstate, JRows(
                ts=ts, kind=np.zeros(12, np.int32), valid=valid,
                seq=np.zeros(12, np.int64), gslot=gslot, cols=tuple(cols)),
                np.int64(0))
        slab = convert.expr_state_from_jax(tp.window, jstate,
                                           tp.in_schema.types)
        back = convert.keyed_slab_to_jax(slab)
        again = convert.keyed_slab_from_jax(back, slab.mode, slab.types)
        _same_state(jstate, again, slab.mode)
        held = int(slab.count[0])
        if slab.p_count is not None:
            held += int(slab.p_count[0])
        assert held > 0


# -- the range compiler ------------------------------------------------------

_SAMPLES = {"i32": jnp.ones(2, jnp.int32), "i64": jnp.ones(2, jnp.int64),
            "f32": jnp.ones(2, jnp.float32), "f64": jnp.ones(2, jnp.float64),
            "b": jnp.ones(2, jnp.bool_), "wi": jnp.asarray(3),
            "wf": jnp.asarray(1.5)}


def test_promotion_is_jax():
    """The compiler's promotion lattice gives JAX's result type for every
    pair of operand types (weak constants included)."""
    code = {"int32": we.T_I32, "int64": we.T_I64, "float32": we.T_F32,
            "float64": we.T_F64, "bool": we.T_BOOL}
    for a, x in _SAMPLES.items():
        for b, y in _SAMPLES.items():
            r = x + y
            t = we.join(a, b)
            assert we._CODE[t] == code[str(r.dtype)], (a, b)
            assert (t in ("wi", "wf")) == bool(r.weak_type), (a, b)


def test_weak_constant_compares_in_f32():
    """An f32 column against a float constant compares in f32 (the
    constant rounded to f32), a count against an int in int64, an int32
    column plus a float constant in float64."""
    schema = chip_smoke_schema()
    p = we.compile_range_expr(
        _parse("last.price < 100.1 and count() <= 2 and last.v + 0.5 > 0"),
        schema)
    cmps = [(p.code[i + 1], p.code[i + 2]) for i in range(len(p.code) - 2)
            if p.code[i] == we.R_CMP]
    assert [t for _, t in cmps] == [we.T_F32, we.T_I64, we.T_F64]


def chip_smoke_schema():
    from siddhi_tpu_torch.query_api.definition import StreamDefinition
    d = StreamDefinition("S")
    for n, t in (("sym", "STRING"), ("price", "FLOAT"), ("v", "INT")):
        d.attribute(n, t)
    return ev.Schema(d, ev.StringInterner())


def _parse(text):
    from siddhi_tpu_torch.compiler.parser import Parser
    return Parser(text).parse_expression()


@pytest.mark.parametrize("win,match", [
    ("expression(5)", "constant string expression"),
    ("expression('sum(first.price) < 2')",
     "not allowed inside window-expression aggregates"),
    ("expression('stdDev(price) < 2')", "unsupported function 'stdDev'"),
    ("expression('e1.price < 2')", "expression window reference 'e1'"),
    ("expressionBatch('sym == \"a\"')", "string constants"),
    ("expressionBatch('price is null')", "unsupported node"),
])
def test_expressions_that_raise(win, match):
    """The reference's reasons, raised at plan time (CompileError), at
    the top level and inside a partition."""
    for body in ("@info(name='q') from S#window.{w} select v insert into "
                 "O;",
                 "partition with (sym of S) begin @info(name='q') from "
                 "S#window.{w} select v insert into O; end;"):
        ql = chip_smoke._XS + body.format(w=win)
        with pytest.raises(CompileError, match=match):
            TorchManager(device="cpu").create_siddhi_app_runtime(ql)
