"""The port's expression compiler agrees with the JAX package's.

Pattern-filter expressions (compares across types, arithmetic, and/or/not,
the in-band null rules, references to an earlier capture) and value
expressions are compiled by both packages over the same columns (numpy
seed, nulls in every nullable type) and must give equal columns.
Tolerance: booleans and integers exact; float32 results exact, NaN equal
to NaN (both sides run the same IEEE single-precision operations).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siddhi_tpu.compiler import SiddhiCompiler as JC
from siddhi_tpu.core import event as jev
from siddhi_tpu.core.executor import Scope as JScope
from siddhi_tpu.core.executor import compile_expression as jcompile
from siddhi_tpu.core.pattern import linearize as jlinearize
from siddhi_tpu_torch.compiler import SiddhiCompiler as TC
from siddhi_tpu_torch.core import event as tev
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.core.executor import Scope as TScope
from siddhi_tpu_torch.core.executor import compile_expression as tcompile
from siddhi_tpu_torch.core.pattern import linearize as tlinearize

STREAM = "define stream S (i int, l long, f float, d double, s string, " \
         "b bool);\n"
N = 96

FILTERS = [
    "i > 5", "l <= 3", "f >= 0.5", "d < f", "i == l", "f != i",
    "s == 'IBM'", "s != 'WSO2'", "b == true", "not b", "b and i > 0",
    "i > 0 and f < 0.5", "i < 0 or d > 1.0", "not (i > 0)",
    "i is null", "f is null", "s is null", "not (l is null)",
    "i + l > 100", "i * 2 == l", "f / 2.0 > d", "l / i > 1",
    "i / 0 == 0", "(i - 3) * f <= 10.5", "i % 3 == 1", "i > 5L",
    "l > 2.5", "f == 1", "d >= -0.0",
    "f > e1.f", "e1.i + i == 0", "e1.s == s", "e1.l is null",
    "i != e1.l", "price_free_constant_true", "e1.f * 2.0 < f - 1",
]
VALUES = ["i + l", "f * i", "l / i", "i / l", "i % 3", "l % 7", "d - f",
          "i * 2", "l * l", "f / 0.0", "i / 0", "f % 2.0", "i - 2147483647"]


def columns(seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(-20, 20, N).astype(np.int32)
    l = rng.integers(-50, 50, N).astype(np.int64)
    f = (rng.normal(size=N) * 3).astype(np.float32)
    f[::11] = 0.0
    f[1::13] = -0.0
    d = (rng.normal(size=N) * 3).astype(np.float32)
    s = rng.integers(-1, 4, N).astype(np.int32)     # interned ids, -1 null
    b = rng.random(N) < 0.5
    i[rng.random(N) < 0.15] = tev.NULL_INT
    l[rng.random(N) < 0.15] = tev.NULL_LONG
    f[rng.random(N) < 0.15] = np.nan
    d[rng.random(N) < 0.15] = np.nan
    return [i, l, f, d, s, b]


def filter_expr(compiler, linearize, text):
    if text == "price_free_constant_true":
        text = "1 == 1"
    app = compiler.parse(STREAM + f"from every e1=S -> e2=S[{text}] "
                         "select e1.i as x insert into O;")
    return linearize(app.execution_element_list[0].input_stream) \
        .atoms[1].filter_expr


def value_expr(compiler, text):
    app = compiler.parse(STREAM + f"from S select {text} as x "
                         "insert into O;")
    return app.execution_element_list[0].selector.selection_list[0] \
        .expression


def scopes():
    ji, ti = jev.StringInterner(), tev.StringInterner()
    for w in ("IBM", "WSO2", "GOOG", "X"):
        ji.intern(w)
        ti.intern(w)
    japp = JC.parse(STREAM)
    tapp = TC.parse(STREAM)
    js = jev.Schema(japp.stream_definition_map["S"], ji)
    ts = tev.Schema(tapp.stream_definition_map["S"], ti)
    jscope, tscope = JScope(), TScope()
    jscope.interner, tscope.interner = ji, ti
    for sc, schema in ((jscope, js), (tscope, ts)):
        sc.add_source("e2", schema, default=True)
        sc.add_source("e1", schema, default=False)
        sc.add_source("S", schema, default=False)
    return jscope, tscope


def envs(seed):
    own, cap = columns(seed), columns(seed + 100)
    jenv = {"e2": tuple(jnp.asarray(c) for c in own),
            "e1": tuple(jnp.asarray(c) for c in cap)}
    tenv = {"e2": tuple(torch.from_numpy(c) for c in own),
            "e1": tuple(torch.from_numpy(c) for c in cap)}
    return jenv, tenv


def assert_same(t, j):
    j = np.broadcast_to(np.asarray(j), (N,))
    t = torch.broadcast_to(t, (N,)).numpy()
    assert t.dtype == j.dtype
    if t.dtype.kind == "f":
        np.testing.assert_array_equal(t, j)     # NaN == NaN here
    else:
        assert (t == j).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("text", FILTERS)
def test_filter_expressions_agree(text, seed):
    jscope, tscope = scopes()
    jenv, tenv = envs(seed)
    je = jcompile(filter_expr(JC, jlinearize, text), jscope)
    te = tcompile(filter_expr(TC, tlinearize, text), tscope)
    assert te.type == je.type == "BOOL"
    assert_same(te.fn(tenv), je.fn(jenv))


@pytest.mark.parametrize("text", VALUES)
def test_value_expressions_agree(text):
    jscope, tscope = scopes()
    jenv, tenv = envs(3)
    jenv["S"], tenv["S"] = jenv["e2"], tenv["e2"]
    je = jcompile(value_expr(JC, text), jscope)
    te = tcompile(value_expr(TC, text), tscope)
    assert te.type == je.type
    assert_same(te.fn(tenv), je.fn(jenv))


@pytest.mark.parametrize("text", ["math:abs(i) > 1", "minimum(i, 0) > 1",
                                  "maximum(i, 0) > 1"])
def test_unported_expressions_raise(text):
    _, tscope = scopes()
    with pytest.raises(CompileError):
        tcompile(filter_expr(TC, tlinearize, text), tscope)
