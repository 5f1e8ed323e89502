"""The kernel's filter bytecode computes what the port's expression compiler
computes.

Each pattern-filter case compiles twice: to a column function by
`core.executor.compile_expression`, and to bytecode by
`kernels.filter_bytecode.compile_filter`, which the plain PyTorch
interpreter `interpret` then runs over the same columns (the incoming event
under the atom's own ref, an earlier capture under `e1`).  The two boolean
columns must be equal.  Tolerance: none (booleans, compared exactly).
"""
import struct

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.executor import CompileError, Scope, \
    compile_expression
from siddhi_tpu_torch.core.pattern import linearize
from siddhi_tpu_torch.kernels import filter_bytecode as fb

STREAM = "define stream S (i int, l long, f float, d double, s string, " \
         "b bool);\n"
N = 128

CASES = [
    "i > 5", "l <= 3", "f >= 0.5", "d < f", "i == l", "f != i",
    "s == 'IBM'", "s != 'WSO2'", "b == true", "not b", "b and i > 0",
    "i > 0 and f < 0.5", "i < 0 or d > 1.0", "not (i > 0)",
    "i is null", "f is null", "s is null", "not (l is null)",
    "i + l > 100", "i * 2 == l", "f / 2.0 > d", "l / i > 1",
    "i / 0 == 0", "(i - 3) * f <= 10.5", "i > 5L", "l > 2.5", "f == 1",
    "d >= -0.0", "1 == 1", "i - 2147483647 < 0", "l * l > 100",
    "(i + 1) is null", "-i > 3", "i / -3 == -2", "l / 7 < -1",
    "f > e1.f", "e1.i + i == 0", "e1.s == s", "e1.l is null",
    "i != e1.l", "e1.f * 2.0 < f - 1", "e1.b or b",
    "price_like_const > 1.5",
]


def columns(seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(-20, 20, N).astype(np.int32)
    i[:4] = [2147483647, -2147483647, 0, 7]
    l = rng.integers(-50, 50, N).astype(np.int64)
    l[:2] = [2**40, -2**40]
    f = (rng.normal(size=N) * 3).astype(np.float32)
    f[::11] = 0.0
    f[1::13] = -0.0
    d = (rng.normal(size=N) * 3).astype(np.float32)
    s = rng.integers(-1, 4, N).astype(np.int32)
    b = rng.random(N) < 0.5
    i[rng.random(N) < 0.15] = ev.NULL_INT
    l[rng.random(N) < 0.15] = ev.NULL_LONG
    f[rng.random(N) < 0.15] = np.nan
    d[rng.random(N) < 0.15] = np.nan
    return [torch.from_numpy(c) for c in (i, l, f, d, s, b)]


def compiled(text):
    if text == "price_like_const > 1.5":
        text = "2.5 > 1.5"
    app = SiddhiCompiler.parse(STREAM + f"from every e1=S -> e2=S[{text}] "
                               "select e1.i as x insert into O;")
    interner = ev.StringInterner()
    for w in ("IBM", "WSO2", "GOOG"):
        interner.intern(w)
    schema = ev.Schema(app.stream_definition_map["S"], interner)
    scope = Scope()
    scope.interner = interner
    scope.add_source("e2", schema, default=True)
    scope.add_source("e1", schema, default=False)
    expr = linearize(app.execution_element_list[0].input_stream) \
        .atoms[1].filter_expr
    return expr, scope


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("text", CASES)
def test_bytecode_matches_compiled_expression(text, seed):
    expr, scope = compiled(text)
    own, cap = columns(seed), columns(seed + 50)
    want = compile_expression(expr, scope).fn({"e2": tuple(own),
                                               "e1": tuple(cap)})
    code = fb.compile_filter(expr, scope, "e2", {"e1": 0, "e2": 1})
    got = fb.interpret(code, lambda c: own[c],
                       lambda a, c: (cap if a == 0 else own)[c])
    assert torch.equal(torch.broadcast_to(got, (N,)),
                       torch.broadcast_to(want, (N,)))


@pytest.mark.parametrize("text", ["i % 3 == 1", "math:abs(i) > 1",
                                  "eventTimestamp() > 0"])
def test_outside_subset_raises(text):
    expr, scope = compiled(text)
    with pytest.raises(CompileError):
        fb.compile_filter(expr, scope, "e2", {"e1": 0, "e2": 1})


def test_constant_words():
    assert fb._words(-5, "INT") == (-5, -1)
    assert fb._words(2**40 + 3, "LONG") == (3, 256)
    assert fb._words(-(2**40), "LONG") == (0, -256)
    lo, hi = fb._words(-1.5, "FLOAT")
    assert struct.unpack("<f", struct.pack("<i", lo))[0] == -1.5
    assert hi == -1


def test_load_kinds():
    expr, scope = compiled("f > e1.f and i > 0")
    code = fb.compile_filter(expr, scope, "e2", {"e1": 0, "e2": 1})
    assert code[:2] == [fb.LOAD_EV, 2]
    assert code[2:5] == [fb.LOAD_CAP, 0, 2]


@pytest.mark.parametrize("text,want", [
    ("i > 5", []),
    ("f > e1.f", [(0, 2)]),
    ("e1.f * 2.0 < f - 1 and e1.i + i == 0 or e1.f > 0.0",
     [(0, 2), (0, 0)]),
])
def test_cap_loads(text, want):
    expr, scope = compiled(text)
    code = fb.compile_filter(expr, scope, "e2", {"e1": 0, "e2": 1})
    assert fb.cap_loads(code) == want
