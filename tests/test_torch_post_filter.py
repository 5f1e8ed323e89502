"""Filters after the window: the plain version of kernel K15
(`kernels/post_filter.py`) agrees with the JAX package's `_apply_chain`
over the post-window chain (`siddhi_tpu/core/planner.py:124`) on rows of
every kind (CURRENT and EXPIRED filtered; TIMER and RESET rows and
invalid rows untouched) with bool, int, long and float columns and nulls;
its bytecode, interpreted, gives the same flags; whole queries with a
filter after every window kind, at the top level and in a partition, and
with `in Table`, give the JAX package's events; a post chain compiles to
bytecode when planned for CUDA, and one outside the bytecode subset
raises there naming ROADMAP B10.  chip_smoke.py's PF1 checks (config 1
with `[price > 0.5]` after its window) are held to the port's rows at a
small size, with the JAX package giving the same events.

Inputs come from numpy seeds.  Tolerance: exact (flags, counts, rows);
float sums of dyadic values (k/64) below 2^17, where any order is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_partition import _both

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu.core.executor import Scope as JaxScope
from siddhi_tpu.core.executor import compile_expression as jax_compile
from siddhi_tpu.core.planner import _apply_chain as jax_apply_chain
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.executor import Scope
from siddhi_tpu_torch.core.executor import compile_expression
from siddhi_tpu_torch.core.window import Rows
from siddhi_tpu_torch.kernels import filter_bytecode as fb
from siddhi_tpu_torch.kernels import post_filter as pf
from siddhi_tpu_torch.kernels.filter_compact import FilterSpec

DEF = "define stream S (k long, v int, p float, b bool);\n"
FILTERS = ["v > 2 and not b", "p >= 0.5 or v is null",
           "k * 2 + v < 11 and (p is null or p != 0.25)"]


def _exprs(filters, compiler=SiddhiCompiler):
    q = compiler.parse(
        DEF + "from S#window.length(2)" +
        "".join(f"[{f}]" for f in filters) +
        " select k insert into O;").execution_element_list[0]
    return [h.expression for h in q.input_stream.stream_handlers[1:]]


def _rows(rng, R):
    kind = rng.choice([0, 1, 2, 3], R, p=[0.45, 0.35, 0.1, 0.1]).astype(
        np.int32)
    valid = rng.random(R) < 0.85
    v = rng.integers(-2, 9, R).astype(np.int32)
    v[rng.random(R) < 0.1] = ev.NULL_INT
    p = (rng.integers(0, 64, R) / 64).astype(np.float32)
    p[rng.random(R) < 0.1] = np.nan
    cols = [rng.integers(-3, 9, R).astype(np.int64), v, p,
            rng.random(R) < 0.5]
    return (1000 + np.arange(R, dtype=np.int64)), kind, valid, cols


@pytest.mark.parametrize("n_filters", [1, 2, 3])
def test_plain_against_apply_chain(n_filters):
    filters = FILTERS[:n_filters]
    exprs = _exprs(filters)
    jrt = JaxManager().create_siddhi_app_runtime(DEF)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(DEF)
    js = JaxScope()
    js.interner = jrt.interner
    js.add_source("S", jrt.schemas["S"])
    scope = Scope(torch.device("cpu"))
    scope.interner = trt.interner
    scope.add_source("S", trt.schemas["S"])
    chain = [("filter", jax_compile(e, js))
             for e in _exprs(filters, JaxCompiler)]
    compiled = [compile_expression(e, scope) for e in exprs]
    code = []
    for i, e in enumerate(exprs):
        code += fb.compile_filter(e, scope, "S", {})
        if i:
            code.append(fb.AND)
    spec = FilterSpec(trt.schemas["S"].types, compiled, code, "S")
    rng = np.random.default_rng(n_filters)
    ts, kind, valid, cols = _rows(rng, 300)
    data = (kind == ev.CURRENT) | (kind == ev.EXPIRED)
    jcols = tuple(jnp.asarray(c) for c in cols)
    env = {"S": jcols, "__ts__": jnp.asarray(ts), "__now__": 2000,
           "__kind__": jnp.asarray(kind)}
    _, _, want = jax_apply_chain(chain, env, "S", jcols, jnp.asarray(valid),
                                 jnp.asarray(data))
    t = torch.from_numpy
    rows = Rows(t(ts), t(kind), t(valid), t(ts), t(np.zeros(300, np.int32)),
                tuple(t(c) for c in cols))
    got = pf.plain(spec, rows, 2000)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # TIMER and RESET rows keep their flags; so do invalid rows
    keep = ~data | ~valid
    assert np.array_equal(got.numpy()[keep], valid[keep])
    # the kernel's program, interpreted over the same columns
    tc = [t(c.astype(np.int32)) if c.dtype == np.bool_ else t(c)
          for c in cols]
    m = fb.interpret(code, lambda c: tc[c], lambda a, c: None)
    assert np.array_equal((t(valid) & (~t(data) | m)).numpy(), got.numpy())


WINDOWS = ["length(4)", "time(300)", "lengthBatch(3)", "timeBatch(400)"]
TOP = "@app:playback\n" + DEF + """
@info(name='q') from S#window.{win}[v >= 2 and not b]
select k, sum(p) as sp, count() as c group by k insert all events into O;
"""
KEYED = "@app:playback\n" + DEF + """
partition with (k of S)
begin
  @capacity(keys='16')
  @info(name='q') from S[v != 0]#window.{win}[p > 0.25 or b]
  select k, sum(v) as sv, max(p) as mp insert all events into O;
end;
"""


def _sends(rng, n=10, B=16):
    out = []
    for i in range(n):
        ts = np.sort(1000 + 160 * i + rng.integers(0, 80, B)).astype(
            np.int64)
        out.append(("S", (rng.integers(0, 5, B).astype(np.int64),
                          rng.integers(-1, 6, B).astype(np.int32),
                          (rng.integers(0, 64, B) / 64).astype(np.float32),
                          rng.random(B) < 0.4), ts))
    return out


@pytest.mark.parametrize("where", ["top", "keyed"])
@pytest.mark.parametrize("win", WINDOWS)
def test_every_window_kind(win, where):
    rng = np.random.default_rng(len(win) + (where == "keyed"))
    ql = (TOP if where == "top" else KEYED).format(win=win)
    ev_ = _both(ql, "q", _sends(rng))
    assert sum(len(i) + len(o) for _, i, o in ev_) > 20


@pytest.mark.parametrize("where", ["top", "keyed"])
def test_in_table(where):
    """`x in Table` after the window, at the top level and in a partition,
    with the table changing between sends."""
    body = ("from S#window.length(5)[k in T and p > 0.1] select k, "
            "count() as c insert all events into O;")
    if where == "keyed":
        body = ("partition with (k of S) begin @capacity(keys='16') "
                "@info(name='q') " + body + " end;")
    else:
        body = "@info(name='q') " + body
    ql = ("@app:playback\n" + DEF + "define stream W (k long);\n"
          "define table T (k long);\n"
          "from W select k insert into T;\n" + body)
    rng = np.random.default_rng(57)
    sends = []
    for i, (cols, ts) in enumerate((s[1], s[2]) for s in _sends(rng, 8)):
        if i % 3 == 0:
            sends.append(("W", [[int(x)] for x in rng.integers(0, 5, 2)],
                          int(ts[0]) - 1))
        sends.append(("S", cols, ts))
    ev_ = _both(ql, "q", sends)
    assert sum(len(i) + len(o) for _, i, o in ev_) > 10


def test_post_chain_compiles_to_bytecode_for_cuda():
    """The post chain compiles to the bytecode the kernel runs (planned
    for the CPU, the plan's `post_spec` holds the compiled filters and no
    bytecode); a filter outside the bytecode subset raises at plan time for
    CUDA naming ROADMAP B10 (`%`, which the bytecode lacks)."""
    from siddhi_tpu_torch.core.planner import plan_single_query
    ql = DEF + ("@info(name='q') from S#window.time(100)[v > 2 and not b]"
                "[p >= 0.5] select k, count() as c insert into O;")
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    q = SiddhiCompiler.parse(ql).execution_element_list[0]
    plan = rt.query_runtimes["q"].planned
    assert plan.post_spec is not None and plan.post_spec.bytecode is None
    scope = Scope(torch.device("cpu"))
    scope.interner = rt.interner
    scope.add_source("S", rt.schemas["S"])
    code = []
    for h in q.input_stream.stream_handlers[1:]:
        code += fb.compile_filter(h.expression, scope, "S", {})
    assert code and len(plan.post_spec.compiled) == 2
    bad = SiddhiCompiler.parse(
        DEF + "@info(name='q') from S#window.time(100)[v % 2 == 1] "
        "select k insert into O;").execution_element_list[0]
    with pytest.raises(NotImplementedError, match="B10"):
        plan_single_query(bad, "q", rt.schemas, rt.manager.interner,
                          device=torch.device("cuda"))


def test_chip_smoke_pf1_model(monkeypatch):
    """chip_smoke.py's PF1 at a small size (4 symbols, 256 events a send
    with dyadic prices, a 50 ms window, so 5 sends): both packages give
    the same events, every
    send's (n_current, n_expired) is numpy's count of price > 0.5 in the
    send and in the send its window expires, and the last send's counts
    per symbol pass pf1_check."""
    monkeypatch.setattr(chip_smoke, "PF1_SYM", 4)
    monkeypatch.setattr(chip_smoke, "N_SYM", 4)
    monkeypatch.setattr(chip_smoke, "B1", 256)
    monkeypatch.setattr(chip_smoke, "FILL", 5)
    ql = chip_smoke.PF1_QL.replace("time(1 sec)", "time(50)").replace(
        "16777216", "4096")
    rng = np.random.default_rng(17)
    # config_rows' columns with dyadic prices, so float sums are exact
    sends = [([rng.integers(0, 4, 256).astype(np.int64),
               (rng.integers(0, 64, 256) / 64).astype(np.float32),
               np.ones(256, np.int32)],
              np.full(256, 1000 + 10 * i, np.int64)) for i in range(12)]
    _both(ql, "q", [("S", tuple(c), ts) for c, ts in sends])
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    got, counts = [], []
    rt.add_batch_callback("q", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("S")
    for i, (cols, ts) in enumerate(sends):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        counts.append((sum(b["n_current"] for b in got),
                       sum(b["n_expired"] for b in got)))
        assert counts[-1] == chip_smoke.pf1_counts(np, sends, i)
    fetched = [(b["kind"][b["valid"]], {k: v[b["valid"]] for k, v in
                                        b["cols"].items()}) for b in got]
    rt.shutdown()
    chip_smoke.pf1_check(np, sends, len(sends) - 1, fetched)
    assert counts[-1][1] > 0
