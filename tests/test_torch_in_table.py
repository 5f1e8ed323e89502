"""`x in Table` through the port (the B-probe: `kernels/in_probe.py`, the
bytecode's IN opcode) against the JAX package.

Each app runs through both packages with the same sends, and the emitted
events must be equal (exact: the probe compares, it computes nothing).
The paths: a plain filter, a probe in the select list, a keyed window in
a partition, pattern filters (the block NFA and the scan step, dense and
gappy keys), live table mutations between sends, `not (k in T)`, and
operands holding -0.0 / +0.0, NaN and in-band nulls, a LONG operand
against an INT column.  The JAX package ships no probe into a join step
(an `in` there fails at its first event), so a join side's filter is held
to the same filter run upstream of the join in the JAX package.  The
plain probe (the dense compare, chunked) is held to numpy at one chunk
and at several, and the bytecode's IN to the compiled expression.
"""
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.kernels import in_probe


def _run(make, ql, actions, queries):
    m = make()
    rt = m.create_siddhi_app_runtime(ql)
    got = {q: [] for q in queries}
    for q in queries:
        rt.add_callback(q, lambda ts, i, o, _q=q: got[_q].append(
            ([tuple(e.data) for e in i or []],
             [tuple(e.data) for e in o or []])))
    rt.start()
    for stream, data, ts in actions:
        rt.get_input_handler(stream).send(data, timestamp=ts)
    rt.flush()
    m.shutdown()
    return got


def both(ql, actions, queries=("q",)):
    j = _run(JaxManager, ql, actions, queries)
    t = _run(lambda: TorchManager(device="cpu"), ql, actions, queries)
    assert t == j
    return t


def _flat(got, q="q"):
    return [r for ins, _ in got[q] for r in ins]


PATTERN_FILTER = """
define stream TI (k long);
define table T (k long);
@info(name='w') from TI insert into T;
define stream S (k long, v int);
@info(name='q') from every e1=S[k in T and v == 1] -> e2=S[v == 2]
select e1.k as k insert into Out;
"""


@pytest.mark.parametrize("scan", [False, True], ids=["block", "scan"])
def test_pattern_filter_probes_table(scan, monkeypatch):
    from siddhi_tpu.core import pattern_planner as jpp
    from siddhi_tpu_torch.core import pattern_planner as tpp
    monkeypatch.setattr(jpp, "_FORCE_SCAN", scan)
    monkeypatch.setattr(tpp, "_FORCE_SCAN", scan)
    got = both(PATTERN_FILTER, [
        ("S", [5, 1], 1), ("S", [5, 2], 2),      # 5 not in T: no arm
        ("TI", [5], 3), ("S", [5, 1], 4), ("S", [5, 2], 5)])
    assert _flat(got) == [(5,)]


def test_pattern_in_table_sees_live_mutations():
    ql = """
    define stream TI (k long);
    define stream TD (k long);
    define table T (k long);
    @info(name='w') from TI insert into T;
    @info(name='d') from TD delete T on T.k == k;
    define stream S (k long, v int);
    @info(name='q') from every e1=S[k in T and v == 1] -> e2=S[v == 2]
    select e1.k as k insert into Out;
    """
    got = both(ql, [("TI", [9], 1), ("S", [9, 1], 2), ("S", [9, 2], 3),
                    ("TD", [9], 4), ("S", [9, 1], 5), ("S", [9, 2], 6)])
    assert _flat(got) == [(9,)]


def test_partitioned_pattern_in_table_dense_and_gappy():
    ql = """
    define stream TI (k long);
    define table T (k long);
    @info(name='w') from TI insert into T;
    define stream S (k long, v int);
    partition with (k of S) begin
    @capacity(keys='64', slots='4') @info(name='q')
    from every e1=S[k in T and v == 1] -> e2=S[v == 2]
    select e1.k as k insert into Out;
    end;
    """
    acts = [("TI", [k], 1) for k in (0, 1, 2, 3)]
    acts += [("S", [[k, 1] for k in range(8)], 2),
             ("S", [[k, 2] for k in range(8)], 3), ("TI", [500], 4)]
    acts += [("S", [k, 1], 5) for k in (100, 500)]
    acts += [("S", [k, 2], 6) for k in (100, 500)]
    got = both(ql, acts)
    assert sorted(_flat(got)) == [(0,), (1,), (2,), (3,), (500,)]


def test_sequence_in_table_negation():
    ql = """
    define stream TI (k long);
    define table T (k long);
    @info(name='w') from TI insert into T;
    define stream S (k long, v int);
    @info(name='q') from every e1=S[not (k in T) and v == 1] -> e2=S[v == 2]
    select e1.k as k insert into Out;
    """
    got = both(ql, [("TI", [7], 1), ("S", [7, 1], 2), ("S", [7, 2], 3),
                    ("S", [8, 1], 4), ("S", [8, 2], 5)])
    assert _flat(got) == [(8,)]


@pytest.mark.parametrize("body", [
    "from every e1=S[k in NoSuchTable] -> e2=S[v == 2] select e1.k as k "
    "insert into Out;",
    "from S[k in Typo] select k insert into Out;"])
def test_in_unknown_source_is_compile_error(body):
    ql = "define stream S (k long, v int);\n@info(name='q') " + body
    with pytest.raises(CompileError, match="requires a defined table"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_in_table_operator_strings():
    """`test_table_corpus.py::test_in_table_operator` and
    `test_table_join.py::TestTables::test_in_operator`: STRING ids."""
    ql = """
    define stream In (k string, v int);
    define stream S (k string, v int);
    define table T (k string, v int);
    @info(name='w') from In insert into T;
    @info(name='q') from S[k in T] select k, v insert into Out;
    """
    got = both(ql, [("In", ["allowed", 0], 1), ("In", ["WSO2", 0], 2),
                    ("S", ["allowed", 1], 3), ("S", ["blocked", 2], 4),
                    ("S", ["WSO2", 30], 5)])
    assert _flat(got) == [("allowed", 1), ("WSO2", 30)]


def test_probe_in_select_list_and_keyed_window():
    ql = """
    define stream TI (k int, v int);
    define stream TD (k int);
    define table T (k int, v int);
    @info(name='w') from TI insert into T;
    @info(name='d') from TD delete T on T.k == k;
    define stream S (k int, v int);
    @info(name='q') from S select k, k in T as known insert into Out;
    partition with (k of S) begin
      @info(name='p') from S[k in T]#window.length(2)
      select k, sum(v) as s insert all events into Out2;
    end;
    """
    acts = [("TI", [[1, 0], [3, 0]], 1),
            ("S", [[k, k * 10] for k in (1, 2, 3, 1, 3)], 2),
            ("TD", [1], 3),
            ("S", [[k, k] for k in (1, 2, 3, 3)], 4)]
    got = both(ql, acts, ("q", "p"))
    assert got["q"][0][0][:2] == [(1, True), (2, False)]


VALUE_QL = """
define stream TI (x {ct});
define table T (x {ct});
@info(name='w') from TI insert into T;
define stream S (x {ot}, i int);
@info(name='q') from S[x in T] select i insert into Out;
"""


@pytest.mark.parametrize("ct,ot,table,probes", [
    ("float", "float", [0.0, float("nan"), 2.5, None],
     [-0.0, 0.0, float("nan"), 2.5, None, 3.0]),
    ("double", "float", [-0.0, 1.0], [0.0, -0.0, 1.0, None]),
    ("int", "long", [1, 2**31 - 1, None], [1, 2**31 - 1, 2**31 + 1, None,
                                           -(2**31)]),
    ("int", "int", [None, 5], [None, 5, 6]),
    ("long", "int", [7, -(2**63)], [7, None, 8]),
    ("int", "float", [3, None], [3.0, 3.5, float("nan"), None]),
    ("bool", "bool", [True], [True, False, None]),
])
def test_probe_values(ct, ot, table, probes):
    """-0.0 equals +0.0, NaN equals nothing, an in-band null is a value,
    the compare type is the promoted one."""
    ql = VALUE_QL.format(ct=ct, ot=ot)
    acts = [("TI", [v], 1) for v in table]
    acts += [("S", [v, i], 2 + i) for i, v in enumerate(probes)]
    both(ql, acts)


def test_join_side_filter_probes_table():
    """The port runs a join side's filter probe in K1; the JAX package's
    join step carries no probe, so its events come from the same filter
    upstream of the join."""
    port = """
    define stream TI (symbol long);
    define table T (symbol long);
    @info(name='w') from TI insert into T;
    define stream L (symbol long, price float);
    define stream R (symbol long, qty int);
    @info(name='q') from L[symbol in T]#window.length(4) join
      R#window.length(4) on L.symbol == R.symbol
    select L.symbol as s, R.qty as q insert into O;
    """
    ref = """
    define stream TI (symbol long);
    define table T (symbol long);
    @info(name='w') from TI insert into T;
    define stream L0 (symbol long, price float);
    define stream L (symbol long, price float);
    define stream R (symbol long, qty int);
    from L0[symbol in T] select symbol, price insert into L;
    @info(name='q') from L#window.length(4) join
      R#window.length(4) on L.symbol == R.symbol
    select L.symbol as s, R.qty as q insert into O;
    """
    acts = [("TI", [1], 1), ("L", [[1, 1.0], [2, 1.0], [3, 2.0]], 2),
            ("R", [[1, 5], [2, 6]], 3), ("TI", [2], 4),
            ("L", [[2, 3.0]], 5), ("R", [[2, 7], [1, 8]], 6)]
    t = _run(lambda: TorchManager(device="cpu"), port, acts, ("q",))
    j = _run(JaxManager, ref,
             [("L0" if s == "L" else s, d, ts) for s, d, ts in acts], ("q",))
    assert t == j
    assert _flat(t) == [(1, 5), (2, 6), (2, 7), (1, 8)]


@pytest.mark.parametrize("chunk", [1 << 28, 64], ids=["one", "many"])
def test_plain_probe_chunks(chunk, monkeypatch):
    monkeypatch.setattr(in_probe, "CHUNK_BYTES", chunk)
    rng = np.random.default_rng(5)
    col = rng.integers(0, 50, 40).astype(np.int32)
    valid = rng.random(40) < 0.7
    vals = rng.integers(0, 60, (3, 17)).astype(np.int64)
    got = in_probe.plain(torch.from_numpy(vals), torch.from_numpy(col),
                         torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), np.isin(vals, col[valid]))


def test_bytecode_in_matches_expression():
    """The IN opcode (its plain interpreter) against the compiled
    expression, over a filter mixing it with other ops."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.executor import Scope, compile_expression
    from siddhi_tpu_torch.kernels import filter_bytecode as fb
    app = SiddhiCompiler.parse("""
    define stream S (a int, b float);
    define table T (a long);
    from S[not (a in T) or (b in T and a > 3)] select a insert into O;
    """)
    q = app.execution_element_list[0]
    expr = q.input_stream.stream_handlers[0].expression
    interner = ev.StringInterner()
    scope = Scope()
    scope.interner = interner
    scope.add_source("S", ev.Schema(app.stream_definition_map["S"],
                                    interner))
    ik = fb.InKeys({"T": "LONG"})
    code = fb.compile_filter(expr, scope, "S", {}, in_keys=ik)
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(0, 10, 64).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 10, 64).astype(np.float32))
    tcol = torch.from_numpy(np.array([1, 4, 5, 8], np.int64))
    tvalid = torch.tensor([True, True, False, True])

    class Tab:
        version = 0
        in_sets = {}
        cols = (tcol,)
        valid = tvalid
    tab = in_probe.InTab(Tab)
    env = {"S": (a, b), "__ts__": None, "__now__": 0,
           **in_probe.probe_env({"T": tab})}
    want = compile_expression(expr, scope).fn(env)
    got = fb.interpret(
        code, lambda c: (a, b)[c], None,
        load_in=lambda si, v: in_probe.plain(v, tcol.to(v.dtype), tvalid))
    assert ik.keys == [("T", fb.T_I64), ("T", fb.T_F32)]
    assert torch.equal(got, want)
