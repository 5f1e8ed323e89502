"""In-memory tables through both packages' `SiddhiManager`s: the same app
and sends give the same events, the same on-demand results and, after
every send or on-demand write, the same table: columns, ts, valid, the
append pointer and free rows, the primary-key allocator's bound slots and
free stack, each @Index's lanes, counts, shadow and bucket map, and the
index statistics (`convert.table_to_numpy` reads either package's table).
String columns are compared decoded, since each package interns strings
in its own order.  The kernels' plain versions (K9 `table_write`, K10
`table_match`) are also held directly against `TableRuntime._write_impl`,
`_masked_delete_impl` and `_match` on seeded inputs.

The case shapes are those of `tests/test_table_join.py` (table ops),
`test_table_pk_matrix.py`, `test_table_corpus.py`, `test_table_index.py`
and the table half of `test_join_fastpath.py`; stream-table joins are in
`test_torch_table_join.py`.  Tolerance: exact everywhere (floats compared
with NaN equal to NaN).  The JAX side runs on the CPU.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core import event as jev
from siddhi_tpu.core.table import TableRuntime as JaxTable
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.core.table import TableRuntime as TorchTable
from siddhi_tpu_torch.kernels import table_match, table_write

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decoded(t):
    """A table as comparable numpy: string cells decoded."""
    d = convert.table_to_numpy(t)
    types, intern = t.schema.types, t.schema.interner

    def dec(col, ty):
        if ty == "STRING":
            return [intern.lookup(int(x)) for x in col]
        return col
    d["cols"] = [dec(c, ty) for c, ty in zip(d["cols"], types)]
    for pos, ix in d["indexes"].items():
        ix["shadow"] = dec(ix["shadow"], types[pos])
        ix["buckets"] = sorted(ix["buckets"].values())
    if d["slots"] is not None:
        d["slots"] = sorted(d["slots"].values())
    d["index_stats"] = dict(t.index_stats)
    return d


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert np.array_equal(a, np.asarray(b), equal_nan=True), where
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, np.asarray(b)), where
    elif isinstance(a, list) and any(isinstance(x, (np.ndarray, list))
                                     for x in a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _drive(mgr, ql, actions):
    """The trace of one package: after each action, the events each query
    delivered, the on-demand result (if any) and every table."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {}
    for q in rt.query_runtimes:
        got[q] = []
        rt.add_callback(q, lambda ts, c, e, _q=q: got[_q].append(
            (ts, [(x.timestamp, tuple(x.data)) for x in c or []],
             [(x.timestamp, tuple(x.data)) for x in e or []])))
    rt.start()
    trace = []
    for act in actions:
        res = None
        if act[0] == "send":
            _, stream, rows, ts = act
            rt.get_input_handler(stream).send(rows, timestamp=ts)
        elif act[0] == "cols":
            _, stream, cols, ts = act
            rt.get_input_handler(stream).send_columns(
                cols, timestamps=np.full(len(cols[0]), ts, np.int64))
        else:
            res = [(e.timestamp, tuple(e.data)) for e in rt.query(act[1])]
        trace.append((res, {q: list(v) for q, v in got.items()},
                      {tid: _decoded(t) for tid, t in rt.tables.items()}))
    mgr.shutdown()
    return trace, rt


def both(ql, actions):
    """Run the app through both packages and hold every step equal.
    Returns the port's runtime."""
    ja, _ = _drive(JaxManager(), ql, actions)
    tb, trt = _drive(TorchManager(device="cpu"), ql, actions)
    assert len(ja) == len(tb)
    for i, (x, y) in enumerate(zip(ja, tb)):
        assert x[0] == y[0], f"on-demand result of action {i}"
        assert x[1] == y[1], f"events after action {i}"
        _same(x[2], y[2], f"tables after action {i}")
    return trt


def send(stream, rows, ts=1000):
    return ("send", stream, rows, ts)


def query(text):
    return ("query", text)


# ---------------------------------------------------------------------------
# table ops (tests/test_table_join.py TestTables, test_table_corpus.py)
# ---------------------------------------------------------------------------

STOCK = """
@app:playback
define stream StockStream (symbol string, price float, volume long);
define table StockTable (symbol string, price float, volume long);
from StockStream select * insert into StockTable;
"""

PK_UPSERT = """
@app:playback
define stream S (symbol string, price float);
@PrimaryKey('symbol')
define table T (symbol string, price float);
from S select * insert into T;
"""

CRUD = """
@app:playback
define stream S (symbol string, price float);
define stream DeleteStream (symbol string);
define stream U (symbol string, newPrice float);
define stream UI (symbol string, price float);
define table T (symbol string, price float);
from S select * insert into T;
from DeleteStream delete T on T.symbol == symbol;
from U select symbol, newPrice
update T set T.price = newPrice on T.symbol == symbol;
from UI update or insert into T set T.price = price
  on T.symbol == symbol;
"""

CORPUS = """
@app:playback
define stream In (k string, v int);
define stream Up (k string, v int);
define stream Ups (k string, v int);
define stream Del (k string);
define table T (k string, v int);
@info(name='w') from In insert into T;
@info(name='u') from Up update T set T.v = v on T.k == k;
@info(name='ui') from Ups update or insert into T set T.v = v on T.k == k;
@info(name='d') from Del delete T on T.k == k;
"""

OPS_CASES = {
    "insert": (STOCK, [send("StockStream", ["WSO2", 55.6, 100]),
                       send("StockStream", ["IBM", 75.6, 10], 1001),
                       query("from StockTable select symbol, price, "
                             "volume")]),
    "primary_key_upsert": (PK_UPSERT, [
        send("S", ["A", 1.0]), send("S", ["B", 2.0], 1001),
        send("S", ["A", 3.0], 1002)]),
    "delete_update_upsert": (CRUD, [
        send("S", [["A", 1.0], ["B", 2.0], ["C", 3.0]]),
        send("DeleteStream", ["B"], 1001),
        send("U", ["A", 9.5], 1002),
        send("UI", ["D", 4.0], 1003),          # miss: insert (reuses B's row)
        send("UI", ["A", 2.0], 1004),          # hit: update
        query("from T select symbol, price")]),
    "corpus": (CORPUS, [
        send("Ups", ["new", 5]), send("In", ["a", 1], 1001),
        send("In", ["b", 2], 1002), send("Up", ["a", 99], 1003),
        send("Ups", ["a", 42], 1004), send("Del", ["b"], 1005),
        query("from T select k, v order by v desc limit 2")]),
}


@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_table_ops(case):
    ql, actions = OPS_CASES[case]
    both(ql, actions)


# ---------------------------------------------------------------------------
# primary keys and indexes (test_table_pk_matrix.py, test_table_index.py)
# ---------------------------------------------------------------------------

def _pk_app(key_type="string", ann="@PrimaryKey('sym')"):
    return f"""
    @app:playback
    define stream In (sym {key_type}, price double, vol long);
    define stream Del (k {key_type});
    define stream Upd (k {key_type}, p double);
    {ann}
    define table T (sym {key_type}, price double, vol long);
    @info(name='ins') from In select sym, price, vol insert into T;
    @info(name='del') from Del delete T on T.sym == k;
    @info(name='upd') from Upd update T set T.price = p on T.sym == k;
    """


KEYS = {"string": ["a", "b", "c", "d"], "int": [1, 2, 3, 4],
        "long": [10, 20, 30, 40]}


@pytest.mark.parametrize("kt", ["string", "int", "long"])
def test_pk_point_lookup_update_delete(kt):
    k = KEYS[kt]
    both(_pk_app(kt), [send("In", [k[i], float(i), i * 10], 1000 + i)
                       for i in range(4)] +
         [send("Upd", [k[1], 99.5], 1010),
          query("from T select sym, price"),
          send("Del", [k[0]], 1011), query("from T select sym"),
          send("In", [[k[0], 7.0, 70], [k[0], 8.0, 80]], 1012),
          send("In", [[k[2], 1.0, 1], [k[3], 2.0, 2]], 1013)])


def test_pk_duplicate_keys_in_one_batch():
    """One batch carrying keys twice, new ones and existing ones: the last
    row of the batch wins each slot, as the JAX package's scatter does."""
    both(_pk_app("long"), [
        send("In", [[1, 1.0, 1], [2, 2.0, 2], [1, 3.0, 3], [3, 4.0, 4],
                    [2, 5.0, 5], [1, 6.0, 6]]),
        send("In", [[3, 7.0, 7], [4, 8.0, 8], [3, 9.0, 9], [1, 10.0, 10],
                    [4, 11.0, 11]], 1001),
        query("from T select sym, price, vol")])


RANGE_CONDS = ["vol > 15", "vol >= 10", "vol < 10", "vol <= 10",
               "vol == 20", "vol != 20", "sym == 'b' and vol == 10",
               "sym == 'b' or vol == 20", "not (vol > 15)",
               "vol > 5 and vol < 25"]

IDX_VOL = """
@app:playback
define stream In (sym string, vol long);
{ann}
define table T (sym string, vol long);
from In select sym, vol insert into T;
"""


@pytest.mark.parametrize("cond", RANGE_CONDS)
def test_indexed_range_conditions(cond):
    both(IDX_VOL.format(ann="@Index('vol')"),
         [send("In", [s, v], 1000 + i) for i, (s, v) in
          enumerate((("a", 5), ("b", 10), ("c", 20), ("d", 30)))] +
         [query(f"from T on {cond} select sym")])


@pytest.mark.parametrize("ann", ["@Index('vol')", ""])
def test_indexed_vs_dense(ann):
    trt = both(IDX_VOL.format(ann=ann),
               [send("In", [s, v], 1000 + i) for i, (s, v) in enumerate(
                   (("x", 7), ("y", 13), ("z", 21), ("w", 13)))] +
               [query("from T on vol == 13 or vol > 20 select sym")])
    assert trt.tables["T"].index_stats["indexed"] == 0


PK_MATRIX_APPS = {
    "upsert_update_or_insert": ("""
    @app:playback
    define stream S (sym string, price double);
    @PrimaryKey('sym')
    define table T (sym string, price double);
    from S update or insert into T set T.price = price on T.sym == sym;
    """, [send("S", ["a", 1.0]), send("S", ["a", 2.0], 1001),
          send("S", ["b", 9.0], 1002),
          send("S", [["c", 1.0], ["a", 5.0], ["c", 2.0], ["d", 3.0]], 1003),
          query("from T select sym, price")]),
    "compound_update_arithmetic": ("""
    @app:playback
    define stream S (sym string, d double);
    define stream Seed (sym string, price double);
    @PrimaryKey('sym')
    define table T (sym string, price double);
    from Seed select sym, price insert into T;
    from S update T set T.price = T.price + d on T.sym == sym;
    """, [send("Seed", [["a", 10.0], ["b", 20.0]]),
          send("S", ["a", 2.5], 1001), send("S", ["a", 2.5], 1002),
          send("S", [["b", 1.0], ["b", 4.0]], 1003)]),
}

IDX_APP = """
@app:playback
define stream In (k string, sym string, v int);
define stream Del (sym string);
define stream Up (sym string, v int);
define stream Mv (k string, sym string);
define stream Fix (k string);
@PrimaryKey('k')
@Index('sym')
define table T (k string, sym string, v int);
@info(name='w') from In insert into T;
@info(name='d') from Del delete T on T.sym == sym;
@info(name='u') from Up update T set T.v = v on T.sym == sym;
@info(name='m') from Mv update T set T.sym = sym on T.k == k;
@info(name='f') from Fix update T set T.sym = 'done' on T.k == k;
"""

INDEX_CASES = {
    "indexed_delete": [send("In", [f"k{i}", f"s{i % 3}", i], 1000 + i)
                       for i in range(8)] + [send("Del", ["s1"], 1010)],
    "indexed_update_then_delete": [
        send("In", ["a", "x", 1]), send("In", ["b", "y", 2], 1001),
        send("Up", ["x", 10], 1002), send("Del", ["x"], 1003)],
    "update_of_indexed_column": [
        send("In", ["a", "x", 1]), send("Mv", ["a", "z"], 1001),
        send("Del", ["x"], 1002), send("Del", ["z"], 1003)],
    "constant_set_on_indexed_column": [
        send("In", ["a", "x", 1]), send("Fix", ["a"], 1001),
        query("from T on sym == 'done' select k"),
        query("from T on sym == 'x' select k")],
    "repeated_key_in_one_batch": [
        send("In", [["a", "x", 1], ["a", "y", 2]]),
        query("from T on sym == 'x' select k"),
        query("from T on sym == 'y' select k")],
}


@pytest.mark.parametrize("case", sorted(PK_MATRIX_APPS))
def test_pk_matrix_apps(case):
    ql, actions = PK_MATRIX_APPS[case]
    both(ql, actions)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_cases(case):
    trt = both(IDX_APP, INDEX_CASES[case])
    if case == "indexed_delete":
        assert trt.tables["T"].index_stats["indexed"] >= 1


def test_pkey_probe_path():
    both("""
    @app:playback
    define stream In (k long, v int);
    define stream Del (k long);
    @PrimaryKey('k')
    define table T (k long, v int);
    @info(name='w') from In insert into T;
    @info(name='d') from Del delete T on T.k == k;
    """, [send("In", [i, i * 10], 1000 + i) for i in range(16)] +
         [send("Del", [7], 1020), send("In", [99, 1], 1021)])


@pytest.mark.parametrize("ann", ["@PrimaryKey('k')\n@Index('sym')",
                                 "@PrimaryKey('k')"])
def test_indexed_vs_dense_equivalence(ann):
    rng = np.random.default_rng(7)
    writes = [[f"k{i}", f"s{rng.integers(0, 5)}", int(rng.integers(0, 50))]
              for i in range(64)]
    dels = [[f"s{i}", int(rng.integers(10, 40))] for i in range(5)]
    both(f"""
    @app:playback
    define stream In (k string, sym string, v int);
    define stream Del (sym string, lim int);
    {ann}
    define table T (k string, sym string, v int);
    @info(name='w') from In insert into T;
    @info(name='d') from Del delete T on T.sym == sym and T.v < lim;
    """, [send("In", writes)] +
         [send("Del", d, 1001 + i) for i, d in enumerate(dels)])


ONDEMAND_IDX = """
@app:playback
define stream In (k string, sym string, v int);
@PrimaryKey('k')
@Index('sym', 'v')
define table T (k string, sym string, v int);
@info(name='w') from In insert into T;
"""


@pytest.mark.parametrize("cond", [
    "sym == 's2'", "v >= 28", "sym == 's1' and v > 20", "v == 5.5",
    "v == 5", "v < 27.5", "k == 'k3'"])
def test_ondemand_indexed(cond):
    both(ONDEMAND_IDX, [send("In", [[f"k{i}", f"s{i % 4}", i]
                                    for i in range(32)]),
                        query(f"from T on {cond} select k, v")])


def test_on_clause_ops_consult_index():
    """test_join_fastpath.py's table-op case: update and delete with an
    ON equality against an indexed column probe the index."""
    trt = both("""
    @app:playback
    define stream U (sym long, val long);
    define stream D (sym long, val long);
    @PrimaryKey('sym') @Index('val')
    define table T (sym long, val long);
    define stream Feed (sym long, val long);
    @info(name='load') from Feed select sym, val insert into T;
    @info(name='upd') from U select sym, val update T on T.sym == sym;
    @info(name='del') from D delete T on T.val == val;
    """, [("cols", "Feed", [np.arange(32, dtype=np.int64),
                            np.arange(32, dtype=np.int64) % 8], 1000),
          ("cols", "U", [np.asarray([3, 5], np.int64),
                         np.asarray([100, 100], np.int64)], 1001),
          ("cols", "D", [np.asarray([0], np.int64),
                         np.asarray([7], np.int64)], 1002)])
    assert trt.tables["T"].index_stats == {"indexed": 2, "dense": 0}


def test_probe_rows_match_the_reference():
    ql = """
    @app:playback
    define stream S (sym long, v long);
    @PrimaryKey('sym') @Index('v')
    define table T (sym long, v long);
    @info(name='load') from S select sym, v insert into T;
    """
    rng = np.random.default_rng(3)
    syms = np.arange(64, dtype=np.int64)
    vals = rng.integers(0, 9, 64).astype(np.int64)
    actions = [("cols", "S", [syms, vals], 1000),
               ("cols", "S", [syms[:8], (vals[:8] + 1) % 9], 1001)]
    _, jrt = _drive(JaxManager(), ql, actions)
    _, trt = _drive(TorchManager(device="cpu"), ql, actions)
    jt, tt = jrt.tables["T"], trt.tables["T"]
    for pos, probe in ((1, np.arange(9, dtype=np.int64)),
                       (0, np.arange(-2, 70, dtype=np.int64))):
        for a, b in zip(jt.probe_rows(pos, probe), tt.probe_rows(pos, probe)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the sample, on-demand queries, freed rows, the old-columns rule
# ---------------------------------------------------------------------------

def test_table_crud_sample():
    with open(os.path.join(_ROOT, "samples", "apps",
                           "table_crud.siddhi")) as fh:
        ql = "@app:playback\n" + fh.read()
    rng = np.random.default_rng(5)
    syms = [f"S{i}" for i in range(24)]
    actions = [send("UpdateStream",
                    [[syms[j], float(rng.integers(0, 1000)) / 8]
                     for j in rng.integers(0, 24, 16)], 1000 + i)
               for i in range(6)]
    both(ql, actions + [query("from PriceTable select sym, price")])


ONDEMAND = """
@app:playback
define stream In (sym string, price double, qty int);
define table T (sym string, price double, qty int);
@info(name='w') from In insert into T;
"""
SEED = [["a", 10.0, 5], ["b", 20.0, 3], ["c", 30.0, 8], ["d", 5.0, 1],
        ["e", 10.0, 5]]


@pytest.mark.parametrize("q", [
    "from T select sym, qty",
    "from T on qty > 2 select sym, price",
    "from T select sum(qty) as total, avg(price) as ap",
    "from T select qty, sum(price) as total group by qty "
    "having total > 12.0 order by total desc",
    "from T select min(price) as lo, max(price) as hi, "
    "distinctCount(price) as dc",
    "from T select sym, price order by price desc limit 2",
    "from T select sym, price order by price asc limit 2 offset 1",
    "from T on price > 1000.0 select count() as n",
])
def test_ondemand_find(q):
    both(ONDEMAND, [send("In", SEED), query(q)])


@pytest.mark.parametrize("q", [
    "from T delete T on T.sym == 'a'",
    "from T delete T on T.qty > 2 and T.qty < 8",
    "from T on sym == 'b' select sym, 999.0 as price "
    "update T set T.price = price on T.sym == sym",
    "from T on T.qty > 2 select sym "
    "update T set T.price = T.price * 2.0 on T.sym == sym",
    "from T on T.sym == 'b' select 'b' as sym, 99.0 as price, 7 as qty "
    "update or insert into T set T.price = price, T.qty = qty "
    "on T.sym == sym",
    "from T on T.sym == 'a' select 'zz' as sym, 1.0 as price, 2 as qty "
    "update or insert into T set T.price = price, T.qty = qty "
    "on T.sym == sym",
    "select 'k' as sym, 1.5 as price, 3 as qty insert into T",
    "from T on qty == 5 select sym, price, qty insert into T",
])
def test_ondemand_writes(q):
    both(ONDEMAND, [send("In", SEED), query(q),
                    query("from T select sym, price, qty"),
                    send("In", [["f", 1.0, 1], ["g", 2.0, 2]], 1001)])


def test_ondemand_plan_cache():
    trt = both(ONDEMAND, [send("In", SEED)] +
               [query("from T on qty > 2 select sym")] * 3)
    memo = trt._ondemand_cache["from T on qty > 2 select sym"][1]
    # the condition, the table's index plan and the projection, once
    assert memo.plans == 3


def test_freed_rows_reused_last_freed_first():
    """Deleted rows of a keyless table are reused by later appends, the
    most recently freed first, then the append pointer."""
    both(CRUD, [send("S", [[c, float(i)] for i, c in enumerate("ABCDEFGH")]),
                send("DeleteStream", [["B"], ["F"], ["D"]], 1001),
                send("DeleteStream", ["G"], 1002),
                send("S", [["X", 1.0], ["Y", 2.0]], 1003),
                send("S", [["Z", 3.0], ["W", 4.0], ["V", 5.0]], 1004)])


def test_append_slots_order_equals_the_loop():
    """The vectorised `_append_slots` pops free rows in the reference's
    one-at-a-time order, then advances the append pointer."""
    from siddhi_tpu_torch.core.table import TableRuntime
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core import event as tev
    tdef = SiddhiCompiler.parse(
        "define table T (a int);").table_definition_map["T"]
    rng = np.random.default_rng(11)
    for _ in range(20):
        t = TableRuntime(tdef, tev.Schema(tdef, tev.StringInterner()),
                         torch.device("cpu"), capacity=64)
        free = [int(x) for x in rng.permutation(32)[:rng.integers(0, 12)]]
        t._free_rows = list(free)
        t._append_ptr = 40
        n = int(rng.integers(0, 20))
        want, f, ptr = [], list(free), 40
        for _ in range(n):
            if f:
                want.append(f.pop())
            else:
                want.append(ptr)
                ptr += 1
        assert t._append_slots(n).tolist() == want
        assert t._free_rows == f and t._append_ptr == ptr


def test_capacity_exhausted_raises_as_the_reference():
    ql = """
    @app:playback
    define stream S (a int);
    @capacity(rows='4')
    define table T (a int);
    from S select a insert into T;
    """
    from siddhi_tpu_torch.core.table import TableRuntime
    t = TorchManager(device="cpu").create_siddhi_app_runtime(ql).tables["T"]
    t._free_rows = [1]
    t._append_ptr = 2
    with pytest.raises(RuntimeError, match="capacity 4 exhausted"):
        t._append_slots(4)
    assert t._free_rows == [] and t._append_ptr == 4
    assert isinstance(t, TableRuntime)


def test_set_expressions_read_the_old_columns():
    """`set T.a = T.b, T.b = T.a` swaps: every set expression reads the
    table as it was before the update."""
    both("""
    @app:playback
    define stream In (k long, a int, b int);
    define stream Sw (k long);
    @PrimaryKey('k')
    define table T (k long, a int, b int);
    from In insert into T;
    from Sw update T set T.a = T.b, T.b = T.a on T.k == k;
    """, [send("In", [[1, 10, 20], [2, 30, 40], [3, 50, 60]]),
          send("Sw", [[1], [3]], 1001), send("Sw", [[3]], 1002),
          query("from T select k, a, b")])


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ql,item", [
    ("""define stream S (a int);
     @store(type='rdbms', url='x') define table T (a int);
     from S insert into T;""", "A15"),
    ("""define stream S (a int, ts long);
     @store(type='memory')
     define aggregation A from S select sum(a) as s
     aggregate by ts every sec ... min;""", "A15"),
    ("""define stream S (k string, v int, ts long);
     define aggregation A from S select k, custom:agg(v) as c group by k
     aggregate by ts every sec ... min;""", "A4"),
])
def test_still_raises(ql, item):
    with pytest.raises(CompileError, match=item):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_named_window_store_query_raises():
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ONDEMAND)
    with pytest.raises(CompileError,
                       match="no table/window/aggregation named 'W'"):
        rt.query("from W select *")


def test_store_table_runtime_raises_a15():
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core import event as tev
    from siddhi_tpu_torch.core.table import TableRuntime
    tdef = SiddhiCompiler.parse("@store(type='rdbms') define table T "
                                "(a int);").table_definition_map["T"]
    with pytest.raises(CompileError, match="A15"):
        TableRuntime(tdef, tev.Schema(tdef, tev.StringInterner()),
                     torch.device("cpu"))


# ---------------------------------------------------------------------------
# K9 and K10's plain versions against the reference's device code
# ---------------------------------------------------------------------------

TYPES = ("LONG", "INT", "FLOAT", "BOOL")


def _tables(capacity, seed, pk=False):
    """One empty table per package over the same definition."""
    from siddhi_tpu.compiler import SiddhiCompiler as JC
    from siddhi_tpu_torch.compiler import SiddhiCompiler as TC
    from siddhi_tpu_torch.core import event as tev
    text = (("@PrimaryKey('a') " if pk else "") +
            "define table T (a long, b int, c float, d bool);")
    jd = JC.parse(text).table_definition_map["T"]
    td = TC.parse(text).table_definition_map["T"]
    jt = JaxTable(jd, jev.Schema(jd, jev.StringInterner()), capacity)
    tt = TorchTable(td, tev.Schema(td, tev.StringInterner()),
                    torch.device("cpu"), capacity)
    return jt, tt


def _rand_cols(rng, n, wide=False):
    cols = [rng.integers(-50, 50, n).astype(np.int64),
            rng.integers(-9, 9, n).astype(np.int64 if wide else np.int32),
            (rng.integers(-64, 64, n) / 4).astype(np.float32),
            rng.random(n) < 0.5]
    return cols


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k9_write_plain_against_write_impl(seed, wide):
    """Duplicate slots (last row of the batch wins), invalid rows, slots
    outside the table, and (`wide`) an INT column staged as LONG."""
    rng = np.random.default_rng(seed)
    C, B = 64, 200
    jt, tt = _tables(C, seed)
    for _ in range(3):
        cols = _rand_cols(rng, B, wide)
        ts = rng.integers(0, 1 << 40, B).astype(np.int64)
        slots = rng.integers(-4, C + 4, B).astype(np.int32)
        rv = rng.random(B) < 0.8
        jc, jts, jv = JaxTable._write_impl(
            jt.cols, jt.ts, jt.valid, tuple(jnp.asarray(c) for c in cols),
            jnp.asarray(ts), jnp.asarray(np.where(
                (slots >= 0) & (slots < C), slots, 1 << 30)),
            jnp.asarray(rv))
        jt.cols, jt.ts, jt.valid = jc, jts, jv
        table_write.write(tt.cols, tt.ts, tt.valid, None,
                          tuple(torch.from_numpy(c) for c in cols),
                          torch.from_numpy(ts), torch.from_numpy(slots),
                          torch.from_numpy(rv))
        _same(convert.table_to_numpy(jt), convert.table_to_numpy(tt))


def test_k9_masked_delete_plain_against_reference():
    rng = np.random.default_rng(4)
    valid = rng.random(128) < 0.6
    kill = rng.random(128) < 0.3
    want = np.asarray(JaxTable._masked_delete_impl(jnp.asarray(valid),
                                                   jnp.asarray(kill)))
    v = torch.from_numpy(valid.copy())
    table_write.masked_delete(v, torch.from_numpy(kill))
    assert np.array_equal(v.numpy(), want)


@pytest.mark.parametrize("cond", [
    "T.a == a", "T.a == a and T.c > c", "T.b < b or T.d == d",
    "T.a == a and T.b != b"])
@pytest.mark.parametrize("pk", [False, True])
def test_k10_match_plain_against_match(cond, pk):
    """hit, src (the last matching batch row) and matched_any, dense and
    over the index's candidates, from one seeded table state."""
    from siddhi_tpu.compiler import SiddhiCompiler as JC
    from siddhi_tpu.core.executor import Scope as JScope
    from siddhi_tpu_torch.compiler import SiddhiCompiler as TC
    from siddhi_tpu_torch.core import event as tev
    from siddhi_tpu_torch.core.executor import Scope as TScope
    rng = np.random.default_rng(9)
    C, B = 96, 40
    jt, tt = _tables(C, 9, pk=pk)
    # the same rows in both tables, some invalid
    n = 80
    keys = rng.permutation(200)[:n].astype(np.int64) - 100
    cols = _rand_cols(rng, n)
    cols[0] = keys
    staged = jev.StagedBatch(np.arange(n, dtype=np.int64),
                             np.zeros(n, np.int32), np.ones(n, bool),
                             cols, n)
    jt.insert(staged.to_device(jt.schema), staged)
    tstaged = tev.StagedBatch(staged.ts, staged.kind, staged.valid, cols, n)
    tt.insert(tstaged.to_device(tt.schema, torch.device("cpu")), tstaged)
    kill = rng.random(C) < 0.2
    jt.valid = jnp.logical_and(jt.valid, ~jnp.asarray(kill))
    tt.valid &= ~torch.from_numpy(kill)
    bcols = _rand_cols(rng, B)
    bcols[0] = np.where(rng.random(B) < 0.7,
                        keys[rng.integers(0, n, B)],
                        rng.integers(-300, 300, B)).astype(np.int64)
    bvalid = rng.random(B) < 0.9
    text = "define stream S (a long, b int, c float, d bool);"
    jsch = jev.Schema(JC.parse(text).stream_definition_map["S"],
                      jt.schema.interner)
    tsch = tev.Schema(TC.parse(text).stream_definition_map["S"],
                      tt.schema.interner)
    qt = f"from S update T set T.b = b on {cond};"
    jexpr = JC.parse(text + " define table T (a long, b int, c float, "
                     "d bool);" + qt).execution_element_list[0] \
        .output_stream.on_update_expression
    texpr = TC.parse(text + " define table T (a long, b int, c float, "
                     "d bool);" + qt).execution_element_list[0] \
        .output_stream.on_update_expression
    js, ts_ = JScope(), TScope(torch.device("cpu"))
    for s, sch, tsch2 in ((js, jsch, jt.schema), (ts_, tsch, tt.schema)):
        s.add_source("__out__", sch)
        s.add_source("T", tsch2, default=False)
    jcond = jt.plan_condition(jexpr, js)
    tcond = tt.plan_condition(texpr, ts_, other_key="__out__")
    assert (jcond.plan is None) == (tcond.plan is None)
    jb = jev.EventBatch(jnp.zeros(B, jnp.int64), jnp.zeros(B, jnp.int32),
                        jnp.asarray(bvalid),
                        tuple(jnp.asarray(c) for c in bcols))
    tbatch = tev.EventBatch(torch.zeros(B, dtype=torch.int64),
                            torch.zeros(B, dtype=torch.int32),
                            torch.from_numpy(bvalid),
                            tuple(torch.from_numpy(c) for c in bcols))
    jh, jsrc, jany = jt._match(jcond, "__out__", jb)
    th, tsrc, tany = tt._match(tcond, "__out__", tbatch)
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jsrc), tsrc.numpy())
    assert np.array_equal(np.asarray(jany()), tany())
    assert jt.index_stats == tt.index_stats
    assert np.asarray(jh).any()
    # the plain version's dense mode gives the same on an indexed plan
    h2, s2, a2 = table_match.plain(
        tcond.spec, tbatch.cols, tbatch.ts, tbatch.valid, tt.cols,
        tt.valid)
    assert torch.equal(h2, th) and torch.equal(s2, tsrc) and \
        np.array_equal(a2.numpy(), tany())


# ---------------------------------------------------------------------------
# carrying a table across: convert.table_from_jax
# ---------------------------------------------------------------------------

CARRY = """
@app:playback
define stream In (k long, g int, v float);
define stream Del (g int, v float);
define stream Up (k long, g int, v float);
@PrimaryKey('k') @Index('g') @capacity(rows='256')
define table T (k long, g int, v float);
@info(name='w') from In insert into T;
@info(name='d') from Del delete T on T.g == g and T.v < v;
@info(name='u') from Up update or insert into T set T.v = v on T.k == k;
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_table_from_jax_then_both_continue(seed):
    """A mid-stream JAX table (rows, free slots, allocator, @Index lanes,
    statistics) carried into the port's table; then both packages take
    the same sends and stay equal after each."""
    rng = np.random.default_rng(seed)

    def rows(n, keys):
        return [[int(k), int(rng.integers(0, 6)),
                 float(rng.integers(0, 64)) / 4]
                for k in rng.integers(0, keys, n)]
    first = [rows(40, 120), [[int(g), 8.0] for g in range(3)], rows(30, 160)]
    jm, tm_ = JaxManager(), TorchManager(device="cpu")
    jrt = jm.create_siddhi_app_runtime(CARRY)
    trt = tm_.create_siddhi_app_runtime(CARRY)
    jrt.start()
    trt.start()
    for stream, batch, ts in zip(("In", "Del", "In"), first, (1, 2, 3)):
        jrt.get_input_handler(stream).send(batch, timestamp=1000 + ts)
    convert.table_from_jax(jrt.tables["T"], trt.tables["T"])
    _same(_decoded(jrt.tables["T"]), _decoded(trt.tables["T"]), "carried")
    later = [("In", rows(24, 200)), ("Del", [[1, 12.0], [4, 6.0]]),
             ("Up", [[int(k), 5, 99.0] for k in rng.integers(0, 220, 16)]),
             ("In", rows(24, 240))]
    for i, (stream, batch) in enumerate(later):
        for rt in (jrt, trt):
            rt.get_input_handler(stream).send(batch, timestamp=2000 + i)
        _same(_decoded(jrt.tables["T"]), _decoded(trt.tables["T"]),
              f"after send {i}")
    assert sorted(tuple(e.data) for e in jrt.query("from T select *")) == \
        sorted(tuple(e.data) for e in trt.query("from T select *"))
    jm.shutdown()
    tm_.shutdown()


def test_upsert_output_narrower_than_the_table_raises():
    """The port refuses an upsert whose output lacks table attributes
    (the JAX package's insert of the missing rows would drop the table's
    last columns), in streaming and on-demand queries alike."""
    with pytest.raises(CompileError, match="needs an output of the "
                                           "table's 3 attributes, got 2"):
        TorchManager(device="cpu").create_siddhi_app_runtime(
            CARRY.replace("define stream Up (k long, g int, v float)",
                          "define stream Up (k long, v float)"))
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ONDEMAND)
    rt.get_input_handler("In").send(SEED)
    with pytest.raises(CompileError, match="got 2"):
        rt.query("from T on T.sym == 'a' select 'zz' as sym, 2 as qty "
                 "update or insert into T set T.qty = qty on T.sym == sym")
