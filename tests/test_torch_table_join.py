"""Stream-table joins through both packages' `SiddhiManager`s: the same
events (timestamps, kinds, order, values, nulls), the same batch counts
[n_valid, n_current, n_expired, n_dropped], the batch payload's rows in
device order (before the host's stable timestamp sort: the port's K7
table modes held to the reference step's pair and unmatched index lists),
and the same tables after every send.  Both probe modes are covered: the
grid over the table's rows (no usable index, or a windowed stream side)
and the table fast path (a single-column @PrimaryKey or an @Index on the
join key, a windowless stream side), each also against the grid path on
the same sends.  Table ops driven by join and pattern outputs run through
the shared delivery path.  `chip_smoke.py`'s T3 cases (the table
corpus's shapes with the JAX package's events embedded) are held to both
packages here.

Small sizes (the full sizes are `chip_smoke.py`'s work).  Tolerance:
exact everywhere (floats compared as float32 bit patterns).
"""
import numpy as np
import pytest

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import join as tjoin
from siddhi_tpu_torch.core.executor import CompileError


def _cells(c):
    c = np.asarray(c)
    return c.view(np.int32).tolist() if c.dtype == np.float32 else c.tolist()


def _run(mgr, ql, sends, qname="q"):
    """Events, batch counts, the batch payloads' valid rows in device
    order, and every table's state after each send."""
    rt = mgr.create_siddhi_app_runtime(ql)
    events, counts, rows, tables = [], [], [], []
    rt.add_callback(qname, lambda ts, c, e: events.append(
        (ts, [(x.timestamp, tuple(x.data)) for x in c or []],
         [(x.timestamp, tuple(x.data)) for x in e or []])))

    def on_batch(ts, b):
        counts.append((b["n_valid"], b["n_current"], b["n_expired"],
                       b["n_dropped"]))
        v = b["valid"]
        rows.append([tuple(r) for r in zip(
            b["ts"][v].tolist(), b["kind"][v].tolist(),
            *(_cells(np.asarray(c)[v]) for c in b["cols"].values()))])
    rt.add_batch_callback(qname, on_batch)
    rt.start()
    for stream, cols, ts in sends:
        rt.get_input_handler(stream).send_columns(
            cols, timestamps=np.full(len(cols[0]), ts, np.int64))
        snap = {}
        for tid, t in rt.tables.items():
            d = convert.table_to_numpy(t)
            snap[tid] = ([_cells(c) for c in d["cols"]], d["ts"].tolist(),
                         d["valid"].tolist(), dict(t.index_stats))
        tables.append(snap)
    rt.shutdown()
    return events, counts, rows, tables, rt.query_runtimes[qname]


def same(ql, sends, qname="q", expect_mode="unset"):
    """Both packages over the same sends; everything equal.  Returns the
    port's query runtime and its events."""
    je, jc, jr, jt, _ = _run(JaxManager(), ql, sends, qname)
    te, tc, tr, tt, tq = _run(TorchManager(device="cpu"), ql, sends, qname)
    assert jc == tc, "batch counts"
    assert jr == tr, "rows in device order"
    assert je == te, "events"
    assert jt == tt, "tables"
    assert any(c[0] for c in tc), "the sends produced no joined rows"
    if expect_mode != "unset":
        assert tq.planned.fastpath == expect_mode
    return tq, te


def grid_events(ql, sends, qname="q"):
    """The port's events with the fast path off (the grid path)."""
    tjoin.FASTPATH_ENABLED = False
    try:
        te, _, _, _, tq = _run(TorchManager(device="cpu"), ql, sends, qname)
        assert tq.planned.fastpath is None
        return te
    finally:
        tjoin.FASTPATH_ENABLED = True


QL = """
@app:playback
define stream S (sym long, price float, sid int);
define stream Feed (sym long, name long);
{ann}
define table T (sym long, name long);
@info(name='load') from Feed select sym, name insert into T;
@emit(rows='65536') @info(name='q')
from {lhs} {jt} {rhs} on S.sym == T.sym{residual}
select S.sym as s, price, sid, T.name as n {having} insert into Out;
"""


def _ql(ann="@PrimaryKey('sym')", jt="join", win="", table_left=False,
        residual="", having=""):
    s = f"S{win}"
    lhs, rhs = ("T", s) if table_left else (s, "T")
    return QL.format(ann=ann, jt=jt, lhs=lhs, rhs=rhs, residual=residual,
                     having=having)


def _sends(n=4, B=48, keys=40, seed=31, feed_keys=32, step=300):
    rng = np.random.default_rng(seed)
    out, uid = [], 0
    for i in range(n):
        out.append(("Feed", [rng.integers(0, feed_keys, 16).astype(np.int64),
                             rng.integers(0, 100, 16).astype(np.int64)],
                    1000 + i * step))
        out.append(("S", [rng.integers(0, keys, B).astype(np.int64),
                          (rng.integers(0, 64, B) / 64).astype(np.float32),
                          np.arange(uid, uid + B, dtype=np.int32)],
                    1000 + i * step + 1))
        uid += B
    return out


JOIN_TYPES = ["join", "left outer join", "right outer join",
              "full outer join"]


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("ann,mode", [("@PrimaryKey('sym')", "table"),
                                      ("@Index('sym')", "table"),
                                      ("", None)])
def test_windowless_stream_side(jt, ann, mode):
    """Both probe modes for every join type; the fast path's events equal
    the grid path's."""
    ql = _ql(ann=ann, jt=jt)
    sends = _sends()
    _, te = same(ql, sends, expect_mode=mode)
    if mode is not None:
        assert te == grid_events(ql, sends)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_table_on_the_left(jt):
    same(_ql(jt=jt, table_left=True), _sends(seed=7), expect_mode="table")


@pytest.mark.parametrize("win", ["#window.length(8)", "#window.time(500)"])
@pytest.mark.parametrize("jt", ["join", "left outer join"])
def test_windowed_stream_side_scans_the_table(win, jt):
    """A windowed stream side joins on the grid (its buffered EXPIRED rows
    probe the table too)."""
    tq, _ = same(_ql(jt=jt, win=win), _sends(seed=3), expect_mode=None)
    assert "windowed stream side" in tq.planned.fastpath_reason


@pytest.mark.parametrize("residual,having", [
    (" and S.price > 0.3", ""), ("", "having n > 40"),
    (" and T.name < 70", "having price < 0.8")])
def test_residual_and_having(residual, having):
    ql = _ql(ann="@Index('sym')", jt="left outer join", residual=residual,
             having=having)
    sends = _sends(seed=11)
    tq, te = same(ql, sends, expect_mode="table")
    assert tq.planned.residual == bool(residual)
    assert te == grid_events(ql, sends)


def test_unidirectional_stream_side():
    tq, _ = same(_ql(jt="unidirectional join"), _sends(seed=5),
                 expect_mode="table")
    assert tq.planned.trigger == "LEFT"


def test_stream_side_filter():
    ql = _ql().replace("from S join T", "from S[price > 0.5] join T")
    same(ql, _sends(seed=17), expect_mode="table")


# ---------------------------------------------------------------------------
# the reference's own table-join shapes
# ---------------------------------------------------------------------------

def test_stream_table_join_sample_shape():
    """tests/test_table_join.py test_stream_table_join: a length(1) window
    on the stream side joins an unindexed table."""
    ql = """
    @app:playback
    define stream CheckStream (symbol long);
    define stream FeedStream (symbol long, price float);
    define table StockTable (symbol long, price float);
    from FeedStream select * insert into StockTable;
    @info(name='q')
    from CheckStream#window.length(1) as c join StockTable
      on c.symbol == StockTable.symbol
    select c.symbol as symbol, StockTable.price as price insert into Out;
    """
    same(ql, [("FeedStream", [np.asarray([1, 2], np.int64),
                              np.asarray([11.0, 22.0], np.float32)], 1000),
              ("CheckStream", [np.asarray([2], np.int64)], 1001),
              ("CheckStream", [np.asarray([1, 3, 2], np.int64)], 1002)])


CORPUS = """
@app:playback
define stream In (k long, v int);
define stream Probe (k long);
define stream Up (k long, v int);
define stream Del (k long);
define table T (k long, v int);
@info(name='w') from In insert into T;
@info(name='u') from Up update or insert into T set T.v = v on T.k == k;
@info(name='d') from Del delete T on T.k == k;
@info(name='q') from Probe join T on Probe.k == T.k
select T.k as k, T.v as v insert into Out;
"""


def test_corpus_ops_between_probes():
    """test_table_corpus.py's shapes: inserts, an upsert that inserts and
    one that updates, a delete, each followed by probes."""
    def a(*x):
        return np.asarray(x, np.int64)
    same(CORPUS, [
        ("Up", [a(100), np.asarray([5], np.int32)], 1000),
        ("In", [a(1, 2), np.asarray([1, 2], np.int32)], 1001),
        ("Probe", [a(1, 2, 3, 100)], 1002),
        ("Up", [a(1), np.asarray([42], np.int32)], 1003),
        ("Del", [a(2)], 1004),
        ("Probe", [a(1, 2, 100)], 1005),
        ("In", [a(7)] + [np.asarray([70], np.int32)], 1006),
        ("Probe", [a(7, 1)], 1007)])


def test_enrichment_upsert_then_join():
    """T1's shape at a small size: a @PrimaryKey table written by
    `update or insert` (keys repeating inside a send, so the last writer
    matters) and read by a windowless join in the same app."""
    ql = """
    @app:playback
    define stream StockUpdate (symbol long, price float, volume long);
    define stream CheckStock (symbol long, qty int);
    @PrimaryKey('symbol') @capacity(rows='256')
    define table StockTable (symbol long, price float, volume long);
    @info(name='upsert') from StockUpdate select symbol, price, volume
    update or insert into StockTable on StockTable.symbol == symbol;
    @info(name='q') from CheckStock join StockTable
      on CheckStock.symbol == StockTable.symbol
    select CheckStock.symbol, CheckStock.qty, StockTable.price,
           StockTable.volume insert into Enriched;
    """
    rng = np.random.default_rng(2)
    sends = []
    for i in range(6):
        ids = rng.integers(0, 200, 96).astype(np.int64)
        sends.append(("StockUpdate", [ids, rng.random(96, np.float32),
                                      rng.integers(0, 1000, 96)
                                      .astype(np.int64)], 1000 + 2 * i))
        sends.append(("CheckStock", [rng.integers(0, 216, 80)
                                     .astype(np.int64),
                                     rng.integers(1, 9, 80)
                                     .astype(np.int32)], 1001 + 2 * i))
    same(ql, sends, expect_mode="table")


def test_join_and_pattern_outputs_write_tables():
    """Table ops run from join and pattern outputs alike: a join's rows
    (in the host's ts order) insert into one table, a pattern's matches
    upsert another."""
    ql = """
    @app:playback
    define stream S (sym long, price float, sid int);
    define stream Feed (sym long, name long);
    define table T (sym long, name long);
    define table J (s long, n long);
    @PrimaryKey('sym')
    define table P (sym long, p2 float);
    @info(name='load') from Feed select sym, name insert into T;
    @info(name='q') from S#window.length(4) join T on S.sym == T.sym
    select S.sym as s, T.name as n insert into J;
    @info(name='pat') from every e1=S[price > 0.5] -> e2=S[sym == e1.sym]
    select e1.sym as sym, e2.price as p2
    update or insert into P on P.sym == sym;
    """
    sends = _sends(seed=23, keys=12, feed_keys=12)
    je, jc, jr, jt, _ = _run(JaxManager(), ql, sends)
    te, tc, tr, tt, _ = _run(TorchManager(device="cpu"), ql, sends)
    assert (je, jc, jr) == (te, tc, tr)
    assert jt == tt
    assert any(tt[-1]["P"][2]) and any(tt[-1]["J"][2])


@pytest.mark.parametrize("ql,what", [
    ("""define stream S (a long);
     define table T (a long); define table U (a long);
     from T join U on T.a == U.a select T.a insert into Out;""",
     "two tables"),
    ("""define stream S (a long); define stream R (a long);
     from S join R#window.length(2) on S.a == R.a select S.a
     insert into Out;""", "window on each side"),
])
def test_join_plan_errors(ql, what):
    with pytest.raises(CompileError, match=what):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("name,ql,actions,want", chip_smoke.T3_CASES,
                         ids=[c[0] for c in chip_smoke.T3_CASES])
def test_chip_smoke_t3_expectations(name, ql, actions, want):
    """chip_smoke.py's T3 expectations are the JAX package's events and
    query results, and the port gives them on the CPU."""
    assert chip_smoke.t3_trace(JaxManager(), ql, actions) == want
    assert chip_smoke.t3_trace(TorchManager(device="cpu"), ql,
                               actions) == want
