"""Group by and aggregators in join queries through the port against the
JAX package: `tests/test_join_groupby.py`'s group-by and having cases,
both sides grouping, the right side alone, an outer join whose unmatched
rows take the other side's null group, a windowless stream joined with a
table, and the table-side group attribute that raises.  Events exact (the
sums are of small integers, exact in any order).  `distinctCount` and
`unionSet` stay unported (ROADMAP B14), so those reference cases are not
here.
"""
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError


def _run(make, ql, sends):
    m = make()
    rt = m.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback("j", lambda ts, i, o: got.extend(
        [tuple(e.data) for e in (i or [])]))
    rt.start()
    for stream, data, ts in sends:
        rt.get_input_handler(stream).send(data, timestamp=ts)
    rt.flush()
    m.shutdown()
    return got


def both(ql, sends):
    j = _run(JaxManager, ql, sends)
    t = _run(lambda: TorchManager(device="cpu"), ql, sends)
    assert t == j
    return t


HEAD = """
@app:playback
define stream L (sym string, price float);
define stream R (sym string, qty int);
"""


def test_join_group_by_left_side_attr():
    got = both(HEAD + """
    @info(name='j')
    from L#window.length(10) join R#window.length(10)
      on L.sym == R.sym
    select L.sym as s, sum(R.qty) as total
    group by L.sym
    insert into Out;
    """, [("L", ["A", 1.0], 1000), ("L", ["B", 2.0], 1001),
          ("R", ["A", 5], 1002), ("R", ["B", 7], 1003),
          ("R", ["A", 2], 1004)])
    assert got == [("A", 5), ("B", 7), ("A", 7)]


def test_join_group_by_having():
    got = both(HEAD + """
    @info(name='j')
    from L#window.length(10) join R#window.length(10)
      on L.sym == R.sym
    select L.sym as s, sum(R.qty) as total
    group by L.sym
    having total > 6
    insert into Out;
    """, [("L", ["A", 1.0], 1000), ("R", ["A", 5], 1001),
          ("R", ["A", 3], 1002)])
    assert got == [("A", 8)]


SENDS = [("L", ["A", 1.0], 1000), ("L", ["B", 2.0], 1001),
         ("R", ["A", 5], 1002), ("R", ["C", 7], 1003),
         ("L", ["A", 3.0], 1004), ("R", ["B", 2], 1005),
         ("L", ["C", 1.0], 1006), ("R", ["A", 4], 1007),
         ("L", ["B", 6.0], 1008), ("R", ["B", 1], 1009)]


@pytest.mark.parametrize("body", [
    # both sides group: 63 x 63 composite slots
    "from L#window.length(3) join R#window.length(3) on L.sym == R.sym "
    "select L.sym as s, R.qty as q, count() as n, sum(L.price) as p "
    "group by L.sym, R.qty",
    # the right side alone
    "from L#window.length(4) join R#window.length(4) on L.sym == R.sym "
    "select R.sym as s, max(L.price) as m, avg(R.qty) as a group by R.sym",
    # outer rows take the other side's null group
    "from L#window.length(4) left outer join R#window.length(4) "
    "on L.sym == R.sym select L.sym as s, count() as n, sum(R.qty) as t "
    "group by L.sym, R.sym",
    "from L#window.length(4) full outer join R#window.length(4) "
    "on L.sym == R.sym select count() as n, sum(R.qty) as t group by R.sym",
    # aggregators without group by; a non-equi grid join
    "from L#window.length(3) join R#window.length(3) on L.price < R.qty "
    "select sum(R.qty) as t, min(L.price) as lo",
    # time windows
    "from L#window.time(3 millisec) join R#window.time(3 millisec) "
    "on L.sym == R.sym select L.sym as s, sum(R.qty) as t group by L.sym "
    "having t > 2",
])
def test_join_aggregates(body):
    both(HEAD + "@info(name='j') " + body + " insert into Out;", SENDS)


def test_join_table_group_by_stream_side():
    ql = """
    define stream TI (sym string, qty int);
    define stream L (sym string, price float);
    define table T (sym string, qty int);
    @info(name='w') from TI insert into T;
    @info(name='j') from L join T on L.sym == T.sym
    select L.sym as s, sum(T.qty) as q, count() as n group by L.sym
    insert into Out;
    """
    both(ql, [("TI", ["A", 2], 1), ("TI", ["B", 5], 2), ("L", ["A", 1.0], 3),
              ("L", ["B", 1.0], 4), ("L", ["A", 2.0], 5),
              ("L", ["C", 2.0], 6), ("TI", ["A", 3], 7),
              ("L", ["A", 1.0], 8)])


def test_join_group_by_table_side_raises():
    with pytest.raises(CompileError, match="stream sides"):
        TorchManager(device="cpu").create_siddhi_app_runtime("""
        define stream L (sym string, price float);
        define table T (sym string, qty int);
        @info(name='j')
        from L join T on L.sym == T.sym
        select T.sym as s, sum(L.price) as p
        group by T.sym
        insert into Out;
        """)
