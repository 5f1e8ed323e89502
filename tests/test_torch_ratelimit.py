"""Output rate limiting through both packages' `SiddhiManager`s gives the
same events: the cases of `tests/test_ratelimit.py` and
`tests/test_ratelimit_corpus2.py` (every `output [all|first|last] every
N events | <t>` and `output snapshot every <t>` form, with and without
group by), each rate form over a join, a pattern and a partitioned query,
and a time window whose expiry timers fall due at the same times as its
`output snapshot every` ticks.  Time-based cases run under
`@app:playback`, except the two wall-clock cases of
`tests/test_ratelimit.py`, whose events are compared once both packages
have delivered them.  Tolerance: exact.
"""
import time

import pytest

import chip_smoke

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError


def _run(manager, ql, qname, sends, tick=None):
    """(callback ts, current, expired) of a query over `sends`: (stream,
    rows, timestamp or None).  `tick(rt)` runs after the sends."""
    rt = manager.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(qname, lambda ts, i, o: got.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in o or []])))
    rt.start()
    for stream, rows, ts in sends:
        rt.get_input_handler(stream).send(rows, timestamp=ts)
    if tick is not None:
        tick(rt)
    rt.flush()
    rt.shutdown()
    manager.shutdown()
    return got


def _both(ql, qname, sends, clock=True, tick=None):
    je = _run(JaxManager(), ql, qname, sends, tick)
    te = _run(TorchManager(device="cpu"), ql, qname, sends, tick)
    if not clock:       # wall clock: the callbacks' and events' ts differ
        je, te = ([[[r for _, r in rows] for rows in x[1:]] for x in e]
                  for e in (je, te))
    assert te == je
    return je


def _sends(stream, rows, t0=None, dt=1):
    return [(stream, [list(r)], None if t0 is None else t0 + dt * i)
            for i, r in enumerate(rows)]


IN = "define stream In (k string, v int);\n"
SEVEN = _sends("In", [(str(i), i) for i in range(7)], 1000)


@pytest.mark.parametrize("rate,sends", [
    ("output all every 3 events", SEVEN),
    ("output first every 3 events", SEVEN),
    ("output last every 3 events", SEVEN),
    ("output every 3 events", _sends("In", [(f"e{i}", i) for i in range(7)],
                                     1000)),
])
def test_per_events(rate, sends):
    ql = ("@app:playback\n" + IN +
          f"@info(name='q') from In select k, v {rate} insert into Out;")
    assert _both(ql, "q", sends)


GROUPED = _sends("In", [("a", 1), ("b", 10), ("a", 2), ("b", 20), ("a", 3)],
                 1000)


@pytest.mark.parametrize("rate,agg", [
    ("output first every 4 events", "sum(v) as total"),
    ("output last every 4 events", "sum(v) as total"),
    ("output last every 4 events", "v"),
    ("output first every 4 events", "v"),
])
def test_group_by_per_events(rate, agg):
    ql = ("@app:playback\n" + IN + f"@info(name='q') from In select k, {agg}"
          f" group by k {rate} insert into Out;")
    assert _both(ql, "q", GROUPED)


def test_last_group_by_every_time_manual_tick():
    """Latest per group flushed at a tick fired by hand (as the reference
    test does)."""
    ql = (IN + "@info(name='q') from In select k, sum(v) as total group by "
          "k output last every 1 sec insert into Out;")
    sends = _sends("In", [("a", 1), ("a", 2), ("b", 5)])

    def tick(rt):
        rt.query_runtimes["q"].rate_limiter.on_timer(
            int(time.time() * 1000))
    # the wall-clock tick may also fire, so the rows, not their batching,
    # are compared (as the reference test does)
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        ev = _run(mgr, ql, "q", sends, tick)
        assert sorted(r for _, i, _ in ev for _, r in i) == [("a", 3),
                                                            ("b", 5)]


S = "@app:playback\ndefine stream S (sym string, v int);\n"


@pytest.mark.parametrize("body,rows", [
    ("select sym, v output first every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1200), (("c", 3), 1800), (("d", 4), 2100),
      (("e", 5), 2500)]),
    ("select sym, v output last every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1200), (("c", 3), 2100),
      (("d", 4), 3100)]),
    ("select sym, v output snapshot every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1400), (("c", 3), 2100),
      (("d", 4), 3200)]),
    ("select sym, v output all every 500 milliseconds",
     [(("a", 1), 1000), (("b", 2), 1100), (("c", 3), 1700),
      (("d", 4), 2600)]),
    ("select sym, sum(v) as t group by sym output snapshot every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1400), (("a", 3), 2100),
      (("b", 4), 3200), (("a", 5), 3300)]),
    ("select sym, sum(v) as t group by sym output first every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1400), (("a", 3), 1900),
      (("b", 4), 2200), (("a", 5), 2300)]),
    ("select sym, sum(v) as t group by sym output last every 1 sec",
     [(("a", 1), 1000), (("b", 2), 1400), (("a", 3), 1900),
      (("b", 4), 2200), (("a", 5), 3300)]),
])
def test_per_time_playback(body, rows):
    ql = S + f"@info(name='q') from S {body} insert into Out;"
    sends = [("S", [list(r)], ts) for r, ts in rows]
    assert _both(ql, "q", sends)


def test_after_filter_and_window():
    """The limiter sees query output only: filtered rows and the window's
    aggregation never count toward N."""
    ql = S + ("@info(name='q') from S[v > 0]#window.lengthBatch(2) "
              "select sym, sum(v) as sv output all every 2 events "
              "insert into Out;")
    rows = [(("a", 1), 1000), (("x", -5), 1100), (("b", 2), 1200),
            (("c", 3), 1300), (("d", 4), 1400)]
    assert _both(ql, "q", [("S", [list(r)], ts) for r, ts in rows])


def test_no_rate_passes_through():
    ql = S + "@info(name='q') from S select sym insert into Out;"
    assert _both(ql, "q", [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1001)])


def test_repro_output_last_every_3_events():
    """The reproduction: seven sends emit (2, 3.0) and then (5, 6.0)."""
    ql = ("define stream S (symbol long, price float);\n"
          "@info(name='q') from S[price > 0.0] select symbol, price\n"
          "output last every 3 events insert into Out;")
    sends = [("S", [k, k + 1.0], None) for k in range(7)]
    ev = _both(ql, "q", sends, clock=False)
    assert [r for i, _ in ev for r in i] == [(2, 3.0), (5, 6.0)]


def test_snapshot_with_coinciding_window_timer():
    """A time window's expiry timers and the snapshot limiter's ticks fall
    due at the same playback times (every 1000 ms): which fires first, and
    whether a tick fires twice, shows in the snapshots."""
    ql = S + ("@info(name='q') from S#window.time(1 sec) "
              "select sym, sum(v) as t group by sym "
              "output snapshot every 1 sec insert all events into Out;")
    rows = [(("a", 1), 1000), (("b", 2), 1000), (("a", 3), 1500),
            (("b", 4), 2000), (("a", 5), 3000), (("c", 6), 3000),
            (("a", 7), 4000), (("b", 8), 6000)]
    ev = _both(ql, "q", [("S", [list(r)], ts) for r, ts in rows])
    assert len(ev) >= 4


J = ("@app:playback\ndefine stream L (sym string, p int);\n"
     "define stream R (sym string, q int);\n")
JOIN_SENDS = [("L", [["a", 1]], 1000), ("R", [["a", 10]], 1100),
              ("L", [["b", 2]], 1200), ("R", [["b", 20]], 1300),
              ("L", [["a", 3]], 1400), ("R", [["a", 30]], 2600),
              ("L", [["b", 4]], 2700)]
PATTERN_SENDS = [("S", [["a", 1]], 1000), ("S", [["a", 2]], 1100),
                 ("S", [["b", 1]], 1200), ("S", [["b", 5]], 1300),
                 ("S", [["a", 1]], 2400), ("S", [["a", 9]], 2500),
                 ("S", [["c", 1]], 2600), ("S", [["c", 2]], 3700)]
PARTITION_SENDS = [("S", [["a", 1]], 1000), ("S", [["b", 2]], 1100),
                   ("S", [["a", 3]], 1200), ("S", [["b", 4]], 1300),
                   ("S", [["a", 5]], 2400), ("S", [["c", 6]], 2500),
                   ("S", [["b", 7]], 3600)]
RATES = ["output all every 2 events", "output first every 2 events",
         "output last every 2 events", "output first every 1 sec",
         "output last every 1 sec", "output all every 1 sec",
         "output snapshot every 1 sec"]


@pytest.mark.parametrize("rate", RATES)
def test_join_query(rate):
    ql = J + ("@info(name='q') from L#window.length(4) join "
              "R#window.length(4) on L.sym == R.sym select L.sym as s, "
              f"L.p as p, R.q as q {rate} insert into Out;")
    assert _both(ql, "q", JOIN_SENDS)


@pytest.mark.parametrize("rate", RATES)
def test_pattern_query(rate):
    ql = S + ("@info(name='q') from every e1=S[v == 1] -> e2=S[v > 1] "
              f"select e1.sym as s, e2.v as v {rate} insert into Out;")
    assert _both(ql, "q", PATTERN_SENDS)


@pytest.mark.parametrize("rate", RATES)
def test_partitioned_query(rate):
    ql = S + ("partition with (sym of S) begin @info(name='q') "
              "from S#window.length(2) select sym, sum(v) as t "
              f"{rate} insert into Out; end;")
    assert _both(ql, "q", PARTITION_SENDS)


def test_partitioned_pattern_query():
    ql = S + ("partition with (sym of S) begin @info(name='q') "
              "from every e1=S[v == 1] -> e2=S[v > 1] select e1.sym as s, "
              "e2.v as v output last every 2 events insert into Out; end;")
    assert _both(ql, "q", PATTERN_SENDS)


def test_wall_clock_all_every_time():
    """`output all every 150 milliseconds` on the wall clock: the five
    rows arrive, in order, in both packages."""
    ql = (IN + "@info(name='q') from In select k, v output all every 150 "
          "milliseconds insert into Out;")
    rows = []
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        rt = mgr.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda ts, i, o, g=got: g.extend(
            tuple(e.data) for e in i or []))
        rt.start()
        for i in range(5):
            rt.get_input_handler("In").send([str(i), i])
        deadline = time.time() + 3.0
        while time.time() < deadline and len(got) < 5:
            time.sleep(0.02)
        mgr.shutdown()
        rows.append(got)
    assert rows[1] == rows[0] == [(str(i), i) for i in range(5)]


def test_wall_clock_snapshot_grouped():
    ql = (IN + "@info(name='q') from In select k, sum(v) as total group by "
          "k output snapshot every 150 milliseconds insert into Out;")
    snaps = []
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        rt = mgr.create_siddhi_app_runtime(ql)
        batches = []
        rt.add_callback("q", lambda ts, i, o, b=batches: b.append(
            sorted(tuple(e.data) for e in i or [])))
        rt.start()
        h = rt.get_input_handler("In")
        for row in (["a", 1], ["b", 10], ["a", 2]):
            h.send(row)
        want = [("a", 3), ("b", 10)]
        deadline = time.time() + 3.0
        while time.time() < deadline and want not in batches:
            time.sleep(0.02)
        mgr.shutdown()
        # a tick may fall between two sends; the snapshot after the last
        # send holds every group's latest row
        snaps.append(want if want in batches else batches)
    assert snaps[1] == snaps[0] == [("a", 3), ("b", 10)]


def test_first_last_group_by_needs_projected_key():
    ql = (IN + "@info(name='q') from In select sum(v) as t group by k "
          "output last every 2 events insert into Out;")
    with pytest.raises(CompileError, match="group-by attribute"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("name,ql,qname,sends,want", chip_smoke.R1_CASES,
                         ids=[c[0] for c in chip_smoke.R1_CASES])
def test_chip_smoke_r1_expectations(name, ql, qname, sends, want):
    """chip_smoke.py's R1 expectations are the JAX package's events, and
    the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want
