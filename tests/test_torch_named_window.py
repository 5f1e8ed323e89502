"""The port's named windows (`define window`: `NamedWindowRuntime` in
`siddhi_tpu_torch/core/runtime.py`, `PassAllWindow` and each window's
`current_buffer`) against the JAX package.

Whole apps run through both packages and their events are compared
exactly: the apps of `tests/test_named_window.py` (readers with
aggregates and filters, `output current / expired events`, stream
callbacks).  `chip_smoke.X14_CASES` holds the JAX package's events of
every window kind as a named window at a small size (read by a grouped
reader, probed by a unidirectional join whose candidates come in the
window's buffer order, read on demand) and of the apps of
`test_named_window_join.py` (bidirectional and unidirectional joins, a
window joining a table); the port is held to all of them and the JAX
package recomputes a fifth.  Then a window's state carried across
mid-stream with `convert.named_window_from_jax`, the places where the
port does not copy the reference (a `time` window above 2,048 rows, a
window's rows probing a windowless stream side, a named `cron` window),
and what raises.
"""
import numpy as np
import pytest

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core import runtime as jax_runtime
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.exceptions import CompileError


@pytest.fixture
def one_entry_per_fire_time(monkeypatch):
    """The JAX scheduler keeping one timer entry per (time, target), as
    the port's does (`siddhi_tpu_torch/core/runtime.py` notify_at); only
    a `cron` window's events depend on it."""
    orig = jax_runtime._Scheduler.notify_at

    def notify_at(self, ts, q):
        with self._cv:
            if any(t == ts and x is q for t, _, x in self._heap):
                return
        orig(self, ts, q)
    monkeypatch.setattr(jax_runtime._Scheduler, "notify_at", notify_at)


def _drive(mgr, ql, sends, queries=(), ondemand=(), window_cb=None):
    """Each named query's callbacks as (now, [current data], [expired
    data]), the window's stream-callback batches and the on-demand
    results' data."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {q: [] for q in queries}
    for q in queries:
        rt.add_callback(q, lambda ts, i, o, _q=q: got[_q].append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
             [(e.timestamp, tuple(e.data)) for e in o or []])))
    seen = []
    if window_cb is not None:
        rt.add_callback(window_cb, lambda evs: seen.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
    rt.start()
    for stream, rows, ts in sends:
        rt.get_input_handler(stream).send(rows, timestamp=ts)
    rt.flush()
    ond = [[tuple(e.data) for e in rt.query(q)] for q in ondemand]
    mgr.shutdown()
    return got, seen, ond


def both(ql, sends, queries=(), ondemand=(), window_cb=None):
    want = _drive(JaxManager(), ql, sends, queries, ondemand, window_cb)
    got = _drive(TorchManager(device="cpu"), ql, sends, queries, ondemand,
                 window_cb)
    assert got == want
    return got


# -- tests/test_named_window.py ----------------------------------------------

def test_length_window_aggregate_reader():
    ql = """
    @app:playback
    define stream StockStream (symbol string, price float, volume int);
    define window StockWindow (symbol string, price float, volume int)
        length(3) output all events;
    @info(name='ins')
    from StockStream select symbol, price, volume insert into StockWindow;
    @info(name='agg')
    from StockWindow select sum(price) as total, count() as n
    insert into OutStream;
    """
    sends = [("StockStream", [["S", p, i]], 1000 + i)
             for i, p in enumerate([10.0, 20.0, 30.0, 40.0])]
    got, _, _ = both(ql, sends, ["agg"])
    assert got["agg"][-1][1][-1][1] == (90.0, 3)


def test_filtered_reader_and_current_only_output():
    ql = """
    @app:playback
    define stream In (k string, v int);
    define window W (k string, v int) length(2) output current events;
    from In select k, v insert into W;
    @info(name='big') from W[v > 5] select k, v insert into Out;
    @info(name='r') from W select k, v insert into Out2;
    """
    sends = [("In", [[k, v]], 1000 + v) for k, v in
             (("a", 3), ("b", 7), ("c", 9), ("d", 1))]
    got, seen, _ = both(ql, sends, ["big", "r"], window_cb="W")
    assert [x[1] for x in got["big"]] == [[(1007, ("b", 7))],
                                         [(1009, ("c", 9))]]
    assert all(not x[2] for x in got["r"])
    assert len(seen) == 4


def test_stream_callback_sees_expired_rows():
    ql = """
    @app:playback
    define stream In (k string, v int);
    define window W (k string, v int) length(2) output all events;
    from In select k, v insert into W;
    """
    _, seen, _ = both(ql, [("In", [[str(i), i]], 1000 + i)
                           for i in range(3)], window_cb="W")
    assert sum(len(s) for s in seen) == 4


def test_expired_events_output_and_filter_balance():
    """`output expired events`: the reader sees only EXPIRED rows, and a
    filter applies to them as it does to CURRENT rows."""
    ql = """
    @app:playback
    define stream In (k string, v int);
    define window W (k string, v int) length(2) output expired events;
    from In select k, v insert into W;
    @info(name='r') from W[v != 2] select k, sum(v) as s insert into Out;
    """
    both(ql, [("In", [[str(i), i]], 1000 + i) for i in range(6)], ["r"])


# -- every window kind as a named window -------------------------------------

X14 = chip_smoke.X14_CASES


@pytest.mark.parametrize("name,ql,queries,sends,reads,want", X14,
                         ids=[c[0] for c in X14])
def test_x14_cases_give_the_jax_events(name, ql, queries, sends, reads,
                                       want):
    """Every window kind the JAX package probes, as a named window (read,
    joined with its candidates in the buffer's order, read on demand),
    and the join apps: the JAX package's events, embedded in
    chip_smoke.py."""
    assert chip_smoke.nw_run(TorchManager(device="cpu"), ql, queries, sends,
                             reads, "W") == want


@pytest.mark.parametrize("case", X14[::5], ids=[c[0] for c in X14[::5]])
def test_x14_expectations_are_the_jax_events(case):
    name, ql, queries, sends, reads, want = case
    assert chip_smoke.nw_run(JaxManager(), ql, queries, sends, reads,
                             "W") == want


@pytest.mark.parametrize("kind", ["frequent(2)", "lossyFrequent(0.3)"])
def test_kinds_without_a_buffer_raise_for_joins_and_reads(kind):
    """frequent / lossyFrequent keep no buffer: their readers run, and
    joins and on-demand reads raise in both packages."""
    ql = chip_smoke.X14_KIND_QL.format(kind=kind)
    both(ql, chip_smoke.X14_KIND_SENDS, ["r"], window_cb="W")
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        with pytest.raises(Exception, match="buffer"):
            mgr.create_siddhi_app_runtime(ql + chip_smoke.X14_KIND_JOIN)
        rt = mgr.create_siddhi_app_runtime(ql)
        with pytest.raises(Exception, match="on-demand"):
            rt.query("from W select *")


@pytest.mark.parametrize("kind", ["time(2 sec)", "timeBatch(1 sec)",
                                  "externalTime(ts, 2 sec)",
                                  "expression('sum(v) < 20')"])
def test_window_state_from_jax_mid_stream(kind):
    """A window's state carried across with convert.named_window_from_jax
    (and the reader's with query_state_from_jax); both packages then
    continue from it alike."""
    ql = chip_smoke.X14_KIND_QL.format(kind=kind) + \
        chip_smoke.X14_KIND_JOIN
    jm, tm = JaxManager(), TorchManager(device="cpu")
    jrt = jm.create_siddhi_app_runtime(ql)
    trt = tm.create_siddhi_app_runtime(ql)
    outs = {}
    for name, rt in (("jax", jrt), ("torch", trt)):
        got = outs[name] = []
        for q in ("r", "j"):
            rt.add_callback(q, lambda ts, i, o, _q=q, _g=got: _g.append(
                (_q, ts, [tuple(e.data) for e in i or []],
                 [tuple(e.data) for e in o or []])))
        rt.start()
    for stream, rows, ts in chip_smoke.X14_KIND_SENDS[:4]:
        jrt.get_input_handler(stream).send(rows, timestamp=ts)
    for s in ("a", "b", "c"):
        tm.interner.intern(s)
    trt._playback_time = jrt._playback_time
    convert.named_window_from_jax(jrt.named_windows["W"],
                                  trt.named_windows["W"])
    # the reader's group slots and aggregates too
    tq, jq = trt.query_runtimes["r"], jrt.query_runtimes["r"]
    tq.state = convert.query_state_from_jax(tq.planned, jq.state)
    convert.pair_allocators_from_jax(tq.planned, jq.planned)
    outs["jax"].clear()
    w = jrt.named_windows["W"]
    if w.needs_timer and w.next_wakeup < jax_runtime._NO_WAKEUP_INT:
        trt._scheduler.notify_at(int(w.next_wakeup),
                                 trt.named_windows["W"])
    for rt in (jrt, trt):
        for stream, rows, ts in chip_smoke.X14_KIND_SENDS[4:]:
            rt.get_input_handler(stream).send(rows, timestamp=ts)
    assert outs["torch"] == outs["jax"]
    assert [tuple(e.data) for e in trt.query("from W select *")] == \
        [tuple(e.data) for e in jrt.query("from W select *")]
    jm.shutdown()
    tm.shutdown()


# -- where the port does not copy the reference ------------------------------

CAP_APP = """
@app:playback
define stream In (id long, v double);
define window W (id long, v double) time(1 min) output all events;
@info(name='ins') from In select * insert into W;
@info(name='r') from W select count() as n, sum(v) as s insert into R;
"""


def test_time_window_keeps_rows_above_the_reference_capacity():
    """The JAX package builds a named window of 2,048 rows, so a `time`
    window above that drops its oldest rows unemitted
    (`siddhi_tpu/core/window.py:400-405`); the port's ring grows and
    keeps every row (X14 holds the two equal below 2,048 rows)."""
    def drive(mgr, n):
        rt = mgr.create_siddhi_app_runtime(CAP_APP)
        last = []
        rt.add_callback("r", lambda ts, i, o: last.append(
            tuple(i[-1].data)) if i else None)
        rt.start()
        h = rt.get_input_handler("In")
        for s in range(n // 500):
            h.send([[s * 500 + j, 1.0] for j in range(500)],
                   timestamp=1000 + s)
        rows = len(rt.query("from W select *"))
        mgr.shutdown()
        return rows, last[-1]
    jrows, _ = drive(JaxManager(), 3000)
    trows, tlast = drive(TorchManager(device="cpu"), 3000)
    assert jrows == 2048
    assert (trows, tlast) == (3000, (3000, 3000.0))


def test_window_rows_probe_an_empty_windowless_stream_side():
    """A bidirectional join of a named window with a windowless stream:
    the reference's window side probes the stream's pass-through state
    and fails at every row the window publishes; the port's window rows
    probe an empty side.  The stream side's triggers agree."""
    ql = """
    @app:playback
    define stream T (t long);
    define stream In (k string, v double);
    define window W (k string, v double) length(4);
    @info(name='ins') from In select * insert into W;
    @info(name='q') from T join W select T.t as t, W.k as k, W.v as v
    insert into Out;
    @info(name='lo') from W left outer join T on W.k == 'x'
    select W.k as k, T.t as t insert into Out2;
    """
    sends = [("In", [["a", 1.0], ["b", 2.0]], 1000), ("T", [[7]], 1001),
             ("In", [["c", 3.0]], 1002), ("T", [[8]], 1003)]
    want, _, _ = _drive(JaxManager(), ql, sends, ["q"])
    got, _, _ = _drive(TorchManager(device="cpu"), ql, sends, ["q", "lo"])
    assert got["q"] == want["q"]
    assert [[d for _, d in c] for _, c, _ in got["lo"]] == [
        [("a", None), ("b", None)], [("c", None)]]


def test_named_cron_window_flushes_on_its_schedule():
    """The JAX package's named window schedules only its step's device
    wake, which a cron window leaves unset (its query path schedules cron
    on the host, `siddhi_tpu/core/runtime.py:466-467`), so a named cron
    window never flushes there.  The port's flushes at each fire time:
    its reader sees the rows a query-level cron window of the same rows
    gives (the JAX package, recomputed)."""
    ql = chip_smoke.X14_KIND_QL.format(kind="cron('*/2 * * * * ?')")
    sends = [x for x in chip_smoke.X14_KIND_SENDS if x[0] == "In"]
    want, _, _ = _drive(JaxManager(), ql, sends, ["r"])
    got, _, _ = _drive(TorchManager(device="cpu"), ql, sends, ["r"])
    flushed = [x for x in got["r"] if x[2]]
    assert not [x for x in want["r"] if x[2]] and flushed
    assert [x[0] % 2000 for x in flushed] == [0] * len(flushed)


def test_chip_smoke_nw1_at_a_small_size(monkeypatch):
    """chip_smoke.run_nw1's closed forms (the reader's last row per room,
    every trigger's pairs, the last trigger's rows per room) held to the
    port's plain path at 64 rooms."""
    import torch
    monkeypatch.setattr(chip_smoke, "check_launched", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda *a: {
        "wall_ms": 0.0, "device_ms": None, "idle_share": None, "top": []})
    # event_timer's order: a warm call, then each timed call after before()
    monkeypatch.setattr(chip_smoke, "event_timer",
                        lambda torch, fn, reps, before=None: (
                            fn(), before(), fn(), 0.0)[-1])
    chip_smoke.run_nw1(torch, np, torch.device("cpu"), sends=14, rooms=64,
                       devices=256, B=2048)


# -- what raises --------------------------------------------------------------

def test_session_with_a_key_raises_on_a_named_window():
    ql = """
    define stream In (k string, v int);
    define window W (k string, v int) session(1 sec, k);
    """
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        with pytest.raises(Exception, match="session"):
            mgr.create_siddhi_app_runtime(ql)


def test_window_on_a_named_window_input_raises():
    ql = """
    define stream In (k string, v int);
    define window W (k string, v int) length(2);
    from In select * insert into W;
    from W#window.length(3) select k insert into Out;
    """
    with pytest.raises(CompileError, match="named-window input"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_output_arity_must_match_the_window():
    ql = """
    define stream In (k string, v int);
    define window W (k string, v int) length(2);
    from In select k insert into W;
    """
    with pytest.raises(CompileError, match="arity"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_in_named_window_is_not_probe_able():
    ql = """
    define stream In (k string, v int);
    define window W (k string, v int) length(2);
    from In[k in W] select k insert into Out;
    """
    with pytest.raises(CompileError, match="not probe-able"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_kernel_views_are_copies():
    """A join's view of a window is a copy: the window's next step moving
    its ring in place leaves the view as it was."""
    mgr = TorchManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        chip_smoke.X14_KIND_QL.format(kind="length(2)"))
    rt.start()
    h = rt.get_input_handler("In")
    h.send([["a", 1, 1], ["b", 2, 2]], timestamp=1)
    nw = rt.named_windows["W"]
    cols, ts, alive = nw.current_buffer()
    before = [c.clone() for c in cols]
    h.send([["c", 3, 3], ["d", 4, 4]], timestamp=2)
    assert all(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(cols, before))
    assert alive.all()
    mgr.shutdown()
