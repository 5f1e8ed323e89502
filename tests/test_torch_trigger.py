"""The port's triggers (`TriggerRuntime` in `siddhi_tpu_torch/core/
runtime.py`: `'start'`, `every <t>` and cron) against the JAX package.

Under `@app:playback` the fire times are event times, so both packages'
events compare exactly: a start trigger, a periodic one and a cron one
read by queries, a periodic trigger joined with a named `time` window
(the query guide's pattern, TR1 at a small size) and a trigger feeding a
named window.  Each fire enqueues one scheduler entry in both packages,
so the events agree without deduplicating the JAX scheduler's entries.
On the wall clock (as `tests/test_trigger.py` runs them) the port's
triggers fire and reschedule themselves.
"""
import time

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager


def _drive(mgr, ql, sends, queries):
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {q: [] for q in queries}
    for q in queries:
        rt.add_callback(q, lambda ts, i, o, _q=q: got[_q].append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
             [(e.timestamp, tuple(e.data)) for e in o or []])))
    rt.start()
    for stream, rows, ts in sends:
        rt.get_input_handler(stream).send(rows, timestamp=ts)
    rt.flush()
    mgr.shutdown()
    return got


def both(ql, sends, queries):
    want = _drive(JaxManager(), ql, sends, queries)
    got = _drive(TorchManager(device="cpu"), ql, sends, queries)
    assert got == want
    return got


SENDS = [("In", [[1, 1.0]], 500), ("In", [[2, 2.0]], 2500),
         ("In", [[3, 3.0], [4, 4.0]], 2600), ("In", [[5, 5.0]], 6100),
         ("In", [[6, 6.0]], 9000)]


def test_start_periodic_and_cron_triggers_under_playback():
    ql = """
    @app:playback
    define stream In (id int, v double);
    define trigger Init at 'start';
    define trigger Tick at every 1 sec;
    define trigger Cron at '*/2 * * * * ?';
    @info(name='s') from Init select triggered_time insert into O1;
    @info(name='p') from Tick select triggered_time as t insert into O2;
    @info(name='c') from Cron select triggered_time insert into O3;
    """
    got = both(ql, SENDS, ["s", "p", "c"])
    assert len(got["s"]) == 1
    assert [x[1][0][1][0] for x in got["p"]] == list(range(1000, 9001,
                                                           1000))
    assert [x[1][0][1][0] % 2000 for x in got["c"]] == [0] * len(got["c"])


def test_periodic_trigger_joins_a_named_time_window():
    """TR1's shape: a trigger joined with a named time window, aggregating
    over every pair (group by over the window side raises in both
    packages), and a reader of the same window.  The trigger side is
    unidirectional: the reference's window rows would otherwise probe the
    windowless trigger stream and fail, and its window would then not
    schedule its expiry (`tests/test_torch_named_window.py`)."""
    ql = """
    @app:playback
    define stream In (id int, v double);
    define window W (id int, v double) time(2 sec) output all events;
    define trigger Tick at every 1 sec;
    @info(name='ins') from In select * insert into W;
    @info(name='r') from W select id, count() as n group by id
    insert into R;
    @info(name='t') from Tick unidirectional join W
    select Tick.triggered_time as t, max(W.v) as hot, count() as n,
           sum(W.v) as s
    insert into TickOut;
    """
    both(ql, SENDS, ["t", "r"])


def test_trigger_feeds_a_named_window():
    ql = """
    @app:playback
    define stream In (id int, v double);
    define trigger Tick at every 1 sec;
    define window W (t long) length(3) output all events;
    @info(name='f') from Tick select triggered_time as t insert into W;
    @info(name='r') from W select count() as n, max(t) as last
    insert into R;
    """
    both(ql, SENDS, ["r"])


def test_cron_next_fire_equals_the_jax_package():
    """The port's copy of `utils/cron.py` fires where the JAX package's
    does (the host's local time in both)."""
    from siddhi_tpu.utils.cron import CronExpression as JaxCron
    from siddhi_tpu_torch.utils.cron import CronExpression as TorchCron
    base = 1_700_000_000_000
    for expr in ("*/5 * * * * ?", "0 30 8 * * ?", "* * * * * ?",
                 "0 0/15 * * * ?"):
        t, j = TorchCron(expr), JaxCron(expr)
        a = b = base
        for _ in range(3):
            a, b = t.next_fire(a), j.next_fire(b)
            assert a == b


def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_wall_clock_triggers_fire_and_reschedule():
    ql = """
    define trigger Init at 'start';
    define trigger Tick at every 100 milliseconds;
    define trigger Sec at '* * * * * ?';
    @info(name='s') from Init select triggered_time insert into O1;
    @info(name='p') from Tick select triggered_time insert into O2;
    @info(name='c') from Sec select triggered_time insert into O3;
    """
    mgr = TorchManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {q: [] for q in "spc"}
    for q in "spc":
        rt.add_callback(q, lambda ts, i, o, _q=q: got[_q].extend(i or []))
    rt.start()
    assert _wait_for(lambda: len(got["p"]) >= 3 and len(got["c"]) >= 1
                     and len(got["s"]) == 1, timeout=4.0)
    mgr.shutdown()
    assert isinstance(got["s"][0].data[0], int)
    t = [e.data[0] for e in got["p"]]
    assert all(b - a >= 100 for a, b in zip(t, t[1:]))
