"""`@pipeline` and `@async` in the port (`siddhi_tpu_torch/core/runtime.py`
`_emit`, `_EmissionDrainer`, `StreamJunction.enable_async`) against the
JAX package, on the CPU.

`@pipeline` runs on the producer thread, so the events each query
delivered are compared after EVERY send between the packages.  `@async`
delivers from other threads: each send is followed by `flush()` before
its view is taken.  Tolerance: exact.

Shapes from `tests/test_pipeline_emit.py`: one-deep deferral, the
app-level annotation, a partitioned pattern, shutdown delivering held
emissions, timer-bearing and cron queries delivering inline, a
partitioned plain query, depth k draining to k/2 and shutdown draining
all.  From `tests/test_async_ingest.py:30-83`: two `@async` streams fed
concurrently, per-stream order with one worker.  Also: the `queue.policy`
values and `@async` on a query (the emission drainer).  Left out:
`test_pipeline_snapshot_drains_pending`,
`test_pipeline_snapshot_with_reingesting_callback` and
`test_async_snapshot_quiesces_workers` (snapshots, ROADMAP A13).
"""
import threading
import time

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.executor import CompileError


def port_mgr():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def values(rt, q):
    got = []
    rt.add_callback(q, lambda ts, cur, exp: got.extend(
        e.data[0] if len(e.data) == 1 else tuple(e.data)
        for e in (cur or [])))
    return got


def both(ql, drive, q="q"):
    """drive(rt, got) -> list of per-step views, for both packages."""
    out = []
    for m in (siddhi_tpu.SiddhiManager(), port_mgr()):
        rt = m.create_siddhi_app_runtime(ql)
        got = values(rt, q)
        rt.start()
        out.append(drive(rt, got))
        rt.shutdown()
    assert out[0] == out[1]
    return out[1]


def test_pipeline_defers_one_batch_then_flushes():
    def drive(rt, got):
        assert rt.query_runtimes["q"].pipeline_emit
        h = rt.get_input_handler("S")
        views = []
        for v in (1, 2):
            h.send([v])
            views.append(list(got))
        rt.flush()
        return views + [list(got)]
    assert both("""
    define stream S (v int);
    @pipeline @info(name='q') from S select v * 2 as w insert into Out;
    """, drive) == [[], [2], [2, 4]]


def test_app_level_pipeline_annotation():
    def drive(rt, got):
        h = rt.get_input_handler("S")
        views = []
        for v in range(5):
            h.send([v])
            views.append(list(got))
        rt.flush()
        return views + [list(got)]
    assert both("""
    @app:pipeline
    define stream S (v int);
    @info(name='q') from S select v + 1 as w insert into Out;
    """, drive)[-1] == [1, 2, 3, 4, 5]


def test_pipeline_pattern_query():
    def drive(rt, got):
        h = rt.get_input_handler("S")
        views = []
        for k, v in ((3, 1), (5, 1), (3, 2), (5, 2)):
            h.send([k, v])
            views.append(sorted(got))
        rt.flush()
        return views + [sorted(got)]
    assert both("""
    define stream S (k long, v int);
    partition with (k of S) begin
    @capacity(keys='16', slots='4') @pipeline @info(name='q')
    from every e1=S[v == 1] -> e2=S[v == 2]
    select e1.k as k insert into Out;
    end;
    """, drive)[-1] == [3, 5]


def test_pipeline_shutdown_delivers_pending():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @pipeline @info(name='q') from S select v insert into Out;
    """)
    got = values(rt, "q")
    rt.start()
    rt.get_input_handler("S").send([42])
    assert got == []
    rt.shutdown()
    assert got == [42]


def _wait(pred, seconds):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_pipeline_timer_queries_deliver_inline():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @pipeline @info(name='q') from S#window.time(60 ms)
    select v insert into Out;
    """)
    pairs = []
    rt.add_callback("q", lambda ts, cur, exp: pairs.append(
        [e.data[0] for e in (exp or [])]))
    rt.start()
    rt.get_input_handler("S").send([5])
    assert _wait(lambda: [5] in pairs, 5), pairs
    rt.shutdown()


def test_pipeline_cron_window_not_deferred():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @pipeline @info(name='q') from S#window.cron('*/1 * * * * ?')
    select sum(v) as t insert into Out;
    """)
    got = values(rt, "q")
    rt.start()
    rt.get_input_handler("S").send([5])
    assert _wait(lambda: got, 2.5), "cron flush did not arrive"
    rt.shutdown()


def test_pipeline_partitioned_plain_query():
    def drive(rt, got):
        assert rt.query_runtimes["q"].pipeline_emit
        h = rt.get_input_handler("S")
        views = []
        for row in ([3, 10], [3, 5]):
            h.send(row)
            views.append(list(got))
        rt.flush()
        return views + [list(got)]
    assert both("""
    @app:pipeline
    define stream S (k long, v int);
    partition with (k of S) begin
    @capacity(keys='16') @info(name='q')
    from S select k, sum(v) as t insert into Out;
    end;
    """, drive)[-1] == [(3, 10), (3, 15)]


def test_pipeline_depth_k_defers_up_to_k():
    def drive(rt, got):
        assert rt.query_runtimes["q"].pipeline_emit == 4
        h = rt.get_input_handler("S")
        views = []
        for v in range(1, 6):
            h.send([v])
            views.append(list(got))
        rt.flush()
        return views + [list(got)]
    views = both("""
    define stream S (v int);
    @pipeline(depth='4') @info(name='q')
    from S select v * 10 as w insert into Out;
    """, drive)
    assert views[3] == [] and views[4] == [10, 20, 30]
    assert views[-1] == [10, 20, 30, 40, 50]


def test_pipeline_depth_k_shutdown_drains_all():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @pipeline(depth='8') @info(name='q')
    from S select v as w insert into Out;
    """)
    got = values(rt, "q")
    rt.start()
    h = rt.get_input_handler("S")
    for v in range(6):
        h.send([v])
    assert got == []
    rt.shutdown()
    assert got == list(range(6))


ASYNC_QL = """
@async(buffer.size='64', workers='1')
define stream A (k long, v int);
@async(buffer.size='64', workers='1')
define stream B (k long, v int);

@info(name='qa') from A select k, sum(v) as total insert into OutA;
@info(name='qb') from B select k, sum(v) as total insert into OutB;
"""


def test_async_two_streams_concurrent_ingest():
    m = port_mgr()
    rt = m.create_siddhi_app_runtime(ASYNC_QL)
    tot = {"a": 0, "b": 0}
    lk = threading.Lock()

    def cb(key):
        def f(ts, b):
            with lk:
                tot[key] += b["n_current"]
        return f
    rt.add_batch_callback("qa", cb("a"))
    rt.add_batch_callback("qb", cb("b"))
    rt.start()
    assert rt.junctions["A"]._async_q is not None
    assert rt.junctions["B"]._async_q is not None
    n_batches, B = 20, 256

    def pump(stream):
        h = rt.get_input_handler(stream)
        for _ in range(n_batches):
            h.send_columns([np.arange(B, dtype=np.int64),
                            np.ones(B, np.int32)])
    ts = [threading.Thread(target=pump, args=(s,)) for s in "AB"]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rt.flush()
    assert tot == {"a": n_batches * B, "b": n_batches * B}
    m.shutdown()


def test_async_preserves_per_stream_order_single_worker():
    def drive(rt, got):
        h = rt.get_input_handler("S")
        views = []
        for _ in range(30):
            h.send([1])
            rt.flush()
            views.append(list(got))
        return views
    views = both("""
    @async(buffer.size='16', workers='1')
    define stream S (v int);
    @info(name='q') from S select sum(v) as total insert into Out;
    """, drive)
    assert views[-1] == list(range(1, 31))


def test_async_query_emission_drainer():
    """`@async` on a query: its emissions go through the emission drainer
    thread, in order, each flush delivering what was sent."""
    def drive(rt, got):
        assert rt.query_runtimes["q"].async_emit
        h = rt.get_input_handler("S")
        views = []
        for v in range(12):
            h.send([v])
            rt.flush()
            views.append(list(got))
        return views
    views = both("""
    define stream S (v int);
    @async @info(name='q') from S[v % 3 != 0] select v * 2 as w
    insert into Out;
    """, drive)
    assert views[-1] == [2 * v for v in range(12) if v % 3]


def test_async_queue_policy():
    bad = """
    @async(buffer.size='4', queue.policy='drop')
    define stream S (v int);
    @info(name='q') from S select v insert into Out;
    """
    rt = port_mgr().create_siddhi_app_runtime(bad)
    with pytest.raises(CompileError):
        rt.start()
    rt = port_mgr().create_siddhi_app_runtime(bad.replace("drop", "shed"))
    got = values(rt, "q")
    rt.start()
    h = rt.get_input_handler("S")
    for v in range(40):
        h.send([v])
    rt.flush()
    j = rt.junctions["S"]
    assert len(got) + j.shed_total == 40
    assert got == sorted(got)
    rt.shutdown()


def test_fused_pipeline_sample_under_async_and_pipeline():
    """FP1's app with @pipeline(depth='4') or @async on the fused query:
    the events equal the plain run's."""
    base = open("samples/apps/fused_pipeline.siddhi").read()
    rng = np.random.default_rng(8)
    feed = [[[f"d{int(rng.integers(0, 5))}",
              round(float(rng.uniform(-10, 100)), 2),
              bool(rng.random() < 0.9)] for _ in range(6)]
            for _ in range(13)]

    def go(ql):
        rt = port_mgr().create_siddhi_app_runtime("@app:playback\n" + ql)
        got = {q: values(rt, q) for q in ("fusedClean", "alerts")}
        rt.start()
        h = rt.get_input_handler("SensorStream")
        for i, rows in enumerate(feed):
            h.send(rows, timestamp=1000 + i)
        rt.flush()
        rt.shutdown()
        return got
    plain = go(base)
    assert plain["fusedClean"] and plain["alerts"]
    for deco in ("@pipeline(depth='4')", "@async"):
        assert go(base.replace("@fuse(batches='8')",
                               f"@fuse(batches='8') {deco}")) == plain
