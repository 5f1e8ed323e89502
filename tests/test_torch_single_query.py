"""Single-stream queries through both packages' `SiddhiManager`s give the
same events: timestamps, kinds, order, values, and the batch payload's
`n_current` / `n_expired`.

Inputs come from numpy seeds.  Tolerance: timestamps, kinds, order,
integer values and counts exact; float32 aggregates exact too, because the
prices are dyadic (k/64) and every running sum stays below 2^17, where any
order of float32 additions is exact.  The JAX side runs on the CPU, as its
own tests run it.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import Event as JaxEvent
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import Event as TorchEvent
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG1 = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(window='{cap}')
@info(name='q') from S#window.time(1 sec)
select symbol, sum(price) as sp, count() as c, avg(volume) as av
group by symbol having sp > 0.0
insert into Out;
"""
CONFIG2 = """
@app:playback
define stream StockStream (symbol long, price float, volume int);
@info(name='q') from StockStream#window.lengthBatch({n})
select avg(price) as ap insert into OutputStream;
"""


def _sample(name):
    with open(os.path.join(_ROOT, "samples", "apps", name)) as fh:
        return fh.read()


def _run(manager, event_cls, ql, qnames, sends, stream):
    """Events and batch counts of each query in `qnames` (one name or a
    tuple) over the sends."""
    rt = manager.create_siddhi_app_runtime(ql)
    single = isinstance(qnames, str)
    qnames = (qnames,) if single else qnames
    got = []
    for qname in qnames:
        events, counts = [], []
        rt.add_callback(qname, lambda ts, i, o, _e=events: _e.append(
            (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
             [(e.timestamp, tuple(e.data)) for e in o or []])))
        rt.add_batch_callback(qname, lambda ts, b, _c=counts: _c.append(
            (ts, b["n_current"], b["n_expired"])))
        got.append((events, counts))
    rt.start()
    h = rt.get_input_handler(stream)
    for cols, ts in sends:
        if cols is None:        # ts holds [(timestamp, row), ...]
            h.send([event_cls(t, r) for t, r in ts])
        else:
            h.send_columns(cols, timestamps=ts)
    rt.shutdown()
    return got[0] if single else got


def _both(ql, qname, sends, stream):
    je = _run(JaxManager(), JaxEvent, ql, qname, sends, stream)
    te = _run(TorchManager(device="cpu"), TorchEvent, ql, qname, sends,
              stream)
    return je, te


def _same(a, b, clock=True, approx=None):
    """Events equal: floats compared exactly, NaN equal to NaN.  Without
    playback (`clock=False`) the callback's own timestamp is the wall
    clock and is not compared; the events' are.  `approx` maps a column to
    a check(row, u, v) used instead of equality (see the stdDev test)."""
    approx = approx or {}
    assert len(a) == len(b)
    for (ta, ia, oa), (tb, ib, ob) in zip(a, b):
        assert ta == tb or not clock
        for xa, xb in ((ia, ib), (oa, ob)):
            assert [t for t, _ in xa] == [t for t, _ in xb]
            for (_, da), (_, db) in zip(xa, xb):
                assert len(da) == len(db)
                for j, (u, v) in enumerate(zip(da, db)):
                    if isinstance(u, float) and u != u:
                        assert v != v
                    elif j in approx and u is not None:
                        assert approx[j](da, u, v), (da, db)
                    else:
                        assert u == v, (da, db)


def _dyadic(rng, n):
    return (rng.integers(1, 64, n) / 64.0).astype(np.float32)


def test_simple_filter_sample():
    ql = _sample("simple_filter.siddhi")
    rng = np.random.default_rng(11)
    sends = []
    for i in range(6):
        n = int(rng.integers(1, 40))
        rows = [(1000 + 7 * i, [f"s{int(rng.integers(0, 5))}",
                                float(rng.integers(0, 128)) / 2.0,
                                int(rng.integers(0, 200))])
                for _ in range(n)]
        sends.append((None, rows))
    (je, jc), (te, tc) = _both(ql, "filterQuery", sends, "StockStream")
    _same(je, te, clock=False)
    assert [c[1:] for c in jc] == [c[1:] for c in tc]
    assert sum(len(i) for _, i, _ in te) > 0


def test_temperature_window_playback():
    ql = "@app:playback\n" + _sample("temperature_window.siddhi")
    rng = np.random.default_rng(12)
    sends = []
    for i in range(10):
        n = int(rng.integers(1, 30))
        ts = 1000 + i * 15000
        rows = [[int(rng.integers(0, 4)), float(rng.integers(0, 256)) / 8]
                for _ in range(n)]
        sends.append((None, [(ts, r) for r in rows]))
    (je, jc), (te, tc) = _both(ql, "avgTempQuery", sends, "TempStream")
    _same(je, te)
    assert jc == tc
    assert any(o for _, _, o in te)


def _config1_sends(rng, n_sends, B, n_sym, order="in"):
    """bench.py's traffic for config_time_groupby_having, with sends 100 ms
    apart (not 10), so that ten sends fill the 1-second window.  Out of
    order ("jitter"), timestamps move by whole sends, within and across
    sends; each distinct expiry time costs a TIMER step, so they stay on a
    coarse grid."""
    sends = []
    for i in range(n_sends):
        if order == "in":
            ts = np.full(B, 1000 + 100 * i, np.int64)
        elif order == "jitter":
            ts = 1000 + 100 * (i + rng.integers(-3, 3, B)).astype(np.int64)
        else:
            ts = np.sort(1000 + 100 * i + 25 * rng.integers(0, 4, B)).astype(
                np.int64)
        sends.append(([rng.integers(0, n_sym, B).astype(np.int64),
                       _dyadic(rng, B), np.ones(B, np.int32)], ts))
    return sends


@pytest.mark.parametrize("order", ["in", "jitter", "sorted-within"])
def test_config1_reduced(order):
    """bench.py config_time_groupby_having at 2048 events per send with a
    window of 8192 rows (the window overflows: the oldest rows drop)."""
    rng = np.random.default_rng(13)
    sends = _config1_sends(rng, 24, 2048, 256, order)
    ql = CONFIG1.format(cap=8192)
    (je, jc), (te, tc) = _both(ql, "q", sends, "S")
    _same(je, te)
    assert jc == tc


def test_config1_whole_window():
    """A window that holds the whole second: every expired row is
    emitted, n_expired equals the rows sent ten sends earlier."""
    rng = np.random.default_rng(14)
    sends = _config1_sends(rng, 24, 64, 8)
    ql = CONFIG1.format(cap=8192)
    (je, jc), (te, tc) = _both(ql, "q", sends, "S")
    _same(je, te)
    assert jc == tc
    assert any(ne == 64 for _, _, ne in tc)


@pytest.mark.parametrize("n,B", [(1000, 2048), (7, 50), (64, 64)])
def test_config2_reduced(n, B):
    """bench.py config_length_batch: several flushes per send, RESET
    epochs in the aggregator."""
    rng = np.random.default_rng(15)
    sends = [([np.zeros(B, np.int64), _dyadic(rng, B),
               np.ones(B, np.int32)], np.full(B, 1000 + i, np.int64))
             for i in range(5)]
    ql = CONFIG2.format(n=n)
    (je, jc), (te, tc) = _both(ql, "q", sends, "StockStream")
    _same(je, te)
    assert jc == tc


def test_chained_queries():
    ql = """
    @app:playback
    define stream S (symbol long, price float, volume int);
    @info(name='a') from S[volume > 2]#window.time(100)
    select symbol, sum(price) as sp, max(volume) as mv group by symbol
    insert into Mid;
    @info(name='b') from Mid[sp >= 0.5]#window.lengthBatch(5)
    select symbol, count() as c, min(sp) as lo insert into Out;
    """
    rng = np.random.default_rng(16)
    sends = [([rng.integers(0, 4, 20).astype(np.int64), _dyadic(rng, 20),
               rng.integers(0, 6, 20).astype(np.int32)],
              np.full(20, 1000 + 40 * i, np.int64)) for i in range(12)]
    jax_out, torch_out = _both(ql, ("a", "b"), sends, "S")
    for (je, jc), (te, tc) in zip(jax_out, torch_out):
        _same(je, te)
        assert jc == tc
        assert te


def test_out_of_subset_raises_at_plan_time_on_cuda():
    """Planned for CUDA, a query the kernels do not take raises before
    any traffic: too many columns for the kernels, too many accumulator
    columns for group_agg."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.planner import (kernel_subset_violation,
                                               plan_single_query)
    cols = ", ".join(f"c{i} int" for i in range(20))
    ql = f"define stream W ({cols});\nfrom W[c0 > 1] select c0 insert into O;"
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    q = SiddhiCompiler.parse(ql).execution_element_list[0]
    with pytest.raises(NotImplementedError, match="kernels' subset"):
        plan_single_query(q, "q", rt.schemas, rt.manager.interner,
                          device=torch.device("cuda"))
    aggs = ", ".join(f"min(c{i}) as m{i}" for i in range(9))
    ql = (f"define stream V (c0 int, c1 int, c2 int, c3 int, c4 int, "
          f"c5 int, c6 int, c7 int, c8 int);\n"
          f"from V select {aggs} insert into O;")
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    p = rt.query_runtimes["query1"].planned
    assert "accumulator columns" in kernel_subset_violation(
        p.in_schema, p.selector_exec)


@pytest.mark.parametrize("body,item", [
    ("from S#pol2Cart(price, price) select price insert into O;", "A4"),
    ("from S#window.length(4) select distinctCount(symbol) as d "
     "insert into O;", "B14"),
    ("from S select ifThenElse(price > 1.0, 1, 0) as d insert into O;",
     "A4"),
])
def test_unported_single_stream_features_raise(body, item):
    ql = "define stream S (symbol long, price float, volume int);\n" + body
    with pytest.raises(CompileError, match=item):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_keyed_cron_parity():
    """A cron window inside a partition (once a raising case above) is
    kept per key (kernel K21, `kernels/keyed_ext.py`): under playback the
    timer's fire times tick every key, each flushing its own batch; the
    port gives the JAX package's events (its scheduler kept to one timer
    entry per fire time, as the port's)."""
    from siddhi_tpu.core import runtime as jax_runtime
    ql = """@app:playback
    define stream S (symbol long, price float, volume int);
    partition with (symbol of S) begin
    @info(name='q') from S#window.cron('*/5 * * * * ?')
    select symbol, sum(price) as total insert all events into O; end;"""
    sends = [("S", [[s, float(i + s), i] for s in range(3)], 1000 + 2000 * i)
             for i in range(7)]
    orig = jax_runtime._Scheduler.notify_at

    def notify_at(self, ts, q):
        with self._cv:
            if any(t == ts and x is q for t, _, x in self._heap):
                return
        orig(self, ts, q)
    jax_runtime._Scheduler.notify_at = notify_at
    try:
        want = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    finally:
        jax_runtime._Scheduler.notify_at = orig
    assert sum(len(e) for _, _, e in want) > 0
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q",
                                 sends) == want


def test_windowless_distinct_count_parity():
    """A windowless distinctCount, once a raising case above, gives the
    JAX package's events: a batched send with repeated values, then sends
    that repeat and extend them."""
    ql = """define stream S (symbol long, price float, volume int);
    @info(name='q') from S select symbol, distinctCount(volume) as d,
    sizeOfSet(unionSet(createSet(price))) as p group by symbol
    insert into O;"""
    rng = np.random.default_rng(17)
    sends = [([rng.integers(0, 4, 32).astype(np.int64),
               rng.integers(0, 5, 32).astype(np.float32),
               rng.integers(0, 6, 32).astype(np.int32)],
              np.full(32, 1000 + i, np.int64)) for i in range(3)]
    je, te = _both(ql, "q", sends, "S")
    _same(je[0], te[0], clock=False)
    assert [c[1:] for c in je[1]] == [c[1:] for c in te[1]]


def test_every_aggregator_and_nulls():
    """Every built-in aggregator, null inputs, having over an aggregate
    that is not projected and one that is."""
    ql = """
    @app:playback
    define stream S (k int, p float, v long, b bool);
    @info(name='q') from S#window.time(50)
    select k, sum(p) as sp, sum(v) as sv, avg(p) as ap, count() as c,
           min(p) as mnp, max(v) as mxv, minForever(v) as mnf,
           maxForever(p) as mxf, stdDev(p) as sd, and(b) as ab, or(b) as ob
    group by k having c > 1 or ap > 0.25
    insert into O;
    """
    rng = np.random.default_rng(17)
    sends = []
    for i in range(14):
        rows = []
        for _ in range(8):
            p = None if rng.random() < 0.2 else float(
                rng.integers(0, 64)) / 64
            v = None if rng.random() < 0.2 else int(rng.integers(-50, 50))
            rows.append((1000 + 20 * i, [int(rng.integers(0, 3)), p, v,
                                         bool(rng.random() < 0.6)]))
        sends.append((None, rows))
    (je, jc), (te, tc) = _both(ql, "q", sends, "S")
    # stdDev (column 9) is sqrt(E[x^2] - E[x]^2) of exact sums; XLA on the
    # CPU may contract `q/c - m*m` into a fused multiply-add, which the
    # port does not, so the variances agree within a few float32 ulps of
    # E[x^2] (about avg^2 + var), not exactly
    def var_close(row, u, v):
        return abs(u * u - v * v) <= 2 ** -21 * (row[3] ** 2 + u * u)
    _same(je, te, approx={9: var_close})
    assert jc == tc


def test_wall_clock_timer_expires_rows():
    """Without playback the scheduler's thread fires the time window's
    expiry on the wall clock: the rows come back EXPIRED with ts equal to
    their expiry time, and the thread stops at shutdown."""
    import time
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(
        "define stream S (k int, p float);\n"
        "@info(name='q') from S#window.time(50) select k, sum(p) as sp "
        "group by k insert into O;")
    got = []
    rt.add_callback("q", lambda ts, i, o: got.append((i or [], o or [])))
    rt.start()
    t0 = rt.timestamp_millis()
    rt.get_input_handler("S").send([TorchEvent(t0, [1, 0.5]),
                                    TorchEvent(t0, [2, 0.25])])
    deadline = time.time() + 5
    while time.time() < deadline and not any(o for _, o in got):
        time.sleep(0.01)
    rt.shutdown()
    expired = [e for _, o in got for e in o]
    assert [e.timestamp for e in expired] == [t0 + 50, t0 + 50]
    assert sorted(e.data[0] for e in expired) == [1, 2]
    assert rt._scheduler._thread is None


def test_post_window_filter_compiles_to_bytecode():
    """A filter after the window compiles to the bytecode kernel K15 runs
    on CUDA (planned for the CPU, the plan holds its compiled filter and no
    bytecode); on the CPU the query gives the JAX package's events."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.executor import Scope
    from siddhi_tpu_torch.kernels.filter_bytecode import compile_filter
    ql = """
    @app:playback
    define stream S (symbol long, price float, volume int);
    @info(name='q') from S#window.time(100)[volume > 2]
    select symbol, sum(price) as sp group by symbol insert into Out;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    q = SiddhiCompiler.parse(ql).execution_element_list[0]
    post = rt.query_runtimes["q"].planned.post_spec
    assert len(post.compiled) == 1 and post.bytecode is None
    scope = Scope(torch.device("cpu"))
    scope.interner = rt.interner
    scope.add_source("S", rt.schemas["S"])
    assert compile_filter(q.input_stream.stream_handlers[1].expression,
                          scope, "S", {})
    rng = np.random.default_rng(17)
    sends = [([rng.integers(0, 4, 16).astype(np.int64), _dyadic(rng, 16),
               rng.integers(0, 6, 16).astype(np.int32)],
              np.full(16, 1000 + 60 * i, np.int64)) for i in range(6)]
    (je, jc), (te, tc) = _both(ql, "q", sends, "S")
    _same(je, te)
    assert jc == tc
    assert any(o for _, _, o in te)


def test_short_expire_bound_raises_and_changes_nothing():
    """A time window step whose host-side expire bound is short (here the
    ring's facts are emptied by hand) raises at the header fetch and
    leaves the window and the aggregates as they were."""
    ql = """
    @app:playback
    define stream S (k long, p float);
    @info(name='q') from S#window.time(100) select k, sum(p) as sp
    group by k insert into O;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    h = rt.get_input_handler("S")
    rng = np.random.default_rng(18)

    def send(t):
        h.send_columns([rng.integers(0, 4, 32).astype(np.int64),
                        _dyadic(rng, 32)],
                       timestamps=np.full(32, t, np.int64))
    send(1000)
    send(1050)
    qr = rt.query_runtimes["q"]
    ring, agg = qr.state
    before = ring.clone()
    agg_before = [a.clone() for a in agg]
    ring.facts.entries = []
    with pytest.raises(RuntimeError, match="expire bound"):
        send(1120)
    ring2, agg2 = qr.state
    for x, y in ((ring2.meta, before.meta), (ring2.ts, before.ts),
                 (ring2.expire_ts, before.expire_ts),
                 *zip(ring2.cols, before.cols), *zip(agg2, agg_before)):
        assert torch.equal(x, y)
