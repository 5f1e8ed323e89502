"""`timeBatch` through the port (kernel K12's plain version,
`kernels/time_batch.py`) against the JAX package.

Whole apps run through both packages (events exact): the timeBatch cases
of `tests/test_window_corpus.py` and `tests/test_corpus_r4b.py`, a gap that
collapses several boundaries into one flush, a flush driven by a TIMER
with no arrival, arrivals that straddle a boundary and out-of-order
timestamps.  Then the window step itself, from a JAX state carried
across mid-slice with `convert.query_state_from_jax`: every step's valid
rows, its wake and both slices equal to the JAX step's (exact: the window
moves rows, it computes nothing), with and without a filter before the
window.
"""
import jax
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import query_state_from_jax
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import BatchFacts


def _run(make, ql, sends):
    m = make()
    rt = m.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.append(
        (ts, [tuple(e.data) for e in i or []],
         [tuple(e.data) for e in o or []])))
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


def window_ql(window, select="sym, price", out="insert all events into Out",
              extra=""):
    return f"""
    @app:playback
    define stream S (sym string, price float);
    define stream X (v int);
    {extra}
    @info(name='q') from S#window.{window}
    select {select} {out};
    """


def test_time_batch_golden():
    """`test_window_corpus.py::test_time_batch_golden`."""
    got = both(window_ql("timeBatch(1 sec)"), [
        ("S", ["a", 1.0], 1000), ("S", ["b", 2.0], 1400),
        ("S", ["c", 3.0], 2100), ("S", ["d", 4.0], 3100)])
    assert [r for _, i, _ in got for r in i] == [("a", 1.0), ("b", 2.0),
                                                 ("c", 3.0)]
    assert [r for _, _, o in got for r in o] == [("a", 1.0), ("b", 2.0)]


def test_time_batch_with_aggregation():
    """`test_window_corpus.py::test_window_with_aggregation_smoke`'s
    timeBatch(2 sec) case."""
    both(window_ql("timeBatch(2 sec)", "sym, sum(price) as total",
                   "insert into Out"),
         [("S", ["a", 1.0], 1000), ("S", ["b", 2.0], 1500),
          ("S", ["c", 3.0], 2500), ("S", ["d", 4.0], 3200),
          ("S", ["e", 5.0], 5100)])


def test_time_batch_flush():
    """`test_corpus_r4b.py::test_time_batch_flush`."""
    ql = """
    @app:playback
    define stream S (v int);
    @info(name='q') from S#window.timeBatch(1 sec)
    select sum(v) as t insert into Out;
    """
    got = both(ql, [("S", [1], 1000), ("S", [2], 1400), ("S", [5], 2500)])
    assert (3,) in [r for _, i, _ in got for r in i]


def test_filter_before_the_window():
    """A filter before the window: the host learns the slice start from
    the state once the first passing arrival sets it."""
    both(window_ql("timeBatch(1 sec)", "sym, sum(price) as s").replace(
        "from S#window", "from S[price > 1.5]#window"),
        [("S", ["a", 1.0], 1000), ("S", ["b", 1.2], 1300),
         ("S", ["c", 3.0], 1700), ("S", ["d", 2.0], 2600),
         ("S", ["e", 1.0], 2900), ("S", ["f", 4.0], 3400),
         ("X", [0], 5200), ("S", ["g", 5.0], 5300)])


def test_collapsed_boundaries_and_timer_flush():
    """A gap of several slices flushes once; a TIMER (the clock moved by
    another stream) flushes a slice with no arrival, then an empty one."""
    both(window_ql("timeBatch(1 sec)", "sym, count() as n",
                   "insert all events into Out"),
         [("S", ["a", 1.0], 1000), ("S", ["b", 2.0], 1400),
          ("S", ["c", 3.0], 5300),            # boundaries 2000..5000
          ("S", ["d", 4.0], 5400),
          ("X", [0], 6500),                   # TIMER at 6300
          ("X", [0], 9000),                   # empty slices
          ("S", ["e", 5.0], 9100)])


def test_straddle_and_out_of_order():
    """One send whose arrivals straddle the boundary, and sends whose
    timestamps run backwards."""
    rows = [["a", 1.0], ["b", 2.0], ["c", 3.0], ["d", 4.0]]
    ql = window_ql("timeBatch(1 sec)", "sym, price, sum(price) as s")
    m_j, m_t = JaxManager(), TorchManager(device="cpu")
    outs = []
    for m in (m_j, m_t):
        rt = m.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda ts, i, o: got.append(
            ([tuple(e.data) for e in i or []],
             [tuple(e.data) for e in o or []])))
        rt.start()
        h = rt.get_input_handler("S")
        h.send(["z", 0.5], timestamp=1000)
        h.send_columns([np.array([m.interner.intern(r[0]) for r in rows],
                                 np.int32),
                        np.array([r[1] for r in rows], np.float32)],
                       timestamps=np.array([1900, 2000, 2100, 1950]))
        h.send_columns([np.array([m.interner.intern("x")] * 3, np.int32),
                        np.array([7.0, 8.0, 9.0], np.float32)],
                       timestamps=np.array([3500, 2800, 3100]))
        h.send(["y", 1.0], timestamp=4200)
        rt.flush()
        m.shutdown()
        outs.append(got)
    assert outs[1] == outs[0]
    # the wake at 2000 fires before the straddling send (playback)
    assert outs[0][0][0] == [("z", 0.5, 0.5)]
    assert [r[0] for r in outs[0][1][0]] == ["a", "b", "c", "d"]


# ---------------------------------------------------------------------------
# the window step from a converted state
# ---------------------------------------------------------------------------

SCHEMA = "define stream S (symbol long, price float, volume int, ok bool);\n"


def _plans(body):
    ql = "@app:playback\n" + SCHEMA + body
    jrt = JaxManager().create_siddhi_app_runtime(ql)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.query_runtimes["q"], trt.query_runtimes["q"]


def _batch(rng, B, n, ts, timer=False):
    ts = np.asarray(ts, np.int64)
    kind = np.full(B, ev.TIMER if timer else ev.CURRENT, np.int32)
    valid = np.zeros(B, np.bool_)
    valid[:n] = True
    cols = [rng.integers(0, 6, B).astype(np.int64),
            (rng.integers(0, 64, B) / 64).astype(np.float32),
            rng.integers(0, 9, B).astype(np.int32), rng.random(B) < 0.5]
    gslot = rng.integers(0, 6, B).astype(np.int32)
    return ts, kind, valid, cols, gslot


def _slices_equal(jw, tw, i):
    pend, prev, start, seq = jax.device_get(jw)
    meta = [int(x) for x in tw.meta]
    assert meta[0] == int(start) and meta[1] == int(seq), f"step {i}"
    for (tts, tgs, tcols), buf in zip(tw.slices(), (pend, prev)):
        alive = np.asarray(buf.alive)
        n = int(alive.sum())
        assert tts.shape[0] == n, f"step {i}: fill"
        np.testing.assert_array_equal(np.asarray(buf.ts)[:n], tts.numpy())
        np.testing.assert_array_equal(np.asarray(buf.gslot)[:n],
                                      tgs.numpy())
        for a, b in zip(buf.cols, tcols):
            np.testing.assert_array_equal(np.asarray(a)[:n], b.numpy())


@pytest.mark.parametrize("filt", ["", "[price > 0.25]"],
                         ids=["exact", "filtered"])
def test_time_batch_steps_from_converted_state(filt):
    """Sends every 130 ms (some out of order, some TIMER-only) into a
    500 ms timeBatch: flushes with and without arrivals in the slice, the
    state carried over from the JAX step mid-slice."""
    jq, tq = _plans(f"@capacity(window='1024')\n@info(name='q') "
                    f"from S{filt}#window.timeBatch(500) select symbol, "
                    f"price insert all events into O;")
    jp, tp = jq.planned, tq.planned
    jstage = jax.jit(lambda w, ts, kind, valid, cols, gslot, now:
                     jp.stage_body(w, ts, kind, valid, cols, gslot, now, ()))
    rng = np.random.default_rng(11 + len(filt))
    jw, tw, clock, warm = jq.state[0], None, 1000, 5
    flushes = 0
    for i in range(22):
        clock += 130 if i != 14 else 1700        # one collapsing gap
        if i % 6 == 5:
            b, now = _batch(rng, 8, 1, np.full(8, clock), True), clock
        else:
            ts = clock + rng.integers(-100, 30, 32)
            n = int(rng.integers(16, 33))
            b, now = _batch(rng, 32, n, ts), int(max(clock, ts[:n].max()))
        ts, kind, valid, cols, gslot = b
        if i == warm:
            tw, _ = query_state_from_jax(tp, (jax.device_get(jw), ()))
        jw, jrows, jwake = jstage(jw, ts, kind, valid, tuple(cols), gslot,
                                  np.int64(now))
        if i < warm:
            continue
        cur = ts[valid & (kind == ev.CURRENT)]
        batch = ev.EventBatch(torch.from_numpy(ts), torch.from_numpy(kind),
                              torch.from_numpy(valid),
                              tuple(torch.from_numpy(c) for c in cols))
        tw, trows, twake = tp.stage_body(tw, batch, torch.from_numpy(gslot),
                                         now, BatchFacts(cur, ts.shape[0]))
        jr = jax.device_get(jrows)
        jv = np.asarray(jr.valid)
        tv = trows.valid.numpy()
        assert jv.sum() == tv.sum(), f"step {i}: row counts"
        flushes += int((np.asarray(jr.kind)[jv] == ev.RESET).sum())
        for f in ("ts", "kind", "seq", "gslot"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jr, f))[jv],
                getattr(trows, f).numpy()[tv], err_msg=f"step {i} {f}")
        for c, (a, b2) in enumerate(zip(jr.cols, trows.cols)):
            np.testing.assert_array_equal(np.asarray(a)[jv], b2.numpy()[tv],
                                          err_msg=f"step {i} col {c}")
        assert int(jwake) == int(twake[0]) and int(twake[1]) == 0, \
            f"step {i}: wake"
        _slices_equal(jw, tw, i)
    assert flushes >= 3


def test_time_batch_overflow_raises(caplog):
    """A slice above the window's capacity: the reference drops the rows
    it cannot keep; the port keeps those that fit and raises."""
    ql = """
    @app:playback
    define stream S (v int);
    @capacity(window='8')
    @info(name='q') from S#window.timeBatch(1 sec)
    select v insert into Out;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.add_callback("q", lambda ts, i, o: None)
    rt.start()
    h = rt.get_input_handler("S")
    cap = rt.query_runtimes["q"].planned.window.capacity
    h.send_columns([np.arange(cap - 2, dtype=np.int32)],
                   timestamps=np.full(cap - 2, 1000))
    # the junction logs a step's error and drops the batch (@OnError LOG)
    h.send_columns([np.arange(4, dtype=np.int32)],
                   timestamps=np.full(4, 1200))
    assert "2 rows did not fit the time batch window" in caplog.text
