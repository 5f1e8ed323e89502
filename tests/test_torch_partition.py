"""Partitioned plain queries through both packages' `SiddhiManager`s give
the same events: the per-key aggregation sample, the non-pattern cases of
`tests/test_partition.py` and `tests/test_partition_ext.py` (count, group
by under the partition key, an inner-stream chain, `length` and
`lengthBatch` windows per key, the partitioned join), and sends that
interleave several keys in one `send_columns` batch for each keyed window
(`length`, `time` with its timer ticks, `lengthBatch` with two keys
flushing in one send), a key with more events in one send than its
window holds, and a pre-window filter.

chip_smoke.py's numpy models of its P1 and P4 configurations are held to
the port's rows at a small size, with the JAX package giving the same
events.

Inputs come from numpy seeds.  Tolerance: timestamps, kinds, order,
integer values and counts exact; float32 aggregates exact too, because the
values are dyadic (k/64) and every running sum stays below 2^17, where any
order of float32 additions is exact.
"""
import os

import numpy as np
import pytest

import chip_smoke

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(manager, ql, qname, sends):
    """Events (callback ts, current, expired) and batch counts of a query
    over `sends`: (stream, rows or numpy columns, timestamp(s))."""
    rt = manager.create_siddhi_app_runtime(ql)
    events, counts = [], []
    rt.add_callback(qname, lambda ts, i, o: events.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in o or []])))
    rt.add_batch_callback(qname, lambda ts, b: counts.append(
        (ts, b["n_current"], b["n_expired"])))
    rt.start()
    for stream, data, ts in sends:
        h = rt.get_input_handler(stream)
        if isinstance(data, tuple):
            h.send_columns(list(data), timestamps=ts)
        else:
            h.send(data, timestamp=ts)
    rt.shutdown()
    manager.shutdown()
    return events, counts


def _both(ql, qname, sends):
    je, jc = _run(JaxManager(), ql, qname, sends)
    te, tc = _run(TorchManager(device="cpu"), ql, qname, sends)
    assert te == je
    assert [c[1:] for c in tc] == [c[1:] for c in jc]
    return je


def _n_events(events):
    return sum(len(i) + len(o) for _, i, o in events)


def test_partition_by_key_sample():
    with open(os.path.join(_ROOT, "samples", "apps",
                           "partition_by_key.siddhi")) as fh:
        ql = "@app:playback\n" + fh.read()
    rng = np.random.default_rng(1)
    syms = ["IBM", "WSO2", "ORCL", "MSFT", "GOOG"]
    sends = []
    for i in range(8):
        n = int(rng.integers(1, 30))
        rows = [[syms[int(rng.integers(0, 5))],
                 float(rng.integers(0, 256)) / 4.0,
                 int(rng.integers(0, 100))] for _ in range(n)]
        sends.append(("TradeStream", rows, 1000 + 10 * i))
    assert _n_events(_both(ql, "perSymbolMax", sends)) > 40


SYM = [("S", ["IBM", 1.0, 1], 1000), ("S", ["WSO2", 1.0, 1], 1001),
       ("S", ["IBM", 1.0, 1], 1002), ("S", ["IBM", 1.0, 1], 1003),
       ("S", ["WSO2", 1.0, 1], 1004)]


@pytest.mark.parametrize("ql,qname,sends", [
    ("""@app:playback
     define stream S (symbol string, price float, volume int);
     partition with (symbol of S)
     begin
       @info(name='query1')
       from S select symbol, count() as c insert into Out;
     end;""", "query1", SYM),
    ("""@app:playback
     define stream S (region string, symbol string, volume int);
     partition with (region of S)
     begin
       @info(name='query1')
       from S select region, symbol, sum(volume) as t
       group by symbol insert into Out;
     end;""", "query1",
     [("S", ["US", "IBM", 10], 1000), ("S", ["EU", "IBM", 100], 1001),
      ("S", ["US", "IBM", 1], 1002), ("S", ["US", "MSFT", 5], 1003),
      ("S", ["EU", "IBM", 2], 1004)]),
    ("""@app:playback
     define stream S (symbol string, volume int);
     partition with (symbol of S)
     begin
       from S select symbol, count() as c insert into #Inner;
       @info(name='query2')
       from #Inner[c >= 2] select symbol, c insert into Out;
     end;""", "query2",
     [("S", ["A", 1], 1000), ("S", ["A", 1], 1001), ("S", ["B", 1], 1002),
      ("S", ["A", 1], 1003)]),
    ("""@app:playback
     define stream S (sym string, price float);
     partition with (sym of S)
     begin
       @info(name='q') from S#window.length(2)
       select sym, sum(price) as total
       insert all events into Out;
     end;""", "q",
     [("S", ["A", 1.0], 1000), ("S", ["B", 10.0], 1001),
      ("S", ["A", 2.0], 1002), ("S", ["A", 4.0], 1003),
      ("S", ["B", 20.0], 1004)]),
    ("""@app:playback
     define stream S (sym string, v int);
     partition with (sym of S)
     begin
       @info(name='q') from S#window.lengthBatch(2)
       select sym, sum(v) as total
       insert into Out;
     end;""", "q",
     [("S", ["A", 1], 1000), ("S", ["B", 10], 1001), ("S", ["A", 2], 1002),
      ("S", ["B", 20], 1003), ("S", ["A", 5], 1004)]),
    ("""@app:playback
     define stream L (sym string, price float);
     define stream R (sym string, qty int);
     partition with (sym of L, sym of R)
     begin
       @info(name='j')
       from L#window.length(10) join R#window.length(10)
       select L.sym as s, L.price as p, R.qty as q
       insert into Out;
     end;""", "j",
     [("L", ["A", 10.0], 1000), ("L", ["B", 20.0], 1001),
      ("R", ["A", 7], 1002), ("R", ["C", 9], 1003),
      ("R", ["B", 3], 1004), ("L", ["A", 11.0], 1005)]),
], ids=["count", "group_by", "inner_chain", "length", "lengthBatch",
        "join"])
def test_partition_corpus(ql, qname, sends):
    assert _n_events(_both(ql, qname, sends)) > 0


KEYED = """
@app:playback
define stream S (k long, v float, w int);
partition with (k of S)
begin
  @capacity(keys='64', window='{cap}')
  @info(name='q') from S[w >= 0]#window.{win}
  select k, sum(v) as sv, count() as c, max(w) as mw
  insert all events into Out;
end;
"""


def _interleaved_sends(rng, n_sends, B, n_keys, t0=1000, dt=250,
                       spread=100):
    sends = []
    for i in range(n_sends):
        ts = np.sort(t0 + dt * i + rng.integers(0, spread, B)).astype(
            np.int64)
        cols = (rng.integers(0, n_keys, B).astype(np.int64),
                (rng.integers(0, 64, B) / 64).astype(np.float32),
                rng.integers(-1, 9, B).astype(np.int32))
        sends.append(("S", cols, ts))
    return sends


@pytest.mark.parametrize("win", ["length(4)", "time(600)",
                                 "lengthBatch(3)"])
def test_interleaved_keys_in_one_send(win):
    """Several keys in every batch: rows come out key-major, in the order
    of the keys' slots, each key in its own window order."""
    rng = np.random.default_rng(7)
    sends = _interleaved_sends(rng, 10, 96, 12)
    ev = _both(KEYED.format(cap=128, win=win), "q", sends)
    assert _n_events(ev) > 300


def test_two_keys_flush_in_one_send_reset_epochs():
    """Two keys complete lengthBatch batches in one send.  The selector
    counts RESET rows over the flattened key-major rows, so one key's flush
    starts a new epoch for the rows of keys after it: whatever the JAX
    package emits is the result."""
    ql = KEYED.format(cap=128, win="lengthBatch(2)")
    k = np.array([1, 2, 1, 2, 3, 1, 2, 1], np.int64)
    cols = (k, (np.arange(8) / 8).astype(np.float32),
            np.arange(8, dtype=np.int32))
    sends = [("S", cols, np.full(8, 1000, np.int64)),
             ("S", cols, np.full(8, 1001, np.int64))]
    assert _n_events(_both(ql, "q", sends)) > 8


def test_hot_key_above_window_capacity():
    """One key with 150 events in one send: above the time window's
    per-key capacity (128) and above 64; the oldest rows drop unemitted in
    both packages."""
    ql = KEYED.format(cap=128, win="time(1 sec)")
    rng = np.random.default_rng(11)
    sends = []
    for i in range(4):
        k = np.concatenate([np.full(150, 5), rng.integers(0, 8, 30)])
        rng.shuffle(k)
        cols = (k.astype(np.int64),
                (rng.integers(0, 64, 180) / 64).astype(np.float32),
                rng.integers(0, 9, 180).astype(np.int32))
        sends.append(("S", cols, np.full(180, 1000 + 400 * i, np.int64)))
    assert _n_events(_both(ql, "q", sends)) > 400


def test_time_window_timer_ticks_every_key():
    """A keyed time window under playback: TIMER ticks over all keys
    expire every key's rows, with and without a send at the same time."""
    ql = KEYED.format(cap=128, win="time(500)")
    rng = np.random.default_rng(13)
    sends = _interleaved_sends(rng, 4, 40, 6, dt=300, spread=50)
    sends.append(("S", ([[2, 0.5, 1]]), 3000))
    sends.append(("S", ([[3, 0.25, 1]]), 3500))
    assert _n_events(_both(ql, "q", sends)) > 100


@pytest.mark.parametrize("ql,item", [
    ("""define stream S (k int, v int);
     partition with (k of S)
     begin from S#window.session(1 sec, k, 500) select k, sum(v) as s
     insert into O; end;""", "redundant"),
    ("""define stream S (k int, v int);
     define window SW (k int, v int) length(4);
     partition with (k of S)
     begin from SW select k, sum(v) as s insert into O; end;""",
     "no partition key"),
    ("""define stream S (k int, v int);
     @store(type='memory')
     define aggregation SA from S select k, sum(v) as s group by k
     aggregate every sec ... min;
     partition with (k of S)
     begin from S select k, sum(v) as s insert into O; end;""", "A15"),
    ("""@sink(type='log')
     define stream S (k int, v int); from S select k insert into O;""",
     "A15"),
    ("""@OnError(action='STREAM')
     define stream S (k int, v int); from S select k insert into O;""",
     "A15"),
    ("""@app:admission(rate='100')
     define stream S (k int, v int); from S select k insert into O;""",
     "A15"),
], ids=["session_in_partition", "define_window_in_partitioned_app",
        "define_aggregation_in_partitioned_app", "stream_sink",
        "onerror_stream", "app_admission"])
def test_still_raises(ql, item):
    with pytest.raises(CompileError, match=item):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("name,ql,qname,sends,want", chip_smoke.P3_CASES,
                         ids=[c[0] for c in chip_smoke.P3_CASES])
def test_chip_smoke_p3_expectations(name, ql, qname, sends, want):
    """chip_smoke.py's P3 expectations are the JAX package's events, and
    the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


_SMALL = {"p1": {"P1_KEYS": 128, "P1_B": 128},
          "p4": {"P4_SYMS": 8, "P4_B": 128, "P4_N": 20}}


@pytest.mark.parametrize("which", ["p1", "p4"])
def test_chip_smoke_p1_p4_models(which, monkeypatch):
    """chip_smoke.py's numpy models at a small size: P1 (length(10) per
    device) until the windows are full and every arrival pushes an
    EXPIRED row out, P4 (lengthBatch per symbol) from its spreading sends
    through flushes with EXPIRED rows.  Both packages give the same
    events, and the model accepts every row the port delivers."""
    for k, v in _SMALL[which].items():
        monkeypatch.setattr(chip_smoke, k, v)
    rng = np.random.default_rng(5)
    if which == "p1":
        ql = chip_smoke.P1_QL.replace("1048576", "128")
        raw = [chip_smoke.p1_send(np, rng, i) for i in range(16)]
        model = chip_smoke.P1Model(np, 128, chip_smoke.P1_W)
        stream = "TempStream"
    else:
        ql = chip_smoke.P4_QL.replace("4096", "8").replace(
            "lengthBatch(1000)", "lengthBatch(20)")
        raw = chip_smoke.p4_sends(np, rng, 8)
        model = chip_smoke.P4Model(np, 8, 20)
        stream = "StockStream"
    _both(ql, which, [(stream, tuple(c), ts) for c, ts in raw])
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    got = []
    rt.add_batch_callback(which, lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler(stream)
    expired = []
    for i, (cols, ts) in enumerate(raw):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        steps = [b for b in got if b["n_valid"]]
        assert len(steps) <= 1
        out = model.step(cols, int(ts[0]) if which == "p1" else ts,
                         steps[0] if steps else None, f"{which} send {i}")
        if not steps:                   # P4's first sends fill no batch
            assert which == "p4" and out[0] == 0
        expired.append(out if which == "p1" else out[1])
    rt.shutdown()
    assert expired[0] == 0 and expired[-1] > 0
    if which == "p1":       # full windows: nearly every arrival evicts
        assert expired[-1] > chip_smoke.P1_B // 2
