"""Absent patterns in the port (`not X for t`, `not A and B`, the timer
step and `@app:playback(idle.time)`) agree with the JAX package.

Whole apps through both managers: the shapes of the JAX package's absent
corpus (tests/test_absent_corpus.py), the partitioned absent rule with
chip_smoke's A1 send shape at 4,096 keys, and the idle advance.  Then the
steps alone: the port's data steps (dense and gather, padding rows
included) and its timer step from the same converted state as the JAX
package's, with state words, header, rows and wake compared after every
step, and a timer step repeated at one `now` that must change nothing.
Tolerance: exact (integers, timestamps and the sent float values).
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import state_from_jax
from siddhi_tpu_torch.kernels import pattern_step as ps

BASE = chip_smoke.A2_BASE


def run(manager, body, sends, query="q"):
    rt = manager.create_siddhi_app_runtime(BASE + body)
    got = []
    rt.add_callback(query, lambda ts, i, o: got.extend(
        (ts, tuple(e.data)) for e in (i or [])))
    rt.start()
    for stream, data, ts in sends:
        rt.get_input_handler(stream).send(list(data), timestamp=ts)
    rt.flush()
    manager.shutdown()
    return got


TIMED = """
@info(name='q') from e1=S1[vol == 1] ->
    not S2[price > 20.0] for 1 sec and e3=S3[price > 30.0]
select e1.sym as a, e3.sym as c insert into Out;
"""
CORPUS = list(chip_smoke.A2_CASES) + [(*case, None) for case in [
    ("not A and B", """
@info(name='q') from not S2[price > 20.0] and e3=S3[price > 30.0]
select e3.sym as c insert into Out;
""", [("S2", ["low", 5.0, 1], 900), ("S3", ["ok", 35.0, 1], 1000),
      ("S2", ["bad", 25.0, 1], 1100), ("S3", ["x", 35.0, 1], 1200)]),
    ("B and not A", """
@info(name='q') from e3=S3[price > 30.0] and not S2[price > 20.0]
select e3.sym as c insert into Out;
""", [("S2", ["bad", 25.0, 1], 900), ("S3", ["x", 35.0, 1], 1000)]),
    ("every not A and B", """
@info(name='q') from every (not S2[price > 20.0] and
    e3=S3[price > 30.0])
select e3.sym as c insert into Out;
""", [("S3", ["a", 35.0, 1], 1000), ("S2", ["kill", 25.0, 1], 1100),
      ("S3", ["b", 36.0, 1], 1200)]),
    ("chained not A and B", """
@info(name='q') from e1=S1[price > 10.0] ->
    not S2[price > 20.0] and e3=S3[price > 30.0]
select e1.sym as a, e3.sym as c insert into Out;
""", [("S1", ["a", 15.0, 1], 1000), ("S3", ["c", 35.0, 1], 1200),
      ("S1", ["b", 15.0, 1], 1300), ("S2", ["kill", 25.0, 1], 1400),
      ("S3", ["d", 35.0, 1], 1500)]),
    ("timed: B before the deadline", TIMED,
     [("S1", ["a", 1.0, 1], 1000), ("S3", ["c", 35.0, 1], 1400),
      ("S1", ["tick", 1.0, 9], 2500)]),
    ("timed: B after the deadline", TIMED,
     [("S1", ["a", 1.0, 1], 1000), ("S3", ["c", 35.0, 1], 2600)]),
    ("timed: A inside the wait", TIMED,
     [("S1", ["a", 1.0, 1], 1000), ("S2", ["kill", 25.0, 1], 1300),
      ("S3", ["c", 35.0, 1], 1400), ("S1", ["tick", 1.0, 9], 2500)]),
    ("lmask leak: OR seed, then absent", """
@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->
    not S3 for 1 sec
select e1.sym as a insert into Out;
""", [("S2", ["viaB", 1.0, 1], 1000), ("S3", ["kill", 1.0, 2], 1300),
      ("S1", ["tick", 1.0, 9], 2500)]),
    ("lmask leak: OR seed, then timed pair", """
@info(name='q') from e1=S1[vol == 1] or e2=S2[vol == 1] ->
    not S3[vol == 3] for 1 sec and e3=S3[vol == 4]
select e3.sym as c insert into Out;
""", [("S2", ["viaB", 1.0, 1], 1000), ("S3", ["kill", 1.0, 3], 1200),
      ("S3", ["c", 1.0, 4], 1400), ("S1", ["tick", 1.0, 9], 2600)]),
]]


@pytest.mark.parametrize("name,body,sends,want", CORPUS,
                         ids=[c[0] for c in CORPUS])
def test_absent_corpus_through_both_managers(name, body, sends, want):
    """Events equal in both packages; for chip_smoke.py's A2 shapes (which
    the card is held to) they are also the expected ones."""
    t = run(TorchManager(device="cpu"), body, sends)
    j = run(JaxManager(), body, sends)
    assert t == j
    if want is not None:
        assert [d for _, d in j] == want


def _wait_for(pred, timeout=10.0):
    end = time.time() + timeout
    while time.time() < end:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_idle_advance_fires_absent_pattern():
    """tests/test_playback_idle.py's absent case: after one event the input
    goes silent and the idle thread walks the playback clock past the
    deadline (polled with a deadline, never a fixed sleep)."""
    out = {}
    for name, mgr in (("torch", TorchManager(device="cpu")),
                      ("jax", JaxManager())):
        rt = mgr.create_siddhi_app_runtime(chip_smoke.A2_IDLE_QL)
        got = []
        rt.add_callback("q", lambda ts, i, o, got=got: got.extend(
            tuple(e.data) for e in (i or [])))
        rt.start()
        try:
            rt.get_input_handler("S1").send(["WSO2", 55.6], timestamp=1000)
            assert _wait_for(lambda: len(got) > 0), f"{name} never fired"
        finally:
            mgr.shutdown()
        out[name] = got
    assert out["torch"] == out["jax"] == chip_smoke.A2_IDLE_WANT


def test_idle_thread_stops_at_shutdown():
    mgr = TorchManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(chip_smoke.A2_IDLE_QL)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.extend(i or []))
    rt.start()
    thread = rt._idle_thread
    assert thread is not None and thread.is_alive()
    mgr.shutdown()
    assert not thread.is_alive()
    # the thread is gone: after a send the clock is the send's, and the
    # pending deadline (2000) has not fired
    rt.get_input_handler("S1").send(["WSO2", 55.6], timestamp=1000)
    assert rt._playback_time == 1000 and got == []


A1_SMALL = chip_smoke.A1_QL.replace("1048576", "4096")


def drive_a1(manager, n_sends, block):
    rt = manager.create_siddhi_app_runtime(A1_SMALL)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.extend(
        (ts, e.timestamp, e.data[0]) for e in (i or [])))
    rt.start()
    h1, h2 = rt.get_input_handler("S1"), rt.get_input_handler("S2")
    for i in range(n_sends):
        blk = i % (4096 // block)
        keys = np.arange(blk * block, (blk + 1) * block, dtype=np.int64)
        t1 = 1000 + 250 * i
        h1.send_columns([keys, np.ones(block, np.int32)],
                        timestamps=np.full(block, t1, np.int64))
        h2.send_columns([keys[0::2], np.full(block // 2, 2, np.int32)],
                        timestamps=np.full(block // 2, t1 + 100, np.int64))
    rt.flush()
    manager.shutdown()
    return got


def test_a1_shape_through_both_managers():
    """The partitioned absent rule with A1's send shape at 4,096 keys
    (8 blocks of 512): exactly the odd keys of each block fire, once each,
    at e1.ts + 1000, in both packages, through their timer steps."""
    t = drive_a1(TorchManager(device="cpu"), 14, 512)
    j = drive_a1(JaxManager(), 14, 512)
    assert t == j
    fired = {}
    for now, ts, k in t:
        i = (ts - 2000) // 250
        assert now == ts == 1000 + 250 * i + 1000
        blk = i % 8
        assert k % 2 == 1 and blk * 512 <= k < (blk + 1) * 512
        fired.setdefault(i, []).append(k)
    assert sorted(fired) == list(range(10))
    for i, ks in fired.items():
        assert sorted(ks) == list(range((i % 8) * 512 + 1,
                                        (i % 8 + 1) * 512, 2))


ABSENT_STEP_QL = """
@app:playback
define stream S1 (key long, v int, p float);
define stream S2 (key long, v int, p float);
partition with (key of S1, key of S2)
begin
  @capacity(keys='256', slots='3')
  @info(name='q')
  from every e1=S1[v == 1] -> e2=S1[v == 2 and p > e1.p]
       -> not S2[v <= 2] for 100 milliseconds
  select e1.key as k, e1.p as p1, e2.p as p2
  insert into Out;
end;
"""


class Pair:
    def __init__(self, ql):
        self.jm, self.tm = JaxManager(), TorchManager(device="cpu")
        self.jq = self.jm.create_siddhi_app_runtime(ql).query_runtimes["q"]
        self.tq = self.tm.create_siddhi_app_runtime(ql).query_runtimes["q"]
        (b32, b64, scal), sel = self.jq.state
        self.jstate = self.jq.state
        self.tstate = state_from_jax(np.asarray(b32), np.asarray(b64),
                                     [np.asarray(s) for s in scal])
        self.K = self.tq.planned.key_capacity

    def data(self, rng, sid, dense, clock):
        Kb, E = 32, 3
        B = Kb * E
        cols = [rng.integers(0, 64, B).astype(np.int64),
                rng.integers(1, 4, B).astype(np.int32),
                rng.random(B).astype(np.float32)]
        ts = clock + np.sort(rng.integers(0, 150, B)).astype(np.int64)
        sel = rng.permutation(B).astype(np.int32).reshape(Kb, E)
        sel[rng.random((Kb, E)) < 0.15] = -1
        if dense:
            key = int(rng.integers(0, self.K - Kb + 1))
        else:
            key = rng.choice(self.K, Kb, replace=False).astype(np.int32)
            pad = rng.random(Kb) < 0.1
            key[pad] = self.K           # padding rows (clamped copies)
            sel[pad] = -1
        now = int(ts.max()) + int(rng.integers(0, 50))
        base = int(ts[0])
        delta = (ts - base).astype(np.int32)
        jp, tp = self.jq.planned, self.tq.planned
        js = (jp.dense_steps_w if dense else jp.steps_w)[sid]
        tsx = (tp.dense_steps_w if dense else tp.steps_w)[sid]
        (jpk, jsl), (tpk, tsl) = self.jstate, self.tstate
        jres = js(jpk, jsl, tuple(jnp.asarray(c) for c in cols),
                  jnp.asarray(base, jnp.int64), jnp.asarray(delta),
                  jnp.asarray(sel), jnp.asarray(key, jnp.int32),
                  jnp.asarray(now, jnp.int64), ())
        tres = tsx(tpk, tsl, tuple(torch.from_numpy(c) for c in cols), base,
                   torch.from_numpy(delta), torch.from_numpy(sel),
                   key if dense else torch.from_numpy(key), now)
        return self.advance(jres, tres)

    def timer(self, now):
        (jpk, jsl), (tpk, tsl) = self.jstate, self.tstate
        jres = self.jq.planned.timer_step(jpk, jsl,
                                          jnp.asarray(now, jnp.int64), ())
        tres = self.tq.planned.timer_step(tpk, tsl, now)
        return self.advance(jres, tres)

    def advance(self, jres, tres):
        self.jstate, self.tstate = (jres[0], jres[1]), (tres[0], tres[1])
        (jb32, jb64, jsc), _ = self.jstate
        (tb32, tb64, tsc), _ = self.tstate
        np.testing.assert_array_equal(tb32.numpy(), np.asarray(jb32))
        np.testing.assert_array_equal(tb64.numpy(), np.asarray(jb64))
        assert [int(s) for s in tsc] == [int(s) for s in jsc]
        jout, tout = jres[2], tres[2]
        assert (int(tout[0]), int(tout[1])) == (int(jout[0]), int(jout[1]))
        for j, t in zip(jout[2:5], tout[2:5]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for j, t in zip(jout[5], tout[5]):
            torch.testing.assert_close(t, torch.from_numpy(np.array(j)),
                                       rtol=0, atol=0, equal_nan=True)
        assert int(tres[3]) == int(jres[3])          # the wake
        return tout, int(tres[3])

    def close(self):
        self.jm.shutdown()
        self.tm.shutdown()


def test_data_and_timer_steps_match_reference():
    """Dense and gather data steps (padding rows included: both packages
    tick a clamped copy of the last key for them) and timer steps from a
    converted state; state, rows, header and wake equal after each."""
    pair = Pair(ABSENT_STEP_QL)
    rng = np.random.default_rng(21)
    clock = 1000
    fired = 0
    ps.reset_counts()
    for it in range(12):
        if it % 3 == 2:
            out, wake = pair.timer(clock + 60)
            fired += int(out[0])
        else:
            out, wake = pair.data(rng, ("S1", "S2")[it % 2], it % 4 < 2,
                                  clock)
        clock += 80
    assert fired > 0
    assert ps.launches == 0 and ps.timer_launches == 0
    pair.close()


def test_repeated_timer_step_changes_nothing():
    """The JAX scheduler may run the timer step several times at one wake
    time (one heap entry per step); the port keeps one entry per (time,
    query).  A second timer step at the same `now` emits nothing and
    leaves the state and the wake as they were, in both packages."""
    pair = Pair(ABSENT_STEP_QL)
    rng = np.random.default_rng(22)
    for it, sid in enumerate(("S1", "S1", "S1", "S1")):
        pair.data(rng, sid, True, 1000 + 40 * it)
    out, wake = pair.timer(1400)
    assert wake < chip_smoke.NO_WAKE or int(out[0]) > 0
    (b32, b64, sc), _ = pair.tstate
    before = (b32.clone(), b64.clone(), [int(s) for s in sc])
    out2, wake2 = pair.timer(1400)
    (b32, b64, sc), _ = pair.tstate
    assert int(out2[0]) == 0 and wake2 == wake
    assert torch.equal(b32, before[0]) and torch.equal(b64, before[1])
    assert [int(s) for s in sc] == before[2]
    pair.close()


def test_scheduler_keeps_one_entry_per_time_and_query():
    from siddhi_tpu_torch.core.runtime import _Scheduler

    class App:
        playback = True

        def timestamp_millis(self):
            return 0

    class Q:
        name = "q"

        def __init__(self):
            import threading
            self._qlock = threading.RLock()
            self.fired = []

        def on_timer(self, now):
            self.fired.append(now)
    sch, q = _Scheduler(App()), Q()
    for w in (2000, 2000, 2250, 2000):
        sch.notify_at(w, q)
    sch.drain_playback(2100)
    assert q.fired == [2000]
    sch.drain_playback(3000)
    assert q.fired == [2000, 2250]
