"""The port's block NFA (`core/pattern_block.py`, the plain version of
kernel K8) agrees with the JAX package's block step.

Both packages plan the same non-partitioned query onto the block NFA; the
port's state starts from the JAX state through `convert.state_from_jax`,
both take the same seeded sends (ts-delta or raw-ts wire, invalid rows,
NaN and -0.0 prices), and after every step the state blobs (the stale
capture-ts rows and the zeroed count / lmask rows included), the `dropped`
counter, the [n_valid, n_dropped] header and every output row in device
order (valid or not) must be equal.  Tolerance: exact, floats bit for bit
(NaN equal to NaN by bits, since the reference's one-hot sums keep a NaN's
bits and turn -0.0 into +0.0, as the port does).

The cases include the kernel's edge cases (`chip_smoke.K8_EDGE_CASES`:
first matches past event 96 of a chunk, seeds that never match, `within`
cuts inside a chunk, runs of more than 32 invalid rows in a sequence).
Then whole apps through both managers: bench.py's sequence configuration
(SEQUENCE_QL) and the pattern sample, events equal in order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.analysis.corpus import SEQUENCE_QL
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import state_from_jax
import siddhi_tpu_torch.core.pattern_planner as tpp
from siddhi_tpu_torch.kernels import block_nfa as bn

HEAD = """
@app:playback
define stream S (k long, price float, volume int);
define stream U (k long, price float, volume int);
"""


def q(body, slots=4, rows=None):
    ann = f"@capacity(slots='{slots}')\n"
    if rows is not None:
        ann += f"@emit(rows='{rows}')\n"
    return HEAD + ann + "@info(name='q')\n" + body


CASES = {
    "pattern_every": (q("""from every e1=S[volume == 1]
        -> e2=S[volume == 2 and price >= e1.price]
        -> e3=S[volume == 3]
        select e1.price as a, e2.price as b, e3.k as c insert into M;""",
                        slots=8), 300),
    "pattern_non_every": (q("""from e1=S[volume == 1]
        -> e2=S[volume == 2 and price > e1.price]
        select e1.price as a, e2.price as b insert into M;"""), 200),
    "sequence_every": (q("""from every e1=S[volume == 1],
        e2=S[volume == 2 and price > e1.price]
        select e1.price as a, e2.price as b insert into M;"""), 256),
    "sequence_non_every": (q("""from e1=S[volume == 2],
        e2=S[price > e1.price * 0.5]
        select e1.price as a, e2.price as b insert into M;"""), 130),
    "single_atom_every": (q("""from every e1=S[volume == 3]
        select e1.price as a, e1.k as kk insert into M;"""), 150),
    "single_atom_non_every": (q("""from e1=S[volume == 3]
        select e1.price as a insert into M;"""), 140),
    "second_stream_pattern": (q("""from every e1=S[volume == 1]
        -> e2=U[volume >= 2 and price > e1.price]
        -> e3=S[volume == 3]
        select e1.price as a, e2.price as b insert into M;""",
                                slots=16), 160),
    "second_stream_sequence": (q("""from every e1=S[volume == 1],
        e2=U[volume >= 2], e3=S[volume == 3 and price < e1.price]
        select e1.price as a, e3.price as c insert into M;"""), 200),
    "within": (q("""from every e1=S[volume == 1]
        -> e2=S[volume == 2 and price > e1.price] within 60 milliseconds
        select e1.price as a, e2.price as b insert into M;""",
                 slots=8), 256),
    "slot_overflow": (q("""from every e1=S[volume == 1]
        -> e2=S[volume == 2 and price > e1.price]
        -> e3=S[volume == 3]
        select e1.price as a, e3.price as c insert into M;""",
                        slots=2, rows=40), 384),
    "e_not_multiple_of_128": (q("""from every e1=S[volume == 1]
        -> e2=S[volume == 2]
        select e1.price as a, e2.price as b insert into M;"""), 300),
}


# K8's edge cases (chip_smoke.K8_EDGE_CASES, as phase 14 runs them on the
# card): first matches past event 96 of a chunk, seeds that never match on
# falling prices, `within` cuts inside a chunk, a sequence over runs of
# more than 32 invalid rows; two chunks a send
EDGE = {"edge_" + name.replace(" ", "_"): name
        for name in chip_smoke.K8_EDGE_CASES}
CASES.update({case: (chip_smoke.K8_EDGE_CASES[name], 256)
              for case, name in EDGE.items()})


def sends_for(rng, E, n, streams=("S",)):
    out = []
    clock = 1000
    for i in range(n):
        B = E
        price = (rng.integers(0, 40, B) / 4.0).astype(np.float32)
        price[rng.random(B) < 0.04] = np.nan
        price[rng.random(B) < 0.04] = -0.0
        cols = [rng.integers(0, 5, B).astype(np.int64), price,
                rng.integers(1, 4, B).astype(np.int32)]
        ts = clock + np.sort(rng.integers(0, 3 * B, B)).astype(np.int64)
        clock = int(ts[-1]) + 7
        sel = np.arange(B, dtype=np.int32)
        sel[rng.random(B) < 0.1] = -1              # invalid rows
        out.append((streams[i % len(streams)], cols, ts,
                    sel[None, :], i % 3 != 2))
    return out


class Pair:
    def __init__(self, ql):
        self.jm, self.tm = JaxManager(), TorchManager(device="cpu")
        self.jq = self.jm.create_siddhi_app_runtime(ql).query_runtimes["q"]
        self.tq = self.tm.create_siddhi_app_runtime(ql).query_runtimes["q"]
        assert self.tq.planned.block
        (b32, b64, scal), sel = self.jq.state
        self.jstate = self.jq.state
        self.tstate = state_from_jax(np.asarray(b32), np.asarray(b64),
                                     [np.asarray(s) for s in scal])

    def step(self, sid, cols, ts, sel, wire):
        jp, tp = self.jq.planned, self.tq.planned
        now = int(ts.max()) + 3
        (jpk, jsel), (tpk, tsel) = self.jstate, self.tstate
        key = np.zeros(1, np.int32)
        if wire:
            base = int(ts[0])
            delta = (ts - base).astype(np.int32)
            jres = jp.steps_w[sid](
                jpk, jsel, tuple(jnp.asarray(c) for c in cols),
                jnp.asarray(base, jnp.int64), jnp.asarray(delta),
                jnp.asarray(sel), jnp.asarray(key),
                jnp.asarray(now, jnp.int64), ())
            tres = tp.steps_w[sid](
                tpk, tsel, tuple(torch.from_numpy(c) for c in cols), base,
                torch.from_numpy(delta), torch.from_numpy(sel),
                torch.from_numpy(key), now)
        else:
            jres = jp.steps[sid](
                jpk, jsel, tuple(jnp.asarray(c) for c in cols),
                jnp.asarray(ts), jnp.asarray(sel), jnp.asarray(key),
                jnp.asarray(now, jnp.int64), ())
            tres = tp.steps[sid](
                tpk, tsel, tuple(torch.from_numpy(c) for c in cols),
                torch.from_numpy(ts), torch.from_numpy(sel),
                torch.from_numpy(key), now)
        self.jstate, self.tstate = (jres[0], jres[1]), (tres[0], tres[1])
        return jres[2], tres[2]

    def close(self):
        self.jm.shutdown()
        self.tm.shutdown()


def bits(x):
    a = np.array(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(pair, jout, tout, what):
    (jb32, jb64, jsc), _ = pair.jstate
    (tb32, tb64, tsc), _ = pair.tstate
    np.testing.assert_array_equal(tb32.numpy(), np.asarray(jb32), what)
    np.testing.assert_array_equal(tb64.numpy(), np.asarray(jb64), what)
    assert [int(s) for s in tsc] == [int(s) for s in jsc], what
    assert (int(tout[0]), int(tout[1])) == (int(jout[0]), int(jout[1])), what
    for j, t in zip(jout[2:5], tout[2:5]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), what)
    assert len(jout[5]) == len(tout[5])
    for j, t in zip(jout[5], tout[5]):
        np.testing.assert_array_equal(bits(t.numpy()), bits(j), what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_step_matches_reference(case):
    ql, E = CASES[case]
    pair = Pair(ql)
    rng = np.random.default_rng(sorted(CASES).index(case))
    streams = ("S", "U", "S") if "second_stream" in case else ("S",)
    sends = sends_for(rng, E, 6, streams)
    if case in EDGE:
        sends = [("S", cols, ts, sel[None, :], i % 3 != 2)
                 for i, (cols, ts, sel) in enumerate(
                     chip_smoke.k8_edge_send(np, rng, EDGE[case], E, i)
                     for i in range(6))]
    if case == "second_stream_sequence":
        # strict continuity across streams: a seed survives its S batch
        # only as its last valid event, its U match only as the U batch's
        # only valid event, and e3 must be the next S batch's first event
        for i, (sid, cols, ts, sel, wire) in enumerate(sends):
            if i % 3 == 0:
                sel[0, -1], cols[2][-1], cols[1][-1] = E - 1, 1, 9.0
            elif i % 3 == 1:
                sel[0, 1:] = -1
                sel[0, 0], cols[2][0] = 0, 2
            else:
                sel[0, 0], cols[2][0], cols[1][0] = 0, 3, 1.0
    rows = dropped = 0
    for i, (sid, cols, ts, sel, wire) in enumerate(sends):
        jout, tout = pair.step(sid, cols, ts, sel, wire)
        assert_same(pair, jout, tout, f"{case} step {i}")
        rows += int(tout[0])
        dropped = int(pair.tstate[0][2][0])
    assert rows > 0
    if case == "slot_overflow":
        assert dropped > 0 and int(tout[1]) >= 0
    pair.close()


def test_block_wrapper_takes_plain_on_cpu():
    pair = Pair(CASES["pattern_every"][0])
    bn.reset_counts()
    rng = np.random.default_rng(9)
    sid, cols, ts, sel, wire = sends_for(rng, 64, 1)[0]
    pair.step(sid, cols, ts, sel, wire)
    assert bn.plain_calls == 1 and bn.launches == 0
    pair.close()


def drive(manager, ql, qname, stream, sends):
    rt = manager.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(qname, lambda ts, cur, exp: got.extend(
        (e.timestamp, tuple(e.data)) for e in (cur or [])))
    rt.start()
    h = rt.get_input_handler(stream)
    for cols, ts in sends:
        h.send_columns(cols, timestamps=ts)
    rt.flush()
    manager.shutdown()
    return got


def test_sequence_config_through_both_managers():
    """bench.py config_sequence_within (SEQUENCE_QL) at B = 256, 8 sends,
    its own traffic; every match is the closed form's."""
    ql = SEQUENCE_QL.format(ann="")
    rng = np.random.default_rng(4)
    sends = [chip_smoke.s1_send(np, rng, i, 256) for i in range(8)]
    t = drive(TorchManager(device="cpu"), ql, "q", "S", sends)
    j = drive(JaxManager(), ql, "q", "S", sends)
    assert t == j
    assert len(t) == sum(chip_smoke.s1_matches(np, c) for c, _ in sends)


def test_chip_smoke_runs_the_corpus_sequence():
    def norm(x):
        return " ".join(x.split())
    assert norm(chip_smoke.S1_QL.format(rows=4096)) == \
        norm(SEQUENCE_QL.format(ann=""))


def test_pattern_sample_through_both_managers():
    with open("samples/apps/pattern_matching.siddhi") as fh:
        ql = fh.read()
    rng = np.random.default_rng(5)
    tm, jm = TorchManager(device="cpu"), JaxManager()
    syms = [f"S{i}" for i in range(6)]
    tids = np.array([tm.interner.intern(s) for s in syms], np.int32)
    jids = np.array([jm.interner.intern(s) for s in syms], np.int32)
    assert np.array_equal(tids, jids)
    sends = []
    for i in range(4):
        B = 200
        sends.append(([tids[rng.integers(0, 6, B)],
                       rng.random(B).astype(np.float32)],
                      1000 + i * B + np.arange(B, dtype=np.int64)))
    t = drive(tm, ql, "riseQuery", "StockStream", sends)
    j = drive(jm, ql, "riseQuery", "StockStream", sends)
    assert t == j and len(t) > 100


def test_force_scan_hook_plans_the_scan_path(monkeypatch):
    ql = CASES["pattern_every"][0]
    monkeypatch.setattr(tpp, "_FORCE_SCAN", True)
    p = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"].planned
    assert not p.block and p.dense_steps is not None


ABSENT_NON_PARTITIONED = HEAD.replace("U (", "S2 (") + """
@info(name='q')
from e1=S[volume == 1] -> not S2 for 1 sec
select e1.price as a insert into M;
"""


def test_absent_plans_the_scan_path_in_both_packages():
    """The repaired `block_eligible`: an absent atom needs the timer
    machinery, which only the scan path has."""
    from siddhi_tpu.core.pattern_block import block_eligible as jax_elig
    from siddhi_tpu_torch.core.pattern_block import block_eligible
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(
        ABSENT_NON_PARTITIONED)
    jrt = JaxManager().create_siddhi_app_runtime(ABSENT_NON_PARTITIONED)
    tp, jp = trt.query_runtimes["q"].planned, jrt.query_runtimes["q"].planned
    assert not block_eligible(tp.spec) and not jax_elig(jp.spec)
    assert not tp.block and tp.timer_step is not None
    assert jp.dense_steps is not None and jp.timer_step is not None
