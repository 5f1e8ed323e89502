"""Merge groups in the port (`siddhi_tpu_torch/optimizer/mqo.py`) against
the JAX package (`siddhi_tpu/optimizer/mqo.py`), on the CPU.

The port's `merge_plan` equals the JAX package's (groups, units and reason
strings) on `samples/apps/mqo_dashboard.siddhi` and every app here.  Each
app runs through both packages from the same seeded sends, merged (the
default in both), and the events each query delivered are compared after
every send; the port's merged run is also held to its unmerged run
(`optimizer.merge.enabled=false`), exactly.  Tolerance between the
packages: exact, except float values, which may differ by summation order
(relative 1e-5 or absolute 1e-4, `test_torch_fuse.same`).

Shapes from `tests/test_mqo.py`: the groups and modes, the config switch,
the residual reasons and the decoration split, parity of the base shapes,
of a fused group with a partial-stack drain, of rate limits, table writes
with an `in` probe (the prober demoted), the feedback loop demoted, fault
isolation inside a group, and an on-demand read under a fused group.
Left out: `test_mesh_disables_merging` (meshes, ROADMAP A14),
`test_parity_stream_function_chain` (stream functions, A4),
`test_snapshot_*` and the accounting, EXPLAIN and lint tests (A13, A15);
the fault test runs with the default `@OnError` action, LOG (the STREAM
action is A15).

Also: a merge group's state carried from the JAX group
(`convert.merged_state_from_jax`) steps the same.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core import plan_facts as jax_facts
from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu_torch.core import plan_facts as port_facts
from siddhi_tpu_torch.compiler import SiddhiCompiler as PortCompiler

from test_torch_fuse import same


def build(pkg, ql, merge=True, props=None):
    if pkg == "jax":
        from siddhi_tpu.utils.config import InMemoryConfigManager
        m = siddhi_tpu.SiddhiManager()
    else:
        from siddhi_tpu_torch.utils.config import InMemoryConfigManager
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    cfg = dict(props or {})
    if not merge:
        cfg["optimizer.merge.enabled"] = "false"
    if cfg:
        m.set_config_manager(InMemoryConfigManager(cfg))
    return m, m.create_siddhi_app_runtime(ql)


def capture(rt, queries):
    outs = {q: [] for q in queries}
    for q in queries:
        rt.add_callback(q, lambda ts, cur, exp, _q=q: outs[_q].append(
            ([tuple(e.data) for e in (cur or [])],
             [tuple(e.data) for e in (exp or [])])))
    return outs


def sends(n_batches=10, b=48, t0=1000, seed=3, keys=6):
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        yield [[int(rng.integers(0, keys)),
                float(rng.integers(-20, 80)) / 10.0,
                int(rng.integers(0, 4))] for _ in range(b)], t0 + i * 100


def run(pkg, ql, queries, merge=True, **kw):
    m, rt = build(pkg, ql, merge)
    outs = capture(rt, queries)
    rt.start()
    per = []
    h = rt.get_input_handler("S")
    for rows, ts in sends(**kw):
        h.send(rows, timestamp=ts)
        per.append({q: list(v) for q, v in outs.items()})
    rt.flush()
    final = {q: list(v) for q, v in outs.items()}
    m.shutdown()
    return per, final, rt


def parity(ql, queries, **kw):
    """JAX merged == port merged after every send; port merged == port
    unmerged."""
    jp, jf, _ = run("jax", ql, queries, **kw)
    tp, tf, rt = run("port", ql, queries, **kw)
    assert len(jp) == len(tp)
    for s, (a, b) in enumerate(zip(jp, tp)):
        for q in queries:
            assert same(a[q], b[q]), (s, q)
    for q in queries:
        assert same(jf[q], tf[q]), q
    _, uf, _ = run("port", ql, queries, merge=False, **kw)
    assert uf == tf
    assert any(tf.values())
    return rt, tf


BASE_QL = """
define stream S (key long, v double, c int);
@info(name='f1') from S[v > 3.0] select key, v insert into F1;
@info(name='f2') from S[c == 2 and v < 6.0] select key, c insert into F2;
@info(name='g1') from S select key, count() as n group by key
insert into G1;
@info(name='w1') from S[v > 0.0]#window.length(16)
select key, sum(v) as s group by key insert into W1;
@info(name='w2') from S[v > 0.0]#window.length(16)
select key, max(v) as m group by key having m > 2.0 insert into W2;
@info(name='lb') from S#window.lengthBatch(8)
select count() as n, avg(v) as a insert into LB;
"""
BASE_QUERIES = ["f1", "f2", "g1", "w1", "w2", "lb"]

RESIDUAL_QL = """
define stream S (key long, v double, c int);
@info(name='plain1') from S[v > 1.0] select key insert into O1;
@info(name='plain2') from S[v > 2.0] select key insert into O2;
@fuse(batches='4')
@info(name='fq') from S[v > 3.0] select key insert into O3;
@info(name='tw') from S#window.time(1 sec) select count() as n
insert into O4;
@info(name='sess') from S#window.session(1 sec, key)
select count() as n insert into O5;
"""

SMALL_QL = """
define stream S (key long, v double, c int);
@info(name='p1') from S[v > 2.0] select key, v insert into P1;
@info(name='p2') from S[v > 0.0]#window.length(8)
select key, sum(v) as s group by key insert into P2;
@info(name='p3') from S[v > 0.0]#window.length(8)
select key, count() as n group by key insert into P3;
"""

TABLE_QL = """
define stream S (key long, v double, c int);
define table T (key long, v double);
@info(name='ins') from S[c == 1] select key, v insert into T;
@info(name='probe') from S[key in T] select key, v insert into P;
@info(name='other') from S[v > 5.0] select key insert into O;
"""

LOOP_QL = """
define stream S (key long, v double, c int);
@info(name='loop') from S[c == 9] select key, v, c insert into S;
@info(name='q1') from S[v > 1.0] select key insert into O1;
@info(name='q2') from S[v > 2.0] select key insert into O2;
"""

RATE_QL = """
define stream S (key long, v double, c int);
@info(name='r1') from S[v > 0.0] select key, v
output every 3 events insert into R1;
@info(name='r2') from S select key, count() as n group by key
output last every 4 events insert into R2;
"""


@pytest.mark.parametrize("ql", [
    open("samples/apps/mqo_dashboard.siddhi").read(), BASE_QL, RESIDUAL_QL,
    SMALL_QL, "@app:fuse(batches='3')\n" + SMALL_QL, TABLE_QL, LOOP_QL,
    RATE_QL, "@app:serve\n" + BASE_QL,
    BASE_QL.replace("define stream S",
                    "@async(buffer.size='32')\ndefine stream S")])
def test_merge_plan_equals_jax(ql):
    assert port_facts.merge_plan(PortCompiler.parse(ql)) == \
        jax_facts.merge_plan(JaxCompiler.parse(ql))


def test_merge_groups_and_modes():
    m, rt = build("port", BASE_QL)
    try:
        assert list(rt.merged_groups) == ["S#0"]
        mg = rt.merged_groups["S#0"]
        assert [q.name for q in mg.members] == BASE_QUERIES
        modes = {q.name: mg.mode_of(q) for q in mg.members}
        assert modes == {"f1": "stacked", "f2": "stacked",
                         "g1": "stacked", "w1": "shared",
                         "w2": "shared", "lb": "stacked"}
        w1 = rt.query_runtimes["w1"].planned
        w2 = rt.query_runtimes["w2"].planned
        assert w1.slot_allocator is w2.slot_allocator
        assert [q._qr for q in rt.junctions["S"].queries] == [mg]
        # a shared unit holds its window once: both views carry it
        assert rt.query_runtimes["w1"].state[0] is \
            rt.query_runtimes["w2"].state[0]
    finally:
        m.shutdown()


def test_config_disable_records_reason():
    m, rt = build("port", BASE_QL, merge=False)
    try:
        assert not rt.merged_groups
        assert all("disabled" in why for why in rt._merge_reasons.values())
        assert len(rt.junctions["S"].queries) == len(BASE_QUERIES)
    finally:
        m.shutdown()


def test_residual_reasons_match_jax():
    _, rj = build("jax", RESIDUAL_QL)
    m, rp = build("port", RESIDUAL_QL)
    try:
        assert [q.name for q in rp.merged_groups["S#0"].members] == \
            ["plain1", "plain2"]
        assert rp._merge_reasons == rj._merge_reasons
    finally:
        m.shutdown()


def test_parity_base_shapes():
    parity(BASE_QL, BASE_QUERIES, n_batches=6)


def test_parity_small_fused():
    # 7 batches at K=3: two fused merged dispatches and a partial-stack
    # drain at flush
    rt, _ = parity("@app:fuse(batches='3')\n" + SMALL_QL,
                   ["p1", "p2", "p3"], n_batches=7, b=32)
    mg = rt.merged_groups["S#0"]
    assert mg._fuse is not None and mg._fuse.k == 3
    assert {mg.mode_of(q) for q in mg.members} == {"stacked", "shared"}


def test_parity_rate_limit():
    parity(RATE_QL, ["r1", "r2"])


def test_parity_table_output_and_in_probe():
    rt, _ = parity(TABLE_QL, ["probe", "other"], n_batches=8, b=16)
    mg = rt.merged_groups.get("S#0")
    assert mg is not None and [q.name for q in mg.members] == \
        ["ins", "other"]
    why = rt._merge_reasons["probe"]
    assert "read-your-writes" in why and "'ins'" in why, why


def test_feedback_loop_demoted():
    m, rt = build("port", LOOP_QL)
    try:
        mg = rt.merged_groups["S#0"]
        assert [q.name for q in mg.members] == ["q1", "q2"]
        assert "feedback" in rt._merge_reasons["loop"]
    finally:
        m.shutdown()


def test_fault_isolation():
    """A member whose delivery raises is logged and dropped for that
    batch; its co-member still delivers, merged as unmerged."""
    ql = """
define stream S (key long, v double, c int);
@info(name='bad') from S[v > 0.0] select key, v insert into B;
@info(name='good') from S[v > 2.0] select key, v insert into G;
"""
    counts = []
    for merge in (True, False):
        m, rt = build("port", ql, merge)
        try:
            good = []
            rt.add_callback("bad", lambda ts, cur, exp:
                            (_ for _ in ()).throw(RuntimeError("boom")))
            rt.add_callback("good", lambda ts, cur, exp: good.append(
                len(cur or [])))
            rt.start()
            h = rt.get_input_handler("S")
            for rows, ts in sends(n_batches=4, b=8):
                h.send(rows, timestamp=ts)
            assert bool(rt.merged_groups) == merge
            counts.append(sum(good))
        finally:
            m.shutdown()
    assert counts[0] > 0 and counts[0] == counts[1]


def test_ondemand_read_drains_fused_group():
    ql = "@app:fuse(batches='4')\n" + """
define stream S (key long, v double, c int);
define table T (key long, v double);
@info(name='ins') from S[v > 0.0] select key, v insert into T;
@info(name='w1') from S[v > 0.0]#window.length(16)
select key, sum(v) as s group by key insert into W1;
@info(name='w2') from S[v > 0.0]#window.length(16)
select key, max(v) as m group by key insert into W2;
"""
    m, rt = build("port", ql)
    try:
        assert rt.merged_groups
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(3):      # partial fuse stack outstanding
            h.send([[i, 1.5, 1]], timestamp=1000 + i)
        assert len(rt.query("from T select *")) == 3
    finally:
        m.shutdown()


def test_merged_state_from_jax_steps_the_same():
    """The JAX group's member_state views converted into the port group
    (a shared window held once) step the same as the JAX group."""
    from siddhi_tpu_torch import convert
    queries = ["p1", "p2", "p3"]
    feed = list(sends(n_batches=6, b=24, seed=9))
    mj, rj = build("jax", SMALL_QL)
    mp, rp = build("port", SMALL_QL)
    try:
        oj, op = capture(rj, queries), capture(rp, queries)
        rj.start()
        rp.start()
        hj = rj.get_input_handler("S")
        for rows, ts in feed[:3]:
            hj.send(rows, timestamp=ts)
        rj.flush()
        convert.merged_state_from_jax(rj.merged_groups["S#0"],
                                      rp.merged_groups["S#0"])
        for q in queries:
            oj[q].clear()
        hp = rp.get_input_handler("S")
        for rows, ts in feed[3:]:
            hj.send(rows, timestamp=ts)
            hp.send(rows, timestamp=ts)
        rj.flush()
        rp.flush()
        for q in queries:
            assert same(oj[q], op[q]), q
        assert any(op.values())
    finally:
        mj.shutdown()
        mp.shutdown()


def test_dashboard_merged_equals_unmerged():
    """MD1's app (samples/apps/mqo_dashboard.siddhi) at a small size: the
    merged run's events equal the unmerged run's and the JAX package's."""
    ql = "@app:playback\n" + open("samples/apps/mqo_dashboard.siddhi").read()
    queries = ["largeTxnAlert", "regionAudit", "spendTotal", "spendPeak",
               "spendCount", "slowBurn"]

    def go(pkg, merge):
        m, rt = build(pkg, ql, merge)
        outs = capture(rt, queries)
        rt.start()
        rng = np.random.default_rng(4)
        h = rt.get_input_handler("Txn")
        for i in range(5):
            h.send([[int(rng.integers(0, 8)),
                     float(np.round(rng.lognormal(8, 1.5), 2)),
                     int(rng.integers(0, 16))] for _ in range(24)],
                   timestamp=1000 + i)
        rt.flush()
        m.shutdown()
        return outs, rt
    tj, _ = go("jax", True)
    tm, rt = go("port", True)
    tu, _ = go("port", False)
    assert list(rt.merged_groups) == ["Txn#0"]
    assert tm == tu
    for q in queries:
        assert same(tj[q], tm[q]), q
