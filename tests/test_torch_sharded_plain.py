"""Sharding over the key axis (A14) through the port, held to the JAX
package: the windowless partition group-by and its purge remap, a
pattern's purge, the windowed join and the incremental aggregation (the
shapes of `tests/test_sharded_ext.py`), each on the JAX package's
`Mesh(devs[:n])` and the port's `ShardMesh([cpu] * n)`, n in {8, 4},
compared exactly and in order; the shardability decisions of both
packages; a meshed JAX state carried into the port mid-stream.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.sharding import ShardMesh

from test_torch_sharded import both, flat, jax_mesh
from test_torch_sharded_ext import PURGE, keyed_app, purge_feeds, \
    random_feeds


PLAIN_APP = """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @info(name='q') from S[volume > 1]
  select key, sum(price) as sp, count() as c, max(price) as mx
  having c < 5
  insert into Out;
end;
"""

PATTERN_PURGE_APP = f"""
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='16', slots='4')
  {PURGE}
  @info(name='q')
  from every a1=S[volume >= 1]
  select a1.key as k, sum(a1.price) as sp
  insert into Out;
end;
"""

JOIN_APP = """
@app:playback
define stream L (sym long, price float);
define stream R (sym long, qty int);
@info(name='q')
from L#window.length(32) left outer join R#window.length(32)
  on L.sym == R.sym
select L.sym as s, R.qty as q
insert into Out;
"""



def join_feeds():
    rng = np.random.default_rng(5)
    feeds = []
    for i in range(4):
        feeds.append(("L", [[int(rng.integers(0, 6)), 1.0]
                            for _ in range(8)], 1000 + i))
        feeds.append(("R", [[int(rng.integers(0, 6)),
                             int(rng.integers(1, 9))] for _ in range(8)],
                      1000 + i))
    return feeds




CASES = {
    "plain_groupby": (PLAIN_APP, random_feeds(6, keys=40)),
    "plain_groupby_purge": (PLAIN_APP.replace("@info", PURGE + "\n  @info"),
                            purge_feeds()),
    "pattern_purge": (PATTERN_PURGE_APP, purge_feeds()),
    "windowed_join": (JOIN_APP, join_feeds()),
}


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_run_matches_jax(case, n):
    ql, feeds = CASES[case]
    j, t, u = both(ql, "q", feeds, n)
    assert t == j
    assert flat(t) == flat(u)
    assert flat(t)


AGG_APP = """
@app:playback
define stream S (sym string, price double, volume long);
@capacity(buckets='1024')
define aggregation A
  from S select sym, sum(price) as sp, count() as c
  group by sym aggregate every sec ... min;
"""


@pytest.mark.parametrize("n", [8, 4])
def test_incremental_aggregation_on_a_mesh(n):
    """Aggregations take the mesh and run their unsharded step on its
    first device: the buckets equal the JAX package's on its mesh."""
    def run(mgr, mesh):
        rt = mgr.create_siddhi_app_runtime(AGG_APP, mesh=mesh)
        rt.start()
        h = rt.get_input_handler("S")
        h.send([["a", 10.0, 1]], timestamp=1_000)
        h.send([["b", 5.0, 1]], timestamp=1_200)
        h.send([["a", 2.0, 1]], timestamp=61_000)
        h.send([["a", 3.0, 1]], timestamp=1_500)
        rows = rt.query("from A within 0L, 10000000L per 'seconds' "
                        "select sym, sp, c")
        mgr.shutdown()
        return sorted(tuple(e.data) for e in rows)
    j = run(siddhi_tpu.SiddhiManager(), jax_mesh(n))
    t = run(siddhi_tpu_torch.SiddhiManager(device="cpu"),
            ShardMesh(["cpu"] * n))
    assert t == j == [("a", 2.0, 1), ("a", 13.0, 2), ("b", 5.0, 1)]


# ---------------------------------------------------------------------------
# the shardability decisions
# ---------------------------------------------------------------------------

def _partitioned(body, keys=64):
    return f"""
define stream S (key long, price float, volume int);
define stream T (key long, at long);
partition with (key of S)
begin
  @capacity(keys='{keys}')
  @info(name='q') {body}
end;
"""


DECISIONS = {
    "plain": _partitioned("from S select key, sum(price) as sp "
                          "insert into O;"),
    "plain_no_groupby": _partitioned("from S select price insert into O;"),
    "order_by": _partitioned("from S select key, sum(price) as sp "
                             "order by sp insert into O;"),
    "limit": _partitioned("from S select key, sum(price) as sp limit 3 "
                          "insert into O;"),
    "distinct_count": _partitioned("from S select key, distinctCount("
                                   "volume) as d insert into O;"),
    "keyed_length": _partitioned("from S#window.length(4) select key, "
                                 "sum(price) as sp insert into O;"),
    "keyed_length_batch": _partitioned("from S#window.lengthBatch(4) "
                                       "select key, sum(price) as sp "
                                       "insert into O;"),
    "keyed_time_batch": _partitioned("from S#window.timeBatch(1 sec) "
                                     "select key, sum(price) as sp "
                                     "insert into O;"),
    "keyed_cron": _partitioned("from S#window.cron('*/5 * * * * ?') "
                               "select key, sum(price) as sp "
                               "insert into O;"),
    "keyed_offset": _partitioned("from S#window.length(4) select key, "
                                 "price offset 1 insert into O;"),
    "keyed_capacity_not_divisible": _partitioned(
        "from S#window.length(4) select key, sum(price) as sp "
        "insert into O;", keys=30),
    "pattern": _partitioned("from every e1=S[volume == 1] -> "
                            "e2=S[volume == 2] select e1.key as k "
                            "insert into O;"),
}


def _decisions(rt):
    q = rt.query_runtimes["q"].planned
    return (getattr(q, "mesh", None) is not None,
            getattr(q, "keyed_mesh", None) is not None,
            getattr(q, "key_capacity", None))


@pytest.mark.parametrize("n", [8, 4])
def test_shard_decisions_match_jax(n):
    for name, ql in DECISIONS.items():
        j = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
            ql, mesh=jax_mesh(n))
        t = siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime(ql, mesh=ShardMesh(["cpu"] * n))
        assert _decisions(t) == _decisions(j), name


def test_capacity_that_the_shards_do_not_divide():
    """A keyed slab whose capacity n does not divide stays unsharded in
    both packages (the partition rounds keys, so a top-level session key
    capacity stands in: it rounds too)."""
    ql = _partitioned("from S#window.length(4) select key, sum(price) "
                      "as sp insert into O;", keys=30)
    t = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(ql, mesh=ShardMesh(["cpu"] * 4))
    assert t.query_runtimes["q"].planned.key_capacity == 32
    assert t.query_runtimes["q"].planned.keyed_mesh is not None
    t3 = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(ql, mesh=ShardMesh(["cpu"] * 3))
    assert t3.query_runtimes["q"].planned.key_capacity == 30


# ---------------------------------------------------------------------------
# a meshed JAX state carried into the port
# ---------------------------------------------------------------------------

CARRY = {
    "pattern": """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='64', slots='4')
  @info(name='q')
  from every e1=S[volume == 1] -> e2=S[volume == 2] -> e3=S[volume == 3]
  select e1.key as k, e1.price as p1, e3.price as p3
  insert into Out;
end;
""",
    "keyed_length": keyed_app("length(3)"),
    "plain_groupby": PLAIN_APP,
}


@pytest.mark.parametrize("case", sorted(CARRY))
def test_state_carried_from_a_meshed_jax_runtime(case):
    """Run the JAX package on its 4-device mesh for half the sends, carry
    its state into the port's per-shard layout (`convert.
    sharded_state_from_jax`), then send the rest to both: the events must
    agree; and the port's state carried back equals the JAX package's."""
    from siddhi_tpu_torch import convert
    ql = CARRY[case]
    feeds = random_feeds(11, sends=8, keys=20)
    jm = siddhi_tpu.SiddhiManager()
    jrt = jm.create_siddhi_app_runtime(ql, mesh=jax_mesh(4))
    tm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    trt = tm.create_siddhi_app_runtime(ql, mesh=ShardMesh(["cpu"] * 4))
    got = {"j": [], "t": []}
    for key, rt in (("j", jrt), ("t", trt)):
        rt.add_callback("q", lambda ts, i, o, _k=key: got[_k].append((
            ts, [tuple(e.data) for e in (i or [])],
            [tuple(e.data) for e in (o or [])])))
        rt.start()
    for sid, rows, ts in feeds[:4]:
        jrt.get_input_handler(sid).send(rows, timestamp=ts)
    convert.carry_sharded_runtime(jrt, trt)
    got["j"].clear()
    for sid, rows, ts in feeds[4:]:
        jrt.get_input_handler(sid).send(rows, timestamp=ts)
        trt.get_input_handler(sid).send(rows, timestamp=ts)
    assert got["t"] == got["j"] and got["j"]
    jqr, tqr = jrt.query_runtimes["q"], trt.query_runtimes["q"]
    if getattr(tqr.planned, "keyed_mesh", None) is None:
        back = convert.sharded_state_to_numpy(tqr)
        ref = convert.jax_sharded_state_to_numpy(jqr)
        assert len(back) == len(ref)
        for a, b in zip(back, ref):
            np.testing.assert_array_equal(a, b)
    jm.shutdown()
    tm.shutdown()
