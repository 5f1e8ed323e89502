"""Sharding over the key axis (A14) through the port, held to the JAX
package: every shape of `tests/test_sharded.py` (the partitioned pattern,
per-key aggregation, @fuse over the mesh with a partial stack, timer
expiry, the windowed join, the block-NFA sequence) runs through the JAX
package on `Mesh(devs[:8])` and `Mesh(devs[:4])` and through the port on
`ShardMesh([cpu] * 8)` and `ShardMesh([cpu] * 4)`; every callback's
events must be equal, exactly and in order.  The port's sharded run must
also hold the events of its unsharded run, sorted.  The snapshot and
restore cases wait for persistence (ROADMAP A13).
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.sharding import ShardMesh


def jax_mesh(n):
    devs = np.array(jax.devices())
    if devs.size < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(devs[:n], ("shard",))


def drive(mgr, ql, qname, feeds, mesh=None, check=None):
    """Deploy `ql` (on `mesh` where given), send `feeds` [(stream, rows,
    ts)], and return every callback of `qname` as (ts, current, expired)
    tuples of event data."""
    rt = mgr.create_siddhi_app_runtime(ql, mesh=mesh) if mesh is not None \
        else mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(qname, lambda ts, i, o: got.append((
        ts, [tuple(e.data) for e in (i or [])],
        [tuple(e.data) for e in (o or [])])))
    rt.start()
    for sid, rows, ts in feeds:
        rt.get_input_handler(sid).send(rows, timestamp=ts)
    rt.flush()
    if check is not None:
        check(rt)
    mgr.shutdown()
    return got


def flat(got):
    """Every event of `got`, sorted (a None cell sorts first)."""
    return sorted(((kind, tuple((v is not None, v) for v in row))
                   for _, cur, exp in got
                   for kind, rows in (("c", cur), ("e", exp))
                   for row in rows), key=repr)


def both(ql, qname, feeds, n, check=None):
    """(JAX package on an n-device mesh, the port on n logical shards, the
    port unsharded)."""
    j = drive(siddhi_tpu.SiddhiManager(), ql, qname, feeds, jax_mesh(n))
    t = drive(siddhi_tpu_torch.SiddhiManager(device="cpu"), ql, qname,
              feeds, ShardMesh(["cpu"] * n), check)
    u = drive(siddhi_tpu_torch.SiddhiManager(device="cpu"), ql, qname,
              feeds)
    return j, t, u


APP = """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='64', slots='4')
  @info(name='query1')
  from every e1=S[volume == 1] -> e2=S[volume == 2] -> e3=S[volume == 3]
  select e1.key as k, e1.price as p1, e3.price as p3
  insert into Out;
end;
"""

AGG_APP = """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='64', slots='4')
  @info(name='query1')
  from every a1=S[volume >= 1]
  select a1.key as k, sum(a1.price) as sp, count() as c
  insert into AOut;
end;
"""

EXPIRY_APP = """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='32', slots='4')
  @info(name='query1')
  from every e1=S[volume == 1] -> e2=S[volume == 2] within 1 sec
  select e1.key as k, e2.price as p
  insert into Out;
end;
"""

ABSENT_APP = """
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='32', slots='4')
  @info(name='query1')
  from every e1=S[volume == 1] -> not S[volume == 2] for 1 sec
  select e1.key as k, e1.price as p
  insert into Out;
end;
"""

FUSED_APP = APP.replace("@info(name='query1')",
                        "@fuse(batches='3')\n  @info(name='query1')")

JOIN_APP = """
@app:playback
define stream JL (sym long, price float);
define stream JR (sym long, qty int);
@emit(rows='4096')
@info(name='query1')
from JL#window.length(16) join JR#window.length(16)
  on JL.sym == JR.sym
select JL.sym as s, JL.price as p, JR.qty as q
insert into JOut;
"""

SEQ_APP = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(keys='1', slots='8')
@emit(rows='4096')
@info(name='query1')
from every e1=S[volume == 1], e2=S[volume == 2 and price > e1.price]
  within 1 sec
select e1.price as p1, e2.price as p2
insert into M;
"""


def random_feeds(seed, sends=6, rows=40, keys=24, stream="S"):
    rng = np.random.default_rng(seed)
    return [(stream, [[int(rng.integers(0, keys)),
                       float(rng.integers(-4, 9)) * 0.5,
                       int(rng.integers(1, 4))] for _ in range(rows)],
             1000 * (s + 1)) for s in range(sends)]


def staged_feeds(nkeys=24):
    return [("S", [[k, float(k + stage), stage] for k in range(nkeys)],
             1000 * stage) for stage in (1, 2, 3)]


def expiry_feeds():
    return [("S", [[k, 1.0, 1] for k in range(8)], 1_000),
            ("S", [[k, 1.0, 2] for k in range(4)], 1_500),
            ("S", [[k, 1.0, 2] for k in range(4, 8)], 3_000)]


def absent_feeds():
    return [("S", [[k, float(k), 1] for k in range(12)], 1_000),
            ("S", [[k, 2.0, 2] for k in range(0, 12, 3)], 1_400),
            ("S", [[k, 3.0, 1] for k in range(5)], 2_500),
            ("S", [[40, 0.0, 3]], 5_000)]


def join_feeds():
    rng = np.random.default_rng(7)
    feeds = []
    for i in range(12):
        ts = 1000 + i * 10
        feeds.append(("JL", [[int(rng.integers(0, 8)),
                              float(rng.integers(1, 9))]
                             for _ in range(6)], ts))
        feeds.append(("JR", [[int(rng.integers(0, 8)),
                              int(rng.integers(1, 5))]
                             for _ in range(6)], ts + 1))
    return feeds


def seq_feeds():
    rng = np.random.default_rng(9)
    return [("S", [[0, float(rng.integers(1, 100)), 1 + (j % 2)]
                   for j in range(32)], 1000 + i * 40) for i in range(6)]


def fused_feeds():
    rng = np.random.default_rng(3)
    sends = [[int(rng.integers(0, 16)), float(rng.integers(1, 9)),
              int(rng.integers(1, 4))] for _ in range(250)]
    return [("S", sends[c:c + 50], 1000 + c) for c in range(0, 250, 50)]


CASES = {
    "pattern_staged": (APP, staged_feeds()),
    "pattern_random": (APP, random_feeds(1)),
    "per_key_aggregation": (AGG_APP, random_feeds(2, keys=32)),
    "fused_partial_stack": (FUSED_APP, fused_feeds()),
    "timer_expiry": (EXPIRY_APP, expiry_feeds()),
    "absent_timer": (ABSENT_APP, absent_feeds()),
    "windowed_join": (JOIN_APP, join_feeds()),
    "block_nfa_sequence": (SEQ_APP, seq_feeds()),
}


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_run_matches_jax(case, n):
    ql, feeds = CASES[case]
    j, t, u = both(ql, "query1", feeds, n)
    assert t == j
    assert flat(t) == flat(u)
    assert flat(t)


def test_pattern_state_lives_per_shard():
    """Each shard holds its own [W, C / n] slab, and a key's state sits at
    local row slot // n of shard slot % n."""
    def check(rt):
        qr = rt.query_runtimes["query1"]
        st = qr.state
        assert len(st) == 4
        assert all(p[0].shape[1] == 16 for p, _ in st)
        assert qr.shard_router.n_shards == 4
        assert qr.planned.shard_fused_steps is not None
    drive(siddhi_tpu_torch.SiddhiManager(device="cpu"), APP, "query1",
          staged_feeds(8), ShardMesh(["cpu"] * 4), check)


def test_fused_mesh_pattern_fuses():
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(FUSED_APP, mesh=ShardMesh(["cpu"] * 4))
    assert rt.query_runtimes["query1"]._fuse is not None


def test_top_level_pattern_is_not_sharded():
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(SEQ_APP, mesh=ShardMesh(["cpu"] * 4))
    assert rt.query_runtimes["query1"].planned.mesh is None
    assert rt.query_runtimes["query1"].shard_router is None


def test_key_capacity_rounds_up_to_the_mesh():
    ql = APP.replace("keys='64'", "keys='30'")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(ql, mesh=ShardMesh(["cpu"] * 4))
    assert rt.query_runtimes["query1"].planned.key_capacity == 32
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(
        ql, mesh=jax_mesh(4))
    assert jrt.query_runtimes["query1"].planned.key_capacity == 32
