"""`@serve` in the port (`siddhi_tpu_torch/serving`): emission rings on the
device and the serving drainer, against the JAX package
(`siddhi_tpu/serving`), on the CPU.

Each app runs through both packages served and unserved from the same
sends; `flush()` after every send drains the rings, so the events each
query delivered are compared after every send.  Tolerance: exact.

Shapes from `tests/test_serving.py`: parity for a filter, a length
window, a join, a pattern, `@fuse` and a merge group; shutdown delivers
pending emissions; the send path never fetches (every device-to-host
transfer of the delivery path goes through `core/event.py` `device_get`,
which no call on the producer thread reaches); timer-bearing queries
deliver inline; a full ring grows and keeps send order; a failing
callback leaves the drainer alive; the `enabled='false'` opt-out and the
`serving.enabled` / `serving.ring.capacity` config properties.
Left out: `test_snapshot_quiesce_drains_ring` (snapshots, ROADMAP A13),
`test_stalled_drainer_degrades_not_dead` (health, A15),
`test_explain_and_metrics_surfaces` (EXPLAIN and metrics, A15); the
chaos test checks the drainer survives without the exception listener
(A15).

Plain versions: K30's `ring_append` against per-leaf index copies and
`ring_pack` against each slot's valid rows.
"""
import threading

import numpy as np
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core import event as port_ev


def port_mgr():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def collect(rt, qname):
    got = []
    rt.add_callback(qname, lambda ts, cur, exp: got.append(
        (int(ts), [tuple(e.data) for e in (cur or [])],
         [tuple(e.data) for e in (exp or [])])))
    return got


def run(manager, ql, feeds, qname="q"):
    """Per-send views (flush after each send) and the final events."""
    rt = manager.create_siddhi_app_runtime("@app:playback\n" + ql)
    got = collect(rt, qname)
    rt.start()
    per = []
    for i, (sid, rows) in enumerate(feeds):
        rt.get_input_handler(sid).send(rows, 1000 + 10 * i)
        rt.flush()
        per.append(list(got))
    rt.shutdown()
    return per


def parity(plain, feeds, qname="q"):
    serve = plain.replace("@info", "@serve @info")
    base = run(port_mgr(), plain, feeds, qname)
    served = run(port_mgr(), serve, feeds, qname)
    jax_served = run(siddhi_tpu.SiddhiManager(), serve, feeds, qname)
    assert served == base
    assert served == jax_served
    assert base[-1]


def test_serve_parity_filter():
    parity("""
    define stream S (v int);
    @info(name='q') from S[v > 2] select v * 10 as w insert into Out;
    """, [("S", [v]) for v in range(8)])


def test_serve_parity_window():
    parity("""
    define stream S (v int);
    @info(name='q') from S#window.length(4)
    select sum(v) as t insert into Out;
    """, [("S", [v]) for v in range(10)])


def test_serve_parity_join():
    feeds = []
    for i in range(6):
        feeds.append(("L", [i % 3, 1.5 * i]))
        feeds.append(("R", [i % 3, i]))
    parity("""
    define stream L (sym long, price float);
    define stream R (sym long, qty int);
    @emit(rows='256')
    @info(name='q')
    from L#window.length(8) join R#window.length(8)
      on L.sym == R.sym
    select L.sym as s, L.price as p, R.qty as v
    insert into J;
    """, feeds)


def test_serve_parity_pattern():
    parity("""
    define stream S (price float, volume int);
    @capacity(keys='1', slots='8')
    @emit(rows='16')
    @info(name='q')
    from every e1=S[volume == 1] -> e2=S[volume == 2 and price >= e1.price]
    select e1.price as p1, e2.price as p2
    insert into M;
    """, [("S", [float(i), 1 + i % 2]) for i in range(12)])


def test_serve_parity_fuse():
    parity("""
    define stream S (v int);
    @fuse(batches='4')
    @info(name='q') from S[v % 2 == 0] select v + 1 as w insert into Out;
    """, [("S", [v]) for v in range(11)])


def test_serve_parity_merged():
    plain = """
    define stream S (v int);
    @info(name='q') from S[v > 1] select v as a insert into OutA;
    @info(name='q2') from S[v > 3] select v as b insert into OutB;
    """
    rt = port_mgr().create_siddhi_app_runtime(
        plain.replace("@info", "@serve @info"))
    assert rt.merged_groups
    rt.shutdown()
    for qname in ("q", "q2"):
        parity(plain, [("S", [v]) for v in range(8)], qname)


def test_shutdown_delivers_pending():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve @info(name='q') from S select v * 2 as w insert into Out;
    """)
    got = collect(rt, "q")
    rt.start()
    h = rt.get_input_handler("S")
    for v in range(5):
        h.send([v])
    rt.shutdown()
    assert [c[0][0] for _, c, _ in got] == [0, 2, 4, 6, 8]


def test_send_path_never_fetches(monkeypatch):
    """Only the serving drainer moves emissions to the host: no
    device_get (the delivery path's one transfer function) and no tensor
    read-back on the producer thread."""
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve @info(name='q') from S select v + 1 as w insert into Out;
    """)
    got = collect(rt, "q")
    rt.start()
    sender = threading.current_thread()
    calls = {"sender": 0, "other": 0}
    orig = port_ev.device_get
    orig_tolist, orig_item = torch.Tensor.tolist, torch.Tensor.item

    def guard(x):
        calls["sender" if threading.current_thread() is sender
              else "other"] += 1
        return orig(x)

    def no_readback(fn):
        def f(self, *a, **k):
            assert threading.current_thread() is not sender, \
                "a tensor was read back in the send path"
            return fn(self, *a, **k)
        return f
    monkeypatch.setattr(port_ev, "device_get", guard)
    monkeypatch.setattr(torch.Tensor, "tolist", no_readback(orig_tolist))
    monkeypatch.setattr(torch.Tensor, "item", no_readback(orig_item))
    h = rt.get_input_handler("S")
    for v in range(20):
        h.send([v])
    # the drainer delivers on its own thread: wait for it (not for wall
    # time) before the guards come off, or a loaded machine can undo them
    # before it has delivered anything
    import time
    drainer = rt._serve_drainer
    deadline = time.monotonic() + 10.0
    while (drainer.pending() or not drainer.drains_total) and \
            time.monotonic() < deadline:
        time.sleep(0.002)
    monkeypatch.undo()
    rt.flush()
    assert calls["sender"] == 0 and calls["other"] > 0
    assert [c[0][0] for _, c, _ in got] == list(range(1, 21))
    rt.shutdown()


def test_timer_queries_deliver_inline():
    import time
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve @info(name='q') from S#window.time(60 ms)
    select v insert into Out;
    """)
    pairs = []
    rt.add_callback("q", lambda ts, cur, exp: pairs.append(
        ([e.data[0] for e in (cur or [])],
         [e.data[0] for e in (exp or [])])))
    rt.start()
    rt.get_input_handler("S").send([5])
    deadline = time.monotonic() + 5
    while not any(exp for _, exp in pairs) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert any(exp == [5] for _, exp in pairs), pairs
    assert rt.query_runtimes["q"].__dict__.get("_serve_ring") is None
    rt.shutdown()


def test_ring_overflow_grows():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve(ring.capacity='2')
    @info(name='q') from S select v as w insert into Out;
    """)
    got = collect(rt, "q")
    rt.start()
    h = rt.get_input_handler("S")
    h.send([0])
    drainer = rt._serve_drainer
    with drainer._deliver_lock:          # stall every drain round
        for v in range(1, 8):
            h.send([v])
    rt.flush()
    ring = rt.query_runtimes["q"].__dict__["_serve_ring"]
    assert ring.grows_total >= 1 and ring.capacity > 2
    assert ring.occupancy() == 0
    assert [c[0][0] for _, c, _ in got] == list(range(8))
    rt.shutdown()


def test_ring_blocks_at_its_cap():
    """Past RING_CAP_MAX the producer waits for the drainer instead of
    growing: nothing is dropped and send order holds."""
    from siddhi_tpu_torch.serving import ring as ring_mod
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve(ring.capacity='2')
    @info(name='q') from S select v as w insert into Out;
    """)
    got = collect(rt, "q")
    rt.start()
    old = ring_mod.RING_CAP_MAX
    ring_mod.RING_CAP_MAX = 2
    try:
        h = rt.get_input_handler("S")
        for v in range(12):
            h.send([v])
        rt.flush()
    finally:
        ring_mod.RING_CAP_MAX = old
    ring = rt.query_runtimes["q"].__dict__["_serve_ring"]
    assert ring.grows_total == 0 and ring.capacity == 2
    assert [c[0][0] for _, c, _ in got] == list(range(12))
    rt.shutdown()


def test_failing_callback_does_not_stop_drain():
    rt = port_mgr().create_siddhi_app_runtime("""
    define stream S (v int);
    @serve @info(name='q') from S select v as w insert into Out;
    """)
    got = []

    def cb(ts, cur, exp):
        vals = [e.data[0] for e in (cur or [])]
        if vals and vals[0] % 3 == 1:
            raise RuntimeError(f"sink killed at {vals[0]}")
        got.extend(vals)
    rt.add_callback("q", cb)
    rt.start()
    h = rt.get_input_handler("S")
    for v in range(9):
        h.send([v])
    rt.flush()
    assert got == [v for v in range(9) if v % 3 != 1]
    h.send([30])
    rt.flush()
    assert got[-1] == 30
    rt.shutdown()


def test_serve_annotation_opt_out():
    ql = """
    @app:serve
    define stream S (v int);
    @info(name='a') from S select v as w insert into OutA;
    @serve(enabled='false')
    @info(name='b') from S select v as w insert into OutB;
    """
    rt = port_mgr().create_siddhi_app_runtime(ql)
    assert rt.query_runtimes["a"].serve_emit
    assert not rt.query_runtimes["b"].serve_emit
    rt.shutdown()


def test_serving_enabled_config_property():
    from siddhi_tpu_torch.utils.config import InMemoryConfigManager
    m = port_mgr()
    m.set_config_manager(InMemoryConfigManager(system_configs={
        "serving.enabled": "true", "serving.ring.capacity": "3"}))
    rt = m.create_siddhi_app_runtime("""
    define stream S (v int);
    @info(name='q') from S select v + 1 as w insert into Out;
    """)
    got = collect(rt, "q")
    rt.start()
    assert rt.query_runtimes["q"].serve_emit
    h = rt.get_input_handler("S")
    for v in range(6):
        h.send([v])
    rt.flush()
    assert [c[0][0] for _, c, _ in got] == [1, 2, 3, 4, 5, 6]
    ring = rt.query_runtimes["q"].__dict__["_serve_ring"]
    assert ring.capacity % 3 == 0
    m.shutdown()


def test_ring_plain_versions():
    """`append`'s plain version is one index copy per leaf; `pack`'s
    gathers each slot's valid rows, slot after slot from the tail (a
    wrapped run included)."""
    from siddhi_tpu_torch.kernels import ring as k30
    rng = np.random.default_rng(0)
    R, S = 16, 4

    def block(i):
        valid = torch.from_numpy(rng.random(R) < 0.6)
        return (torch.tensor([int(valid.sum()), 7 * i, 0, 0]),
                torch.from_numpy(rng.integers(0, 99, R)),
                torch.from_numpy(rng.integers(0, 2, R).astype(np.int32)),
                valid,
                (torch.from_numpy(rng.random(R).astype(np.float32)),
                 torch.from_numpy(rng.random(R) < 0.5)))
    blocks = [block(i) for i in range(6)]
    ring = k30.alloc(blocks[0], S)
    for i, b in enumerate(blocks[:S]):
        k30.append(ring, b, i)
    for i, b in enumerate(blocks[:S]):
        for leaf, x in zip(ring, k30.block_leaves(b)):
            assert torch.equal(leaf[i], x)
    # slots 0-1 drained; two more appends wrap into them
    k30.append(ring, blocks[4], 0)
    k30.append(ring, blocks[5], 1)
    meta, rows = k30.pack_fetch(ring, 2, 4)
    order = [blocks[2], blocks[3], blocks[4], blocks[5]]
    for j, b in enumerate(order):
        assert meta[j, :4].tolist() == b[0].tolist()
        assert meta[j, 4] == int(b[3].sum())
    for k, pick in enumerate([lambda b: b[1], lambda b: b[2],
                              lambda b: b[4][0], lambda b: b[4][1]]):
        exp = np.concatenate([pick(b)[b[3]].numpy() for b in order])
        assert np.array_equal(rows[k], exp)
