"""The port's sliding length window (pre-window filters + `LengthWindow`,
kernel K5 through its plain version) agrees with the JAX package's
`LengthWindow.process` step by step: the emitted rows (ts, kind, seq,
group slot, columns) in order, the window's live rows in age order and
the seq counter.  Also single-stream queries over a length window through
both packages' `SiddhiManager`s.

Inputs come from numpy seeds: batches shorter and longer than the window
(a batch longer than the window evicts its own earlier arrivals), a
partly filled window, invalid and TIMER rows inside a batch, filters that
drop rows before the window.  Tolerance: everything exact (the window
moves rows; the aggregates below sum dyadic prices, exact in float32).
"""
import jax
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import BatchFacts
from siddhi_tpu_torch.kernels import length_window

SCHEMA = "define stream S (symbol long, price float, volume int, ok bool);\n"


def _plans(body):
    ql = "@app:playback\n" + SCHEMA + body
    jrt = JaxManager().create_siddhi_app_runtime(ql)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.query_runtimes["q"], trt.query_runtimes["q"]


def _batch(rng, B, n, t0, timer_rows=0):
    ts = t0 + np.arange(B, dtype=np.int64)
    kind = np.full(B, ev.CURRENT, np.int32)
    kind[rng.permutation(B)[:timer_rows]] = ev.TIMER
    valid = np.zeros(B, np.bool_)
    valid[:n] = True
    cols = [rng.integers(0, 6, B).astype(np.int64),
            (rng.integers(0, 64, B) / 64).astype(np.float32),
            rng.integers(0, 9, B).astype(np.int32), rng.random(B) < 0.5]
    gslot = rng.integers(0, 6, B).astype(np.int32)
    return ts, kind, valid, cols, gslot


def _steps(jq, tq, batches):
    """Both window steps from an empty window over the same batches; the
    rows and the window contents compared after every step."""
    jp, tp = jq.planned, tq.planned
    jstage = jax.jit(lambda w, ts, kind, valid, cols, gslot, now:
                     jp.stage_body(w, ts, kind, valid, cols, gslot, now, ()))
    jw, tw = jq.state[0], tq.state[0]
    for i, (ts, kind, valid, cols, gslot) in enumerate(batches):
        now = int(ts.max())
        jw, jrows, _ = jstage(jw, ts, kind, valid, tuple(cols), gslot,
                              np.int64(now))
        batch = ev.EventBatch(torch.from_numpy(ts), torch.from_numpy(kind),
                              torch.from_numpy(valid),
                              tuple(torch.from_numpy(c) for c in cols))
        cur = ts[valid & (kind == ev.CURRENT)]
        tw, trows, _ = tp.stage_body(tw, batch, torch.from_numpy(gslot), now,
                                     BatchFacts(cur, ts.shape[0]))
        jr = jax.device_get(jrows)
        jv = np.asarray(jr.valid)
        tv = trows.valid.numpy()
        assert jv.sum() == tv.sum(), f"step {i}: row counts"
        for f in ("ts", "kind", "seq", "gslot"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jr, f))[jv],
                getattr(trows, f).numpy()[tv], err_msg=f"step {i} {f}")
        for c, (a, b) in enumerate(zip(jr.cols, trows.cols)):
            np.testing.assert_array_equal(np.asarray(a)[jv], b.numpy()[tv],
                                          err_msg=f"step {i} col {c}")
        # the window's live rows, oldest first, and the seq counter
        buf, seq = jax.device_get(jw)
        alive = np.asarray(buf.alive)
        head, _, tseq, pos = tw.live()
        assert int(seq) == tseq, f"step {i}: seq"
        assert alive.sum() == pos.shape[0], f"step {i}: window rows"
        assert alive[:pos.shape[0]].all()
        for f in ("ts", "gslot"):
            np.testing.assert_array_equal(
                np.asarray(getattr(buf, f))[alive],
                getattr(tw, f)[pos].numpy(), err_msg=f"step {i} ring {f}")
        # the ring stores no add_seq: the row at logical p has 2p + 1
        np.testing.assert_array_equal(
            np.asarray(buf.add_seq)[alive],
            2 * (head + np.arange(pos.shape[0])) + 1,
            err_msg=f"step {i} ring add_seq")
        for a, b in zip(buf.cols, tw.cols):
            np.testing.assert_array_equal(np.asarray(a)[alive],
                                          b[pos].numpy())
        yield i


@pytest.mark.parametrize("C,seed", [(5, 1), (16, 2), (64, 3)])
def test_length_window_steps(C, seed):
    """Batches of 8 to 128 rows into windows of 5 to 64: partly filled,
    exactly full, and batches longer than the window."""
    jq, tq = _plans(f"@info(name='q') from S#window.length({C}) "
                    f"select symbol, price insert into O;")
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(10):
        B = [8, 32, 128][int(rng.integers(0, 3))]
        n = int(rng.integers(0, B + 1))
        batches.append(_batch(rng, B, n, 1000 + 200 * i,
                              timer_rows=int(rng.integers(0, 3))))
    assert sum(1 for _ in _steps(jq, tq, batches)) == 10


def test_length_window_after_filter():
    """Rows the filter drops never enter the window (K1 compacts the
    arrivals first)."""
    jq, tq = _plans("@info(name='q') from S[price > 0.5 and ok]"
                    "#window.length(12) select symbol insert into O;")
    rng = np.random.default_rng(7)
    batches = [_batch(rng, 32, 32 - i, 1000 + 100 * i) for i in range(8)]
    assert sum(1 for _ in _steps(jq, tq, batches)) == 8


def test_plain_step_counts_and_closed_form_positions():
    """The plain K5: EXPIRED k lands just before CURRENT k, the k0 arrivals
    that evict nothing first, and the counters move as documented."""
    from siddhi_tpu_torch.core.window import Rows
    from siddhi_tpu_torch.query_api.definition import StreamDefinition
    d = StreamDefinition("S")
    d.attribute("x", "LONG")
    schema = ev.Schema(d, ev.StringInterner())
    ring = length_window.LengthRing.empty(schema, 4, "cpu")
    length_window.reset_counts()

    def arr(vals):
        n = len(vals)
        return Rows(ts=torch.arange(n, dtype=torch.int64),
                    kind=torch.zeros(n, dtype=torch.int32),
                    valid=torch.ones(n, dtype=torch.bool),
                    seq=torch.zeros(n, dtype=torch.int64),
                    gslot=torch.zeros(n, dtype=torch.int32),
                    cols=(torch.tensor(vals, dtype=torch.int64),)), \
            torch.tensor([n])
    out = length_window.length_window_step(ring, *arr([1, 2]))
    assert out.valid.tolist() == [True, True, False, False]
    out = length_window.length_window_step(ring, *arr([3, 4, 5, 6, 7, 8]))
    v = out.valid
    # k0 = 2 arrivals fill the window; then each evicts the oldest
    assert out.kind[v].tolist() == [0, 0, 1, 0, 1, 0, 1, 0, 1, 0]
    assert out.cols[0][v].tolist() == [3, 4, 1, 5, 2, 6, 3, 7, 4, 8]
    assert out.seq[v].tolist() == [5, 7, 8, 9, 10, 11, 12, 13, 14, 15]
    assert ring.meta.tolist() == [4, 8, 16, 0]
    assert ring.cols[0][ring.live()[3]].tolist() == [5, 6, 7, 8]
    assert length_window.plain_calls == 2 and length_window.launches == 0


def _run(manager, ql, sends):
    rt = manager.create_siddhi_app_runtime(ql)
    events, counts = [], []
    rt.add_callback("q", lambda ts, i, o: events.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in i or []],
         [(e.timestamp, tuple(e.data)) for e in o or []])))
    rt.add_batch_callback("q", lambda ts, b: counts.append(
        (b["n_current"], b["n_expired"])))
    rt.start()
    h = rt.get_input_handler("S")
    for cols, ts in sends:
        h.send_columns(cols, timestamps=ts)
    rt.shutdown()
    return events, counts


@pytest.mark.parametrize("body", [
    "select symbol, price, volume insert all events into O;",
    "select symbol, sum(price) as sp, count() as c, max(volume) as mv "
    "group by symbol having c > 1 insert all events into O;",
])
def test_length_window_queries(body):
    """Projection with EXPIRED rows, and group by / aggregators / having
    over a length window (K5 feeding K4's plain version)."""
    ql = ("@app:playback\n" + SCHEMA +
          "@info(name='q') from S[volume > 1]#window.length(20) " + body)
    rng = np.random.default_rng(11)
    sends = []
    for i in range(8):
        n = int(rng.integers(1, 48))
        sends.append(([rng.integers(0, 5, n).astype(np.int64),
                       (rng.integers(0, 64, n) / 64).astype(np.float32),
                       rng.integers(0, 9, n).astype(np.int32),
                       rng.random(n) < 0.5],
                      np.full(n, 1000 + 50 * i, np.int64)))
    je = _run(JaxManager(), ql, sends)
    te = _run(TorchManager(device="cpu"), ql, sends)
    assert je == te
    assert sum(c[1] for c in te[1]) > 0, "no EXPIRED rows"
