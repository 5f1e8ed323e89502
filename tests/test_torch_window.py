"""The port's window steps (pre-window filters + `NoWindow` / `TimeWindow` /
`LengthBatchWindow`, each through its plain kernel version) agree with the
JAX package's `stage_body`, step by step, from a state carried across
mid-stream with `convert.query_state_from_jax`.

Inputs come from numpy seeds: in-order, equal and out-of-order timestamps
(within and across sends), TIMER batches, sends that overflow the time
window's buffer, sends that complete several length batches.  Tolerance:
everything exact (the windows move rows, they compute nothing).  Rows are
compared where valid; both sides put valid rows first in seq order.
"""
import jax
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import query_state_from_jax, ring_to_jax
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import BatchFacts

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


def _steps(jq, tq, batches, warm):
    """Run `warm` batches through the JAX step alone, carry its state over,
    then run the rest through both and compare."""
    jp, tp = jq.planned, tq.planned
    jstage = jax.jit(lambda w, ts, kind, valid, cols, gslot, now:
                     jp.stage_body(w, ts, kind, valid, cols, gslot, now, ()))
    jw = jq.state[0]
    for i, (b, now) in enumerate(batches):
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
        for f in ("ts", "kind", "seq", "gslot"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jr, f))[jv],
                getattr(trows, f).numpy()[tv], err_msg=f"step {i} {f}")
        for c, (a, b) in enumerate(zip(jr.cols, trows.cols)):
            np.testing.assert_array_equal(np.asarray(a)[jv], b.numpy()[tv],
                                          err_msg=f"step {i} col {c}")
        if twake is not None:
            assert int(jwake) == int(twake[0]), f"step {i}: wake"
            assert int(twake[1]) == 0, f"step {i}: expire bound missed rows"
        yield i, jw, tw


def _check_ring(jw, tw):
    buf, seq = jax.device_get(jw)
    mine, tseq = ring_to_jax(tw)
    assert int(seq) == tseq
    alive = np.asarray(buf.alive)
    np.testing.assert_array_equal(alive, mine.alive)
    for f in ("ts", "add_seq", "expire_ts", "gslot"):
        np.testing.assert_array_equal(np.asarray(getattr(buf, f))[alive],
                                      getattr(mine, f)[alive], err_msg=f)
    for a, b in zip(buf.cols, mine.cols):
        np.testing.assert_array_equal(np.asarray(a)[alive], b[alive])


@pytest.mark.parametrize("order", ["in", "equal", "jitter"])
def test_time_window_steps(order):
    """A 256-row buffer, 32-row sends every 40 ms into a 300 ms window:
    the buffer overflows, TIMER batches expire rows between sends."""
    jq, tq = _plans("@capacity(window='256')\n@info(name='q') "
                    "from S#window.time(300) select symbol, price "
                    "insert into O;")
    rng = np.random.default_rng({"in": 1, "equal": 2, "jitter": 3}[order])
    batches, clock = [], 1000
    for i in range(24):
        clock += 40
        if i % 5 == 4:
            batches.append((_batch(rng, 8, 1, np.full(8, clock), True),
                            clock))
            continue
        if order == "in":
            ts = clock + np.sort(rng.integers(0, 30, 32))
        elif order == "equal":
            ts = np.full(32, clock)
        else:
            ts = clock + rng.integers(-120, 30, 32)
        n = int(rng.integers(20, 33))
        batches.append((_batch(rng, 32, n, ts), int(max(clock, ts[:n].max()))))
    steps = 0
    for _, jw, tw in _steps(jq, tq, batches, warm=6):
        _check_ring(jw, tw)
        steps += 1
    assert steps == 18


def test_time_window_whole_window_expires():
    jq, tq = _plans("@capacity(window='1024')\n@info(name='q') "
                    "from S[price > 0.25]#window.time(100) select symbol "
                    "insert into O;")
    rng = np.random.default_rng(4)
    batches = [(_batch(rng, 128, 128, np.full(128, 1000 + 10 * i)),
                1000 + 10 * i) for i in range(6)]
    batches.append((_batch(rng, 8, 1, np.full(8, 5000), True), 5000))
    batches.append((_batch(rng, 128, 100, np.full(128, 5001)), 5001))
    for i, jw, tw in _steps(jq, tq, batches, warm=2):
        _check_ring(jw, tw)
    assert int(tw.meta[1] - tw.meta[0]) == int(
        np.asarray(jax.device_get(jw)[0].alive).sum())


@pytest.mark.parametrize("n,sizes", [(7, (8, 32, 128, 8, 32)),
                                     (100, (128, 8, 128, 32, 512))])
def test_length_batch_steps(n, sizes):
    """Sends that complete no batch, one, and many (128 rows at n = 7:
    18 flushes)."""
    jq, tq = _plans(f"@info(name='q') from S[volume > 1]"
                    f"#window.lengthBatch({n}) select symbol, volume "
                    f"insert into O;")
    rng = np.random.default_rng(n)
    batches = [(_batch(rng, B, int(rng.integers(B // 2, B + 1)),
                       np.full(B, 1000 + i)), 1000 + i)
               for i, B in enumerate(sizes * 2)]
    for i, jw, tw in _steps(jq, tq, batches, warm=2):
        pend, prev, seq = jax.device_get(jw)
        assert [int(x) for x in tw.meta] == [
            int(np.asarray(pend.alive).sum()),
            int(np.asarray(prev.alive).sum()), int(seq)]
        fill, pc = int(tw.meta[0]), int(tw.meta[1])
        np.testing.assert_array_equal(np.asarray(pend.ts)[:fill],
                                      tw.p_ts[:fill].numpy())
        np.testing.assert_array_equal(np.asarray(prev.ts)[:pc],
                                      tw.q_ts[:pc].numpy())
        for a, b in zip(prev.cols, tw.q_cols):
            np.testing.assert_array_equal(np.asarray(a)[:pc], b[:pc].numpy())


def test_no_window_filter_compaction():
    """Filters, TIMER rows and a partial bucket through the pass-through
    window: kept rows first in input order, numbered from the seq
    counter."""
    jq, tq = _plans("@info(name='q') from S[price >= 0.5 and ok] "
                    "select symbol, price insert into O;")
    rng = np.random.default_rng(5)
    batches = [(_batch(rng, 128, int(rng.integers(1, 129)),
                       np.arange(128) + 10 * i), 1000 + i)
               for i in range(6)]
    batches.insert(3, (_batch(rng, 8, 1, np.full(8, 1003), True), 1003))
    for i, jw, tw in _steps(jq, tq, batches, warm=1):
        assert int(np.asarray(jax.device_get(jw))) == int(tw[0])
