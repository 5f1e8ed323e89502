"""The window-fill probe's sources (`fill_sources` of every unkeyed window
kind) and the plain version of kernel K33 (`kernels/fill_probe.py`)
against the JAX package.

For each window kind the port plans at the top level, one app runs through
both packages on the CPU with the same sends; after every send each JAX
`alive` leaf of the query's window state (`stateobs._alive_leaves`, in
its order) has the count and the capacity of the port's source at the
same place, computed by `fill_counts_plain`.  The JAX state carried into
the port with `convert.window_state_from_jax` gives the same counts too.
The plain version equals a numpy count on masks, counters and their
differences.
"""
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.observability.stateobs import _alive_leaves
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.kernels import fill_probe as fp

HEAD = ("@app:playback\n"
        "define stream S (eventTime long, v int, k string);\n"
        "@info(name='q') from S#window.{w} select k, v "
        "insert all events into O;\n")

WINDOWS = {
    "length": "length(5)",
    "time": "time(2 sec)",
    "lengthBatch": "lengthBatch(4)",
    "timeBatch": "timeBatch(2 sec)",
    "externalTime": "externalTime(eventTime, 2 sec)",
    "externalTimeBatch": "externalTimeBatch(eventTime, 2 sec)",
    "timeLength": "timeLength(2 sec, 4)",
    "delay": "delay(1 sec)",
    "batch": "batch()",
    "cron": "cron('*/5 * * * * ?')",
    "sort": "sort(3, v)",
    "hopping": "hopping(2 sec, 1 sec)",
    "frequent": "frequent(2, k)",
    "lossyFrequent": "lossyFrequent(0.34, k)",
    "session": "session(1 sec)",
    "expression": "expression('count() <= 3')",
    "expressionBatch": "expressionBatch('count() <= 3')",
}


def _sends(seed=3, n_sends=5):
    rng = np.random.default_rng(seed)
    out, ts = [], 1000
    for _ in range(n_sends):
        n = int(rng.integers(1, 7))
        rows = [[ts + 150 * i, int(rng.integers(0, 9)),
                 "abcd"[int(rng.integers(0, 4))]] for i in range(n)]
        out.append((rows, ts))
        ts += 150 * n + int(rng.integers(0, 900))
    return out


@pytest.fixture
def one_entry_per_fire_time(monkeypatch):
    """The JAX scheduler keeping one timer entry per (time, query), as the
    port's does (the known scheduler difference: one cron fire time
    flushes twice in the JAX package; `test_torch_window_batch.py`)."""
    from siddhi_tpu.core import runtime as jax_runtime
    orig = jax_runtime._Scheduler.notify_at

    def notify_at(self, ts, q):
        with self._cv:
            if any(t == ts and x is q for t, _, x in self._heap):
                return
        orig(self, ts, q)
    monkeypatch.setattr(jax_runtime._Scheduler, "notify_at", notify_at)


def _jax_fills(state):
    leaves = _alive_leaves(state)
    return ([int(np.asarray(a).sum()) for a in leaves],
            [int(np.prod(np.asarray(a).shape)) for a in leaves])


def _port_fills(window, wstate):
    srcs = window.fill_sources(wstate)
    return (fp.fill_counts_plain(srcs).tolist() if srcs else [],
            [s.cap for s in srcs])


@pytest.mark.parametrize("kind", sorted(WINDOWS))
def test_fill_sources_match_the_jax_alive_leaves(kind,
                                                 one_entry_per_fire_time):
    ql = HEAD.format(w=WINDOWS[kind])
    jm, tm = siddhi_tpu.SiddhiManager(), TorchManager(device="cpu")
    jrt = jm.create_siddhi_app_runtime(ql)
    trt = tm.create_siddhi_app_runtime(ql)
    for rt in (jrt, trt):
        rt.add_callback("q", lambda *a: None)
        rt.start()
    jqr, tqr = jrt.query_runtimes["q"], trt.query_runtimes["q"]
    w = tqr.planned.window
    assert w.name == kind or (kind, w.name) == ("lossyFrequent",
                                                "frequent")
    seen = 0
    for rows, ts in _sends():
        for rt in (jrt, trt):
            rt.get_input_handler("S").send(rows, timestamp=ts)
        want = _jax_fills(jqr.state[0])
        assert _port_fills(w, tqr.state[0]) == want
        carried = convert.window_state_from_jax(
            w, jqr.state[0], tqr.planned.in_schema, "cpu")
        assert _port_fills(w, carried) == want
        seen += sum(want[0])
    assert len(want[1]) >= 1 and seen > 0
    jm.shutdown()
    tm.shutdown()


def test_no_window_has_no_sources():
    """A query without a window holds no Buffer: the probe turns off."""
    ql = ("define stream S (v int);\n"
          "@info(name='q') from S[v > 1] select v insert into O;\n")
    tm = TorchManager(device="cpu")
    qr = tm.create_siddhi_app_runtime(ql).query_runtimes["q"]
    assert qr.planned.window.fill_sources(qr.state[0]) == []
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    assert _alive_leaves(jrt.query_runtimes["q"].state) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    m8 = rng.random(1000) < 0.3
    m64 = np.where(rng.random(77) < 0.5, rng.integers(1, 9, 77), 0)
    meta = rng.integers(0, 1 << 20, 6)
    cnt32 = rng.integers(0, 100, 3).astype(np.int32)
    srcs = [fp.mask(torch.from_numpy(m8)),
            fp.mask(torch.from_numpy(m8.astype(np.uint8)), 1000),
            fp.mask(torch.from_numpy(m64)),
            fp.count(torch.from_numpy(meta), 2, 64),
            fp.diff(torch.from_numpy(meta), 4, 1, 64),
            fp.count(torch.from_numpy(cnt32), 1, 9)]
    got = fp.fill_counts(srcs)
    assert got.dtype == torch.int64
    assert got.tolist() == [int(m8.sum()), int(m8.sum()),
                            int((m64 != 0).sum()), int(meta[2]),
                            int(meta[4] - meta[1]), int(cnt32[1])]
    assert [s.cap for s in srcs] == [1000, 1000, 77, 64, 64, 9]


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors `fill_counts` runs the plain version and never the
    kernel (the kernel runs only on CUDA tensors)."""
    fp.reset_counts()
    fp.fill_counts([fp.count(torch.arange(4), 3, 8)])
    assert (fp.plain_calls, fp.launches) == (1, 0)
