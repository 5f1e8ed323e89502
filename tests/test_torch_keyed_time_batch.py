"""`timeBatch` kept per partition key: the port's keyed step in its
timeBatch mode (the plain version of kernel K11's MODE_TBATCH) agrees with
the window half of the JAX package's keyed step `kstep`
(`TimeBatchWindow.process` under `vmap`, `siddhi_tpu/core/planner.py
:539-566`), step by step from a slab carried across with
`convert.keyed_slab_from_jax`: interleaved keys with timer ticks over all
K keys, several boundaries collapsing into one flush, arrivals at or past
the boundary of a step that does not flush, a tick that flushes some keys,
two keys flushing in one send, padding key rows, the round trip back to
the JAX state, and a slice above its capacity (the rows that fit kept, the
rest counted as missed, on which the runtime raises).  Whole queries run
through both packages' `SiddhiManager`s, and chip_smoke.py's KT1 numpy
model (a per-device tumbling minute) is held to the port's rows at a
small size.

Inputs come from numpy seeds.  Tolerance: exact (rows in order, every
key's slices, start and counters, the wake).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_partition import _both
from test_torch_keyed_window import (K, _batch, _group, _interleaved, _plans,
                                     _run, _timer)

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.kernels import keyed_window as kw


def test_interleaved_keys_and_ticks():
    rng = np.random.default_rng(41)
    steps = _interleaved(rng, 12, 40, dt=40, timer_at=(4, 8, 9))
    assert _run("timeBatch(100)", steps) > 100


def test_collapsed_boundaries():
    """Gaps of several periods between sends and ticks: each key flushes
    once however many boundaries passed."""
    rng = np.random.default_rng(43)
    steps = _interleaved(rng, 8, 30, dt=270, spread=60, timer_at=(3, 6))
    assert _run("timeBatch(100)", steps) > 60


def test_arrivals_past_the_boundary_of_a_step_that_does_not_flush():
    """A step whose `now` is before some arrivals: those at or past the
    key's boundary drop; a later step flushes the rest."""
    rng = np.random.default_rng(45)
    steps = []
    for i in range(6):
        now = 1000 + 30 * i
        keys = rng.integers(0, 6, 24)
        ts = now + np.where(rng.random(24) < 0.3, 250, 0) - \
            rng.integers(0, 20, 24)
        b = _batch(rng, 24, keys, ts, invalid=0.0)
        key_idx, sel = _group(keys, b[2], np.unique(keys[b[2]]))
        steps.append(b + (key_idx, sel, now))
    steps.append(_timer(1400) + (1400,))
    assert _run("timeBatch(100)", steps) > 20


def test_tick_flushes_some_keys_and_two_keys_flush_in_one_send():
    rng = np.random.default_rng(47)
    steps = []
    for i, (keys, now) in enumerate((([1, 2, 1], 1000), ([3, 3], 1060),
                                     ([1, 2, 3, 2], 1105),
                                     ([4, 1, 4], 1150))):
        b = _batch(rng, len(keys), keys, np.full(len(keys), now),
                   invalid=0.0, filt=0.0)
        steps.append(b + _group(keys, b[2], list(dict.fromkeys(keys)))
                     + (now,))
        if i == 1:
            steps.append(_timer(1100) + (1100,))    # keys 1 and 2 only
    steps.append(_timer(1300) + (1300,))
    assert _run("timeBatch(100)", steps, warm=1) > 10


@pytest.mark.parametrize("pads", [0, 3])
def test_padding_key_rows(pads):
    rng = np.random.default_rng(49)
    steps = []
    for i in range(6):
        now = 1000 + 45 * i
        keys = np.concatenate([np.full(3, K - 1), rng.integers(0, K, 12)])
        b = _batch(rng, len(keys), keys, np.full(len(keys), now))
        key_idx, sel = _group(keys, b[2], np.unique(keys[b[2]]),
                              pads=pads if i else 0)
        steps.append(b + (key_idx, sel, now))
    assert _run("timeBatch(100)", steps) > 10


def test_slice_above_capacity_counts_missed():
    """150 events of one key in one slice (capacity 128), three times: the
    JAX step keeps the first 128 rows of a slice (its scatter drops the
    rest) and so does the port, which reports the rows it could not hold:
    22, then all 150 of a step that does not flush, then the 22 past 128
    of the arrivals that start the next slice on a flush."""
    rng = np.random.default_rng(51)
    keys = np.full(150, 5)
    steps = []
    for now in (1000, 1010, 1120):
        b = _batch(rng, 150, keys, np.full(150, now), invalid=0.0, filt=0.0)
        steps.append(b + _group(keys, b[2], [5]) + (now,))
    assert _run("timeBatch(100)", steps, warm=0) == 1 + 128
    _, tp, _ = _plans("timeBatch(100)")
    slab = tp.init_state()[0]
    missed = []
    for ts, kind, valid, cols, gslot, key_idx, sel, now in steps:
        _, wake = kw.plain(slab, tp.filter_spec, torch.from_numpy(ts),
                           torch.from_numpy(kind), torch.from_numpy(valid),
                           torch.from_numpy(gslot),
                           [torch.from_numpy(c) for c in cols],
                           torch.from_numpy(key_idx), torch.from_numpy(sel),
                           now, 100)
        missed.append(int(wake[1]))
    assert missed == [22, 150, 22]
    assert int(slab.count[5]) == 128 and int(slab.p_count[5]) == 128


def test_slice_above_capacity_raises(caplog):
    """Through the runtime a slice above its capacity raises (the
    junction logs the step's error, @OnError LOG)."""
    ql = """
    @app:playback
    define stream S (k long, v int);
    partition with (k of S)
    begin
      @info(name='q') from S#window.timeBatch(1 sec)
      select k, sum(v) as s insert into Out;
    end;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.add_callback("q", lambda ts, i, o: None)
    rt.start()
    h = rt.get_input_handler("S")
    h.send_columns([np.full(130, 3, np.int64), np.arange(130, dtype=np.int32)],
                   timestamps=np.full(130, 1000, np.int64))
    rt.shutdown()
    assert "2 rows did not fit the time batch window" in caplog.text


@pytest.mark.parametrize("select,filt", [
    ("k, sum(v) as sv, count() as c", ""),
    ("k, w, max(v) as mv", "[w >= 0]"),
    ("k, avg(v) as av, min(w) as mw", "[w > 2]"),
])
def test_whole_queries(select, filt):
    """A keyed timeBatch with the pre-window filter, group by the
    partition key alone (K4's run mode) and with a post-window filter,
    interleaved keys and ticks from the scheduler."""
    pre, post = (filt, "") if filt != "[w > 2]" else ("", filt)
    ql = f"""
    @app:playback
    define stream S (k long, v float, w int);
    partition with (k of S)
    begin
      @capacity(keys='64')
      @info(name='q') from S{pre}#window.timeBatch(400){post}
      select {select} insert all events into Out;
    end;
    """
    rng = np.random.default_rng(53)
    sends = []
    for i in range(12):
        B = 24
        ts = np.sort(1000 + 170 * i + rng.integers(0, 100, B)).astype(
            np.int64)
        sends.append(("S", (rng.integers(0, 6, B).astype(np.int64),
                            (rng.integers(0, 64, B) / 64).astype(np.float32),
                            rng.integers(-1, 9, B).astype(np.int32)), ts))
    ev = _both(ql, "q", sends)
    assert sum(len(i) + len(o) for _, i, o in ev) > 60


def test_chip_smoke_kt1_model(monkeypatch):
    """chip_smoke.py's KT1 at a small size (64 devices, a 6-second slice,
    so 3 sends a slice): both packages give the same events, and KT1Model
    accepts every tick's flush rows and the data steps' empty ones."""
    monkeypatch.setattr(chip_smoke, "KT1_KEYS", 64)
    t = 6000
    ql = chip_smoke.KT1_QL.replace("1 min", "6 sec").replace("65536", "64")
    rng = np.random.default_rng(13)
    raw = [chip_smoke.kt1_send(np, rng, i) for i in range(11)]
    _both(ql, "kt1", [("TempStream", tuple(c), ts) for c, ts in raw])
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    got = []
    rt.add_batch_callback("kt1", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("TempStream")
    model = chip_smoke.KT1Model(np, 64, t)
    flushed = []
    for i, (cols, ts) in enumerate(raw):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        flushed.append(model.step(cols, ts, list(got), f"KT1 send {i}"))
    rt.shutdown()
    assert flushed.count(64) >= 3
