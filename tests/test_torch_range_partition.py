"""Range partitions through both packages' `SiddhiManager`s give the same
events: the range cases of `tests/test_partition_ext.py` (one query, rows
matching no range, a pattern, a lengthBatch window per range), a range
with a time window and group by under seeded traffic, a timer tick over a
range-keyed window, and the range-partitioned join's CompileError in both.
chip_smoke.py's RP1 numpy model (the query guide's per-area average) is
held to the port's rows at a small size, with the JAX package giving the
same events.

Inputs come from numpy seeds.  Tolerance: timestamps, kinds, order,
integer values and counts exact; float32 aggregates exact too, because the
values are small integers or dyadic (k/64) and every running sum stays
below 2^17, where any order of float32 additions is exact.
"""
import numpy as np
import pytest

import chip_smoke
from test_torch_partition import _both, _n_events

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core.executor import CompileError as TorchCompileError


_EXT = [c for c in chip_smoke.P3_CASES if c[0].startswith("range")]


@pytest.mark.parametrize("name,ql,qname,sends,want", _EXT,
                         ids=[c[0] for c in _EXT])
def test_partition_ext_range_cases(name, ql, qname, sends, want):
    assert len(_EXT) == 4
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want
    assert want


RANGE_TIME = """
@app:playback
define stream S (k long, v float, w int);
partition with (w < 3 as 'low' or w >= 3 and w < 6 as 'mid' or
                w >= 6 and w < 9 as 'high' of S)
begin
  @capacity(keys='8', window='256')
  @info(name='q') from S#window.{win}
  select k, w, sum(v) as sv, count() as c, max(v) as mv
  group by k
  insert all events into Out;
end;
"""


def _sends(rng, n, B, t0=1000, dt=250, spread=100):
    out = []
    for i in range(n):
        ts = np.sort(t0 + dt * i + rng.integers(0, spread, B)).astype(
            np.int64)
        cols = (rng.integers(0, 5, B).astype(np.int64),
                (rng.integers(0, 64, B) / 64).astype(np.float32),
                rng.integers(-2, 10, B).astype(np.int32))   # -2, -1, 9: none
        out.append(("S", cols, ts))
    return out


@pytest.mark.parametrize("win", ["time(600)", "length(4)",
                                 "lengthBatch(3)", "timeBatch(700)"])
def test_range_window_group_by_and_unmatched_rows(win):
    """Several ranges interleaved in every send, group by a further
    attribute, rows that match no range (w < 0 or w >= 9), and for the
    time windows the ticks over every range key."""
    rng = np.random.default_rng(31)
    ev = _both(RANGE_TIME.format(win=win), "q", _sends(rng, 10, 48))
    assert _n_events(ev) > 100


def test_timer_tick_over_a_range_keyed_window():
    """Ticks alone (sends past the window with rows matching no range)
    expire every range key's rows, and each key's timeBatch flushes."""
    rng = np.random.default_rng(33)
    sends = _sends(rng, 3, 30)
    for win in ("time(600)", "timeBatch(700)"):
        late = sends + [("S", [[1, 0.5, -5]], 2500), ("S", [[2, 0.25, 99]],
                                                         4000)]
        ev = _both(RANGE_TIME.format(win=win), "q", late)
        assert any(o for t, _, o in ev if t >= 2500) or \
            win.startswith("timeBatch")
        assert _n_events(ev) > 60


def test_range_partitioned_join_raises_in_both():
    ql = """
    define stream L (sym string, v int);
    define stream R (sym string, w int);
    partition with (v < 10 as 'small' or v >= 10 as 'big' of L,
                    w < 10 as 'small' or w >= 10 as 'big' of R)
    begin
      from L#window.length(4) join R#window.length(4) on L.sym == R.sym
      select L.sym as s insert into O;
    end;
    """
    from siddhi_tpu.core.executor import CompileError as JaxCompileError
    with pytest.raises(JaxCompileError, match="range-partitioned joins"):
        JaxManager().create_siddhi_app_runtime(ql)
    with pytest.raises(TorchCompileError, match="range-partitioned joins"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_chip_smoke_rp1_model(monkeypatch):
    """chip_smoke.py's RP1 at a small size (200 devices over the same
    1,500 rooms, 512 readings a send, a 5-second window): both packages
    give the same events, and RP1Model accepts every tick's and data
    step's rows the port delivers."""
    monkeypatch.setattr(chip_smoke, "RP1_DEV", 200)
    monkeypatch.setattr(chip_smoke, "RP1_B", 512)
    t = 5000
    ql = chip_smoke.RP1_QL.replace("10 min", "5 sec").replace(
        "4194304", "4096")
    rng = np.random.default_rng(7)
    raw = [chip_smoke.rp1_send(np, rng, i) for i in range(8)]
    _both(ql, "rp1", [("TempStream", tuple(c), ts) for c, ts in raw])
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    got = []
    rt.add_batch_callback("rp1", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("TempStream")
    model = chip_smoke.RP1Model(np, t)
    ticks = []
    for i, (cols, ts) in enumerate(raw):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        ticks.append(model.step(cols, ts, list(got), f"RP1 send {i}"))
    rt.shutdown()
    assert ticks[0] == 0 and sum(ticks) >= 8
    assert model.n[0] and model.n[1] and model.n[2]
