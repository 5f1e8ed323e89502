"""`@purge` through both packages' `SiddhiManager`s gives the same events:
the two purge cases of `tests/test_partition_ext.py` (pattern slots and
group-by slots, with the allocators' sizes), a keyed window whose slab row
is reset when its key is purged, a recycled group slot that must not leak
the purged key's aggregates, `enable='false'`, and chip_smoke.py's PG1
numpy model (a per-device running maximum over churning devices) held to
the port's rows at a small size.

Inputs come from numpy seeds.  Tolerance: exact (integer sums, dyadic
float32 maxima).
"""
import numpy as np
import pytest

import chip_smoke
from test_torch_partition import _both

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager

_EXT = [c for c in chip_smoke.P3_CASES if c[0].startswith("purge")]


@pytest.mark.parametrize("name,ql,qname,sends,want", _EXT,
                         ids=[c[0] for c in _EXT])
def test_partition_ext_purge_cases(name, ql, qname, sends, want):
    assert len(_EXT) == 2
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


def test_purge_recycles_pattern_slots_allocator():
    """The pattern case's allocator: 16 keys, then one after the idle
    period (15 purged), 13 new ones reuse the freed slots."""
    ql = chip_smoke.P3_CASES[[c[0] for c in chip_smoke.P3_CASES].index(
        "purge recycles pattern slots")][1]
    sizes = []
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        h = rt.get_input_handler("T")
        qr = rt.query_runtimes["p"]
        got = []
        for ks, ts in ((np.arange(16), 1000), (np.array([0]), 20_000),
                       (np.arange(100, 113), 21_000)):
            h.send_columns([ks.astype(np.int64),
                            np.full(len(ks), 5.0, np.float32),
                            np.ones(len(ks), np.int32)],
                           timestamps=np.full(len(ks), ts, np.int64))
            got.append(len(qr.slot_allocator))
        rt.shutdown()
        sizes.append(got)
    assert sizes[0] == sizes[1] == [16, 1, 14]


KEYED = """
@app:playback
define stream S (k long, v int);
partition with (k of S)
begin
  @capacity(keys='4')
  @purge(enable='true', interval='1 sec', idle.period='3 sec')
  @info(name='q') from S#window.{win}
  select k, sum(v) as s, count() as c insert all events into O;
end;
"""


@pytest.mark.parametrize("win", ["length(3)", "lengthBatch(2)",
                                 "time(10 sec)", "timeBatch(10 sec)"])
def test_keyed_window_slab_reset(win):
    """Key 1 goes idle past the idle period while key 2 stays busy; its
    window restarts empty: no EXPIRED row of its old events, a fresh
    count, and its slot (and window row) goes to a new key."""
    sends = [("S", [[1, 10], [2, 1], [1, 20]], 1000),
             ("S", [[2, 2]], 2500), ("S", [[2, 3]], 4000),
             ("S", [[2, 4]], 5500), ("S", [[3, 7], [1, 5], [2, 5]], 7000),
             ("S", [[1, 6], [3, 8], [1, 7]], 7500),
             ("S", [[2, 9], [4, 1]], 30_000)]
    ev = _both(KEYED.format(win=win), "q", sends)
    cur = [r for _, i, _ in ev for _, r in i]
    assert cur


def test_recycled_slot_does_not_leak_aggregates():
    """Key 1's group slot is purged and taken by key 9, the next new key:
    key 9's sum starts from its own value, and key 1 coming back starts
    again too."""
    ql = """
    @app:playback
    define stream S (key long, v int);
    partition with (key of S)
    begin
      @purge(enable='true', interval='1 sec', idle.period='5 sec')
      @info(name='q') from S select key, sum(v) as total, max(v) as m
      insert into Out;
    end;
    """
    sends = [("S", [[1, 10], [1, 5]], 1000), ("S", [[2, 1]], 30_000),
             ("S", [[9, 3]], 30_500), ("S", [[1, 7], [9, 4]], 31_000)]
    ev = _both(ql, "q", sends)
    rows = [r for _, i, _ in ev for _, r in i]
    assert rows[-2:] == [(1, 7, 7), (9, 7, 4)], rows


@pytest.mark.parametrize("enable", ["false", "true"])
def test_enable(enable):
    ql = f"""
    @app:playback
    define stream S (key long, v int);
    partition with (key of S)
    begin
      @purge(enable='{enable}', interval='1 sec', idle.period='5 sec')
      @info(name='q') from S select key, sum(v) as total insert into Out;
    end;
    """
    sends = [("S", [1, 10], 1000), ("S", [1, 5], 1100),
             ("S", [2, 1], 30_000), ("S", [1, 7], 31_000)]
    ev = _both(ql, "q", sends)
    assert ev[-1][1][0][1] == ((1, 22) if enable == "false" else (1, 7))


def test_chip_smoke_pg1_model(monkeypatch):
    """chip_smoke.py's PG1 at a small size (256 readings a send over ids
    [16 i, 16 i + 1024), idle.period 30 s): both packages give the same
    events, and PG1Model, which forgets a device idle past the period,
    accepts every row the port delivers; the allocator holds exactly the
    devices the model still remembers."""
    for k, v in (("PG1_B", 256), ("PG1_SHIFT", 16), ("PG1_SPAN", 1024)):
        monkeypatch.setattr(chip_smoke, k, v)
    ql = chip_smoke.PG1_QL.replace("2097152", "4096")
    rng = np.random.default_rng(11)
    raw = [chip_smoke.pg1_send(np, rng, i) for i in range(40)]
    _both(ql, "pg1", [("TempStream", tuple(c), ts) for c, ts in raw])
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    got = []
    rt.add_batch_callback("pg1", lambda ts, b: got.append(b))
    rt.start()
    h = rt.get_input_handler("TempStream")
    model = chip_smoke.PG1Model(np, 16 * 40 + 1024, chip_smoke.PG1_IDLE)
    purged = []
    for i, (cols, ts) in enumerate(raw):
        got.clear()
        h.send_columns(cols, timestamps=ts)
        steps = [b for b in got if b["n_valid"]]
        assert len(steps) == 1
        purged.append(model.step(cols, ts, steps[0], f"PG1 send {i}"))
    held = len(rt.query_runtimes["pg1"].planned.slot_allocator)
    rt.shutdown()
    assert sum(purged) > 100
    assert held == int((model.last >= 0).sum())
