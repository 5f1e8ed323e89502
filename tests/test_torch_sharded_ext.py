"""Sharding over the key axis (A14) through the port, held to the JAX
package: keyed windows kept per partition key on K11 (`length`, `time`,
and `timeBatch`, which stays unsharded in both packages) and a keyed
window's purge remap, the shapes of `tests/test_sharded_ext.py`, each on
the JAX package's `Mesh(devs[:n])` and the port's `ShardMesh([cpu] * n)`,
n in {8, 4}, compared exactly and in order, and with the port's unsharded
run, sorted; the keyed `min` / `max` and `expression` windows the JAX
package cannot run on a mesh.  `test_torch_sharded_plain.py` holds the
windowless group-by, the pattern purge, the join, the aggregation, the
shard decisions and the state carry.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.sharding import ShardMesh

from test_torch_sharded import both, drive, flat


def keyed_app(window, extra=""):
    return f"""
@app:playback
define stream S (key long, price float, volume int);
partition with (key of S)
begin
  @capacity(keys='64')
  {extra}
  @info(name='q')
  from S#window.{window}
  select key, sum(price) as sp, count() as c
  insert into Out;
end;
"""


PURGE = "@purge(enable='true', interval='1 sec', idle.period='1 sec')"


def random_feeds(seed, sends=6, rows=40, keys=24):
    rng = np.random.default_rng(seed)
    return [("S", [[int(rng.integers(0, keys)),
                    float(rng.integers(-4, 9)) * 0.5,
                    int(rng.integers(1, 4))] for _ in range(rows)],
             1000 * (s + 1)) for s in range(sends)]


def purge_feeds():
    return [("S", [[k, 10.0, 1] for k in range(12)], 1_000),
            ("S", [[k, 20.0, 2] for k in range(12)], 1_100),
            ("S", [[99, 1.0, 3]], 30_000),
            ("S", [[k, 5.0, 2] for k in range(12)], 31_000)]



def timebatch_feeds():
    return [("S", [[k, float(k + 1), 1] for k in range(12)], 1_000),
            ("S", [[k, 10.0, 2] for k in range(12)], 1_500),
            ("S", [[0, 1.0, 3]], 2_600),
            ("S", [[k, 2.0, 2] for k in range(12)], 2_700),
            ("S", [[5, 3.0, 2]], 4_000)]



CASES = {
    "keyed_length": (keyed_app("length(2)"), random_feeds(1)),
    "keyed_length_purge": (keyed_app("length(2)", PURGE), purge_feeds()),
    "keyed_time": (keyed_app("time(2 sec)"), random_feeds(2)),
    "keyed_timebatch_unsharded": (keyed_app("timeBatch(1 sec)"),
                                  timebatch_feeds()),
    "keyed_external_time": (keyed_app("externalTime(volume, 2)"),
                            random_feeds(3)),
    "keyed_frequent": (keyed_app("frequent(2, volume)"), random_feeds(4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_run_matches_jax_8(case):
    ql, feeds = CASES[case]
    j, t, u = both(ql, "q", feeds, 8)
    assert t == j
    assert flat(t) == flat(u)
    assert flat(t)


def test_keyed_expression_reference_defect():
    """The JAX package cannot run a keyed `expression` window on a mesh:
    its scan carry turns device-varying inside the shard_map, the step
    fails at every send (the junction logs "error processing") and the
    query emits nothing.  The port's meshed run gives its unsharded run's
    events, in order."""
    ql, feeds = keyed_app("expression('count() <= 3')"), random_feeds(5)
    j, t, u = both(ql, "q", feeds, 4)
    assert j == []
    assert t == u and flat(t)


MAX_APP = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
partition with (deviceID of TempStream)
begin
  @capacity(keys='64')
  @info(name='q')
  from TempStream#window.length(3)
  select roomNo, deviceID, max(temp) as maxTemp, min(temp) as minTemp
  insert into DeviceTempStream;
end;
"""


def test_keyed_min_max_reference_defect():
    """The JAX package's dmerge turns a keyed window's min / max
    accumulator into NaN on a mesh (its identity is +-inf, and old + (new -
    old) is NaN there), so the meshed min / max come out null after a
    key's first step, where its unsharded run gives the extremes.  The
    port's keyed step takes the changed copy where dmerge is undefined:
    its meshed run gives the unsharded events, in order, and agrees with
    the JAX package's meshed run in every other cell."""
    rng = np.random.default_rng(21)
    feeds = [("TempStream", [[int(k), int(k % 97),
                              float(rng.integers(0, 1 << 14)) / 256]
                             for k in rng.integers(0, 16, 24)],
              1000 + 10 * i) for i in range(4)]
    j, t, u = both(MAX_APP, "q", feeds, 4)
    ju = drive(siddhi_tpu.SiddhiManager(), MAX_APP, "q", feeds)
    assert ju == u and t == u
    assert any(r[2] is None for _, cur, _ in j for r in cur)
    for (ts_j, cj, _), (ts_t, ct, _) in zip(j, t):
        assert ts_j == ts_t and len(cj) == len(ct)
        for rj, rt in zip(cj, ct):
            assert all(a is None or a == b for a, b in zip(rj, rt))


def test_purge_resets_every_shard():
    """After the purge sweep every key restarts from its window's and its
    aggregates' identities, on whichever shard it lives."""
    got = drive(siddhi_tpu_torch.SiddhiManager(device="cpu"),
                keyed_app("length(2)", PURGE), "q", purge_feeds(),
                ShardMesh(["cpu"] * 4))
    last = {row[0]: row[1] for _, cur, _ in got for row in cur}
    assert all(last[k] == 5.0 for k in range(12))


