"""`order by` / `limit` / `offset` through the port (kernel K13's plain
version, `kernels/order_limit.py`) against the JAX package.

Whole apps run through both packages (events exact; the float sums here
are of small integers, exact in any order): the six clauses of
`tests/test_table_corpus.py::test_batch_order_limit` on a streaming
query, a two-key order, ties, -0.0 / +0.0, NaN and int nulls under ASC
and DESC, a limit that counts EXPIRED rows before the output type's cut,
and the Siddhi query guide's Limit & Offset example (timeBatch, group by,
order by a running avg, limit 10) at a few hundred events.  The plain
version is also held to a direct numpy model of the reference's loop.
"""
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.kernels import order_limit


def _run(make, ql, sends, cols=False):
    m = make()
    rt = m.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.append(
        ([tuple(e.data) for e in i or []],
         [tuple(e.data) for e in o or []])))
    rt.start()
    h = rt.get_input_handler("S")
    for data, ts in sends:
        if cols:
            h.send_columns(data(m), timestamps=ts)
        else:
            h.send(data, timestamp=ts)
    rt.flush()
    m.shutdown()
    return got


def both(ql, sends, cols=False):
    j = _run(JaxManager, ql, sends, cols)
    t = _run(lambda: TorchManager(device="cpu"), ql, sends, cols)
    assert t == j
    return t


ORDER_CASES = [
    ("order by v", [1, 2, 3, 9]),
    ("order by v desc", [9, 3, 2, 1]),
    ("order by v limit 2", [1, 2]),
    ("order by v desc limit 1", [9]),
    ("order by v offset 1", [2, 3, 9]),
    ("order by v limit 2 offset 1", [2, 3]),
]


@pytest.mark.parametrize("clause,expected", ORDER_CASES,
                         ids=[c for c, _ in ORDER_CASES])
def test_batch_order_limit(clause, expected):
    ql = f"""
    define stream S (k string, v int);
    @info(name='q') from S#window.lengthBatch(4)
    select k, v {clause} insert into Out;
    """

    def data(m):
        return [np.array([m.interner.intern(x) for x in "abcd"], np.int32),
                np.array([3, 9, 1, 2], np.int32)]
    got = both(ql, [(data, None)], cols=True)
    assert [r[1] for ins, _ in got for r in ins] == expected


SPECIAL = """
@app:playback
define stream S (k string, i int, f float, l long, b bool);
@info(name='q') from S#window.lengthBatch({n})
select k, i, f, l, b {clause} insert all events into Out;
"""

ROWS = [["a", 3, 0.0, 5, True], ["b", None, -0.0, None, False],
        ["c", 3, float("nan"), 7, True], ["d", -4, 2.5, None, None],
        ["e", 2**31 - 1, None, 2**40, False], ["f", 3, -0.0, 5, True],
        ["g", None, float("inf"), -(2**40), True],
        ["h", -4, float("-inf"), 5, False]]


@pytest.mark.parametrize("clause", [
    "order by i", "order by i desc", "order by f", "order by f desc",
    "order by l desc, k", "order by b, i desc", "order by b desc, f",
    "order by k desc", "order by i, f desc limit 5 offset 2",
    "limit 3 offset 6", "order by l limit 20",
])
def test_ties_zeros_nans_nulls(clause):
    """Two batches of 8 (the second flush also emits the first batch as
    EXPIRED rows, which the order and the limit count)."""
    both(SPECIAL.format(n=8, clause=clause),
         [(r, 1000 + j) for j, r in enumerate(ROWS + ROWS[::-1])] +
         [(ROWS[0], 3000)])


def test_limit_counts_expired_rows_under_insert_into():
    """limit 3 over a flush's EXPIRED and CURRENT rows, before `insert
    into` cuts the EXPIRED ones: fewer than 3 CURRENT rows come out."""
    ql = """
    @app:playback
    define stream S (k string, v int);
    @info(name='q') from S#window.lengthBatch(3)
    select k, v order by v desc limit 3 insert into Out;
    """
    got = both(ql, [(["a", 9], 1), (["b", 8], 2), (["c", 7], 3),
                    (["d", 1], 4), (["e", 2], 5), (["f", 10], 6)])
    assert [len(ins) for ins, _ in got] == [3, 1]


W1_QL = """
@app:playback
define stream TempStream (deviceID long, roomNo int, temp double);
@info(name='q') from TempStream#window.timeBatch(10 min)
select avg(temp) as avgTemp, roomNo, deviceID
group by roomNo, deviceID
order by avgTemp desc
limit 10
insert into HighestAvgTempStream;
"""


def test_query_guide_limit_offset_example():
    """The Siddhi 5.1 query guide's Limit & Offset example (W1's QL) at
    40 devices, 4 sends of 80 readings a slice."""
    rng = np.random.default_rng(3)
    sends = []
    for s in range(10):
        ids = rng.integers(0, 40, 80).astype(np.int64)
        temps = rng.integers(15, 35, 80).astype(np.float32)
        ts = (s + 1) * 150_000 + np.arange(80)

        def data(m, _i=ids, _t=temps):
            return [_i, (_i % 10).astype(np.int32), _t]
        sends.append((data, ts))
    ql = W1_QL
    m_j, m_t = JaxManager(), TorchManager(device="cpu")
    outs = []
    for m in (m_j, m_t):
        rt = m.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda ts, i, o: got.append(
            [tuple(e.data) for e in i or []]))
        rt.start()
        h = rt.get_input_handler("TempStream")
        for data, ts in sends:
            h.send_columns(data(m), timestamps=ts)
        rt.flush()
        m.shutdown()
        outs.append(got)
    assert outs[1] == outs[0]
    assert len(outs[0]) >= 2 and all(len(b) <= 10 for b in outs[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_against_numpy_model(seed):
    """The plain version against numpy's stable sorts of the same keys
    (the reference's loop: last key first, DESC negated, invalid last),
    then the limit and offset."""
    rng = np.random.default_rng(seed)
    N = 300
    valid = rng.random(N) < 0.8
    k1 = rng.integers(-3, 3, N).astype(np.int32)
    k2 = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, -2.0], np.float32), N)
    ts = np.arange(N, dtype=np.int64)
    kind = rng.integers(0, 2, N).astype(np.int32)
    keys = [(torch.from_numpy(k1), True), (torch.from_numpy(k2), False)]
    out = order_limit.plain(keys, 7, 50, torch.from_numpy(ts),
                            torch.from_numpy(kind), torch.from_numpy(valid),
                            (torch.from_numpy(k2),))
    idx = np.arange(N)
    for k in (k2, -k1):
        if k.dtype == np.float32:      # NaN after +inf, invalid after NaN
            kk = np.where(valid[idx], np.where(np.isnan(k[idx]), 1e30,
                                               k[idx]), 1e31)
        else:
            kk = np.where(valid[idx], k[idx], np.iinfo(k.dtype).max)
        idx = idx[np.argsort(kk, kind="stable")]
    idx = idx[valid[idx]]
    want = idx[7:57]
    m = want.shape[0]
    assert np.array_equal(out[0][:m].numpy(), ts[want])
    assert out[2][:m].all() and not out[2][m:].any()
