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


# -- the kernel's two modes: their edges through both packages ---------------

EDGE = """
@app:playback
define stream S (k string, i int, f float, l long, b bool, e float);
@info(name='q') from S#window.lengthBatch({n})
select k, i, f, l, b {clause} insert all events into Out;
"""


def _edge_sends(n, batches, seed=11):
    """`batches` sends of n rows: ties in every key, NaN, -0.0, int and
    long nulls; `e` the same in every row."""
    rng = np.random.default_rng(seed)
    sends = []
    for s in range(batches):
        f = (rng.integers(-20, 20, n) / 4).astype(np.float32)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        i = rng.integers(-5, 5, n).astype(np.int32)
        i[rng.random(n) < 0.05] = np.iinfo(np.int32).min
        lv = rng.integers(-3, 3, n).astype(np.int64) * (1 << 40)
        lv[rng.random(n) < 0.05] = np.iinfo(np.int64).min

        def data(m, _f=f, _i=i, _l=lv, _s=s):
            return [np.array([m.interner.intern(f"k{x % 7}")
                              for x in range(n)], np.int32), _i, _f, _l,
                    (np.arange(n) + _s) % 3 == 0,
                    np.full(n, 2.5, np.float32)]
        sends.append((data, 1000 + s + np.arange(n, dtype=np.int64) // n))
    return sends


M = order_limit.TOPK_MAX
MODE_EDGES = [
    ("order by f limit 1", "m = 1"),
    (f"order by f desc limit {M}", "m = M (top-k)"),
    (f"order by f desc limit {M} offset 1", "m = M + 1 (sort)"),
    ("order by i offset 700", "offset past the valid count"),
    ("order by i limit 20 offset 600", "top-k offset past the valid count"),
    ("order by i limit 0", "limit 0"),
    ("order by f, i desc limit 30 offset 2", "two keys, one word"),
    ("order by l desc, i, b limit 40", "three keys, two words"),
    ("order by l desc, f desc, i", "three keys, sort"),
    ("order by l limit 10", "an int64 key"),
]


@pytest.mark.parametrize("clause", [c for c, _ in MODE_EDGES],
                         ids=[w for _, w in MODE_EDGES])
def test_mode_edges_through_both_packages(clause):
    """The plain version at K13's mode edges against the JAX package:
    two flushes of 300 rows (the second also emits the first as EXPIRED
    rows, 600 ordered in all)."""
    got = both(EDGE.format(n=300, clause=clause), _edge_sends(300, 2),
               cols=True)
    empty = "limit 0" in clause or "offset 6" in clause or \
        "offset 7" in clause
    assert (sum(len(i) + len(o) for i, o in got) == 0) == empty


def test_every_key_equal_over_thousands_of_rows():
    """3,000 rows whose order key is one value: the offset and limit cut
    the rows in arrival order (rows 5-14)."""
    ql = EDGE.format(n=3000, clause="order by e limit 10 offset 5") \
        .replace("select k, i, f, l, b", "select k, i, f, l, b, e")
    got = both(ql, _edge_sends(3000, 1), cols=True)
    ks = [r[0] for i, _ in got for r in i]
    assert ks == [f"k{x % 7}" for x in range(5, 15)]


@pytest.mark.parametrize("n,lo,limit,want", [
    (2_097_153, 0, 10, ("topk", 16)),
    (1000, 0, 1, ("topk", 1)),
    (1000, 0, M, ("topk", M)),
    (1000, 1, M, ("sort", 0)),
    (1000, M, None, ("sort", 0)),
    (1000, 5, 0, ("none", 0)),
    (0, 0, 10, ("none", 0)),
    (1000, 700, 20, ("sort", 0)),
])
def test_mode_from_rows_offset_and_limit(n, lo, limit, want):
    """The wrapper's choice: top-k when a limit is given and offset +
    limit <= TOPK_MAX (K the power of two at or above it), sort
    otherwise, nothing for an empty output."""
    assert order_limit.mode(n, lo, limit) == want


def test_keys_composed_into_words_and_passes():
    """Consecutive keys share a 64-bit word while their widths fit (the
    first key most significant); sort mode's passes run the last word
    first, 8 bits a pass; top-k's blocks and the level after them."""
    f32, i32, i64, b = torch.float32, torch.int32, torch.int64, torch.bool
    assert order_limit.compose([f32, i32]) == ([(0, 32), (0, 0)], [64])
    assert order_limit.compose([i64, i32, b]) == \
        ([(0, 0), (1, 1), (1, 0)], [64, 33])
    assert order_limit.compose([b, b, f32]) == \
        ([(0, 33), (0, 32), (0, 0)], [34])
    assert order_limit.passes([64, 33]) == \
        [(1, 0), (1, 8), (1, 16), (1, 24), (1, 32)] + \
        [(0, 8 * k) for k in range(8)]
    assert order_limit.topk_grids(2_097_153, 16) == (256, 1)
    assert order_limit.topk_grids(2_097_153, 256) == (256, 4)
    assert order_limit.topk_grids(100, 16) == (1, 1)


@pytest.mark.parametrize("keys", [
    [(torch.float32, True)], [(torch.float32, False), (torch.int32, True)],
    [(torch.int64, True), (torch.int32, False), (torch.bool, True)],
])
def test_composed_words_order_as_the_reference_loop(keys):
    """The lexicographic order of the composed words (each key's
    order-preserving bits, as the kernel makes them), then the row index,
    is the order of the reference's chain of stable argsorts (the plain
    version's)."""
    rng = np.random.default_rng(len(keys))
    N = 400
    cols = []
    for dt, _ in keys:
        if dt == torch.float32:
            c = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.0, np.inf,
                                     -np.inf], np.float32), N)
        elif dt == torch.bool:
            c = rng.random(N) < 0.5
        else:
            info = np.iinfo(np.int64 if dt == torch.int64 else np.int32)
            c = rng.choice(np.array([info.min, -1, 0, 3, info.max],
                                    info.dtype), N)
        cols.append(torch.from_numpy(c))
    valid = torch.ones(N, dtype=torch.bool)
    ts = torch.arange(N, dtype=torch.int64)
    kk = [(c, d) for c, (_, d) in zip(cols, keys)]
    want = order_limit.plain(kk, 0, None, ts, torch.zeros(N, dtype=torch.int32),
                             valid, ())[0].tolist()

    def bits(c, desc):
        x = c.numpy()
        if x.dtype == np.bool_:
            v = x.astype(np.uint64)
            return 1 - v if desc else v
        if x.dtype == np.float32:
            f = -x if desc else x
            f = np.where(f == 0, np.float32(0), f)
            u = np.where(np.isnan(f), np.uint32(0x7fc00000),
                         f.view(np.uint32)).astype(np.uint32)
            return np.where(u >> 31, ~u, u | np.uint32(1 << 31)) \
                .astype(np.uint64)
        sign = 1 << (8 * x.dtype.itemsize - 1)
        v = (0 - x) if desc else x
        return (v.view(np.uint64 if x.dtype == np.int64 else np.uint32)
                ^ np.array(sign, v.view(np.uint64 if x.dtype == np.int64
                                        else np.uint32).dtype)) \
            .astype(np.uint64)
    where, widths = order_limit.compose([dt for dt, _ in keys])
    words = [np.zeros(N, np.uint64) for _ in widths]
    for (w, sh), (c, d) in zip(where, kk):
        words[w] |= bits(c, d) << np.uint64(sh)
    order = sorted(range(N), key=lambda r: tuple(int(w[r]) for w in words)
                   + (r,))
    assert order == want
