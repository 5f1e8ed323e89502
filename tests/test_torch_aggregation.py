"""The port's incremental aggregations (`siddhi_tpu_torch/core/
aggregation.py`, the plain versions of K27 `agg_base` and K28
`agg_merge`) against the JAX package.

Whole apps run through both packages and are compared exactly: every
duration's `snapshot_rows` (all buckets, in the allocator's order), the
on-demand reads (`within` / `per`, re-aggregated, filtered) and the
events of joins against an aggregation.  The apps are those of
`tests/test_aggregation.py`, `test_aggregation_corpus.py` and the
in-scope ones of `test_aggregation_ext.py` (out-of-order merges, columnar
against per-event sends, the retention purge and a recycled slot).  Then
K27's and K28's plain versions are held to the JAX `step` and `merge` on
seeded numpy inputs: every null kind, +-inf, -0.0, slot -1, empty and
TIMER-only batches, and sums whose value depends on their order.  Then a
mid-stream state carried across with `convert.aggregation_from_jax`, and
the out-of-scope forms, which raise naming their ROADMAP item.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.exceptions import CompileError
from siddhi_tpu_torch.kernels import agg_base, agg_merge

T0 = 1590969600000  # 2020-06-01 00:00:00 UTC
DAY = '"2020-06-01 00:00:00", "2020-06-02 00:00:00"'

TRADES = ("define stream Trades (symbol string, price double, volume long, "
          "ts long);\n")


def _agg_app(select, extra="", group="group by symbol",
             durations="seconds...days", ann=""):
    return (TRADES + f"{ann}\ndefine aggregation A\nfrom Trades{extra}\n"
            f"select symbol, {select}\n{group}\naggregate by ts every "
            f"{durations};\n")


def _drive(mgr, ql, sends, queries=(), join=None):
    """Run one app: (each duration's snapshot rows, the on-demand
    results' data, the join's (ts, data) events)."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    if join is not None:
        rt.add_callback(join, lambda ts, ins, outs: got.extend(
            (e.timestamp, tuple(e.data)) for e in ins or []))
    rt.start()
    for stream, rows, ts in sends:
        if isinstance(rows, dict):
            rt.get_input_handler(stream).send_columns(rows["cols"],
                                                      rows["ts"])
        else:
            rt.get_input_handler(stream).send(rows, timestamp=ts)
    rt.flush()
    snaps = {}
    for aid, agg in rt.aggregations.items():
        for dur in agg.durations:
            ts, cols = agg.snapshot_rows(dur, None)
            snaps[(aid, dur)] = [np.asarray(ts)] + [np.asarray(c)
                                                    for c in cols]
    ond = [[tuple(e.data) for e in rt.query(q)] for q in queries]
    mgr.shutdown()
    return snaps, ond, got


def both(ql, sends, queries=(), join=None, strings=()):
    """The two packages' results, compared exactly (NaN equal to NaN);
    `strings` are the positions (in the snapshot's [bucket ts,
    AGG_TIMESTAMP, outputs...] columns) of STRING group attributes,
    compared decoded."""
    jm, tm = JaxManager(), TorchManager(device="cpu")
    js, jq, jg = _drive(jm, ql, sends, queries, join)
    ts_, tq, tg = _drive(tm, ql, sends, queries, join)
    assert js.keys() == ts_.keys()
    for k in js:
        a, b = js[k], ts_[k]
        assert len(a) == len(b), k
        for j, (x, y) in enumerate(zip(a, b)):
            if j in strings:
                x = [jm.interner.lookup(int(v)) for v in x]
                y = [tm.interner.lookup(int(v)) for v in y]
                assert x == y, (k, j)
                continue
            assert x.dtype == y.dtype, (k, j, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{k} col {j}")
    assert jq == tq
    assert jg == tg
    return ts_, tq, tg


def _trades(rows):
    return [("Trades", [list(r)], None) for r in rows]


# -- the apps of tests/test_aggregation*.py ---------------------------------

def test_buckets_and_rollups():
    ql = _agg_app("avg(price) as avgPrice, sum(volume) as total",
                  durations="seconds...years")
    sends = _trades([("IBM", 100.0, 10, T0), ("IBM", 200.0, 20, T0 + 500),
                     ("IBM", 300.0, 30, T0 + 2000),
                     ("WSO2", 50.0, 5, T0 + 1000)])
    snaps, ond, _ = both(ql, sends, [
        f'from A within {DAY} per "days" select *',
        'from A within "2020-01-01 00:00:00", "2021-01-01 00:00:00" '
        'per "years" select *'], strings=(2,))
    assert len(snaps[("A", "SECONDS")][0]) == 3
    assert ond[0][0][2:] == (200.0, 60)


def test_join_within_per():
    ql = TRADES + """
    define stream Req (symbol string);
    define aggregation TradeAgg
    from Trades
    select symbol, sum(volume) as total
    group by symbol
    aggregate by ts every seconds...days;
    @info(name='lookup')
    from Req join TradeAgg
      on Req.symbol == TradeAgg.symbol
      within "2020-06-01 00:00:00", "2020-06-02 00:00:00"
      per "days"
    select TradeAgg.symbol as symbol, TradeAgg.total as total
    insert into Out;
    """
    sends = _trades([("IBM", 100.0, 10, T0),
                     ("IBM", 110.0, 15, T0 + 3_600_000),
                     ("WSO2", 50.0, 5, T0)])
    sends += [("Req", [["IBM"]], T0 + 4_000_000),
              ("Req", [["WSO2"], ["IBM"], ["none"]], T0 + 4_000_001)]
    _, _, got = both(ql, sends, join="lookup", strings=(2,))
    assert [g[1] for g in got] == [("IBM", 25), ("WSO2", 5), ("IBM", 25)]


def test_join_per_seconds_within_range_and_outer():
    """A per-seconds join over a range, a left outer join and a join with
    a condition on the buckets' columns: the candidates come in the
    buckets' order."""
    ql = TRADES + """
    define stream Req (symbol string, lo long);
    define aggregation A from Trades
    select symbol, sum(volume) as total, max(price) as hi group by symbol
    aggregate by ts every seconds...hours;
    @info(name='j1')
    from Req join A on Req.symbol == A.symbol and A.total > Req.lo
      within 1590969600000L, 1590969605000L per "seconds"
    select A.AGG_TIMESTAMP as bucket, A.symbol as symbol, A.total as total,
           A.hi as hi
    insert into Out1;
    @info(name='j2')
    from Req left outer join A on Req.symbol == A.symbol
      within 1590969600000L, 1590969603000L per "seconds"
    select Req.symbol as symbol, A.total as total insert into Out2;
    """
    rows = [("IBM", 1.0 + i, 10 * i, T0 + 700 * i) for i in range(9)]
    rows += [("WSO2", 2.0, 3, T0 + 100), ("ORCL", 5.0, 7, T0 + 4100)]
    sends = _trades(rows) + [
        ("Req", [["IBM", 5], ["WSO2", 0], ["MSFT", 0]], T0 + 10_000)]
    both(ql, sends, join="j1", strings=(2,))
    both(ql, sends, join="j2", strings=(2,))


def test_min_max_count_rollup():
    ql = _agg_app("min(price) as lo, max(price) as hi, count() as n")
    sends = _trades([("IBM", 100.0, 1, T0), ("IBM", 50.0, 1, T0 + 100),
                     ("IBM", 300.0, 1, T0 + 61_000)])
    _, ond, _ = both(ql, sends, [
        f'from A within {DAY} per "minutes" select *',
        f'from A within {DAY} per "days" select *'], strings=(2,))
    assert len(ond[0]) == 2 and ond[1][0][2:5] == (50.0, 300.0, 3)


def test_filtered_source_feeds_aggregation():
    ql = _agg_app("sum(volume) as total", extra="[price > 10.0]")
    sends = _trades([("IBM", 100.0, 7, T0), ("IBM", 5.0, 1000, T0 + 10),
                     ("IBM", 20.0, 3, T0 + 20)])
    _, ond, _ = both(ql, sends, [f'from A within {DAY} per "days" '
                                 f'select *'], strings=(2,))
    assert ond[0][0][2] == 10


def test_multi_group_keys():
    ql = """
    define stream Trades (symbol string, side string, volume long, ts long);
    define aggregation A
    from Trades
    select symbol, side, sum(volume) as total
    group by symbol, side
    aggregate by ts every seconds...days;
    """
    sends = [("Trades", [[s, sd, v, T0]], None) for s, sd, v in (
        ("IBM", "buy", 1), ("IBM", "sell", 2), ("IBM", "buy", 4),
        ("WSO2", "buy", 8))]
    _, ond, _ = both(ql, sends, [f'from A within {DAY} per "days" '
                                 f'select *'], strings=(2, 3))
    assert {(r[1], r[2]): r[3] for r in ond[0]} == {
        ("IBM", "buy"): 5, ("IBM", "sell"): 2, ("WSO2", "buy"): 8}


def test_within_bounds_exclude_outside_buckets():
    ql = _agg_app("sum(volume) as total")
    sends = _trades([("IBM", 1.0, 10, T0),
                     ("IBM", 1.0, 20, T0 + 86_400_000)])
    _, ond, _ = both(ql, sends, [f'from A within {DAY} per "days" '
                                 f'select *'], strings=(2,))
    assert len(ond[0]) == 1 and ond[0][0][2] == 10


def test_avg_weighted_and_ondemand_reaggregation():
    ql = _agg_app("avg(price) as ap, sum(volume) as total")
    sends = _trades([("IBM", 10.0, 1, T0), ("IBM", 20.0, 1, T0 + 10),
                     ("IBM", 90.0, 1, T0 + 61_000)] +
                    [("IBM", 1.0, 10, T0 + i * 1000) for i in range(5)])
    _, ond, _ = both(ql, sends, [
        f'from A within {DAY} per "days" select *',
        f'from A within {DAY} per "seconds" select sum(total) as grand',
        f'from A within {DAY} per "seconds" on total > 10L select *',
        f'from A within {DAY} per "minutes" select symbol, max(ap) as m '
        f'group by symbol'], strings=(2,))
    assert ond[1][0][0] == 53


def test_nulls_and_types():
    """Null prices, volumes and sides contribute the identity and leave
    an all-null bucket null; int and long arguments sum as LONG, a float
    argument's min keeps its type; a NaN from 0.0 / 0.0 is a null."""
    ql = """
    define stream S (k string, i int, l long, f float, d double, ts long);
    define aggregation A from S
    select k, sum(i) as si, min(i) as mi, sum(l) as sl, max(l) as xl,
           avg(f) as af, min(f) as mf, sum(d) as sd, max(d / 0.0) as dz,
           avg(d * 2.0) as ad, count() as n
    group by k aggregate by ts every seconds...minutes;
    """
    rows = [("a", 1, 10, 1.5, 2.5, T0), ("a", None, None, None, None, T0),
            ("b", None, None, None, None, T0 + 5),
            ("a", -7, 2**40, -0.0, float("inf"), T0 + 1200),
            ("b", 3, -5, float("-inf"), 0.0, T0 + 1300),
            ("c", 2**31 - 1, 2**53 + 1, 3.25, -1e30, T0 + 61_000)]
    sends = [("S", [list(r)], None) for r in rows]
    both(ql, sends, [f'from A within {DAY} per "minutes" select *'],
         strings=(2,))


def test_group_by_numeric_keys():
    """Float and long group attributes round-trip through their key
    bits."""
    ql = """
    define stream S (g double, h long, v int, ts long);
    define aggregation A from S select g, h, sum(v) as s
    group by g, h aggregate by ts every seconds...hours;
    """
    rows = [(1.5, 7, 1, T0), (-0.0, 7, 2, T0), (0.0, 7, 4, T0),
            (1.5, -3, 8, T0 + 3_600_000), (float("nan"), 2, 16, T0)]
    both(ql, [("S", [list(r)], None) for r in rows],
         [f'from A within {DAY} per "hours" select *'])


def test_out_of_order_events_merge_into_past_buckets():
    ql = _agg_app("avg(price) as avgPrice, sum(volume) as total, "
                  "min(price) as lo, max(price) as hi")
    sends = _trades([("IBM", 100.0, 10, T0 + 5000), ("IBM", 200.0, 20, T0),
                     ("IBM", 300.0, 30, T0 + 5200),
                     ("IBM", 400.0, 40, T0 + 900)])
    snaps, _, _ = both(ql, sends, strings=(2,))
    sec = snaps[("A", "SECONDS")]
    assert list(sec[0]) == [T0 + 5000, T0]
    assert (sec[3][1], sec[4][1], sec[5][1], sec[6][1]) == (300.0, 60,
                                                            200.0, 400.0)


def test_columnar_and_per_event_sends():
    """send_columns of 120 trades over 30 seconds, and the same trades
    event by event in a second app."""
    rng = np.random.default_rng(7)
    n = 120
    cols = {"cols": [np.zeros(n, np.int32),
                     rng.uniform(1, 100, n).astype(np.float32),
                     rng.integers(1, 50, n).astype(np.int64),
                     (T0 + rng.integers(0, 30, n) * 1000).astype(np.int64)],
            "ts": None}
    ql = _agg_app("avg(price) as avgPrice, sum(volume) as total, "
                  "min(price) as lo, max(price) as hi")
    # interned id 0 is the first string each package interns
    snaps, _, _ = both(ql, [("Trades", [["A", 1.0, 1, T0 - 1000]], None),
                            ("Trades", cols, None)], strings=(2,))
    per_event = [("Trades", [["A", float(p), int(v), int(t)]], None)
                 for p, v, t in zip(*cols["cols"][1:])]
    snaps2, _, _ = both(ql, [("Trades", [["A", 1.0, 1, T0 - 1000]], None)] +
                        per_event, strings=(2,))
    for k in snaps:
        for x, y in zip(snaps[k], snaps2[k]):
            np.testing.assert_array_equal(x, y)


def test_retention_purge_frees_and_recycles_slots():
    ql = _agg_app("avg(price) as avgPrice, sum(volume) as total")

    def drive(mgr):
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        h = rt.get_input_handler("Trades")
        h.send(["IBM", 100.0, 10, T0])
        h.send(["IBM", 100.0, 10, T0 + 400_000])
        agg = rt.aggregations["A"]
        n0 = len(agg._dstores["SECONDS"].alloc)
        agg.purge_old(T0 + 400_000)
        n1 = len(agg._dstores["SECONDS"].alloc)
        h.send(["WSO2", 1.0, 1, T0 + 401_000])
        out = [n0, n1, len(agg._dstores["SECONDS"].alloc)]
        # decode_keys: the same slots and key words in the same order
        out.append(agg._dstores["SECONDS"].decode_keys()[0].tolist())
        for dur in agg.durations:
            ts, cols = agg.snapshot_rows(dur, None)
            out.append([np.asarray(ts)] + [np.asarray(c) for c in cols[2:]])
        mgr.shutdown()
        return out
    a, b = drive(JaxManager()), drive(TorchManager(device="cpu"))
    assert a[:3] == b[:3] == [2, 1, 2]
    assert a[3] == b[3]
    for x, y in zip(a[4:], b[4:]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_purge_timer_under_playback():
    """@app:playback: the purge timer runs from the app's construction
    at 0 + interval; seconds buckets past 120 s go, their slots recycle,
    and @retentionPeriod / @purge(interval) are read."""
    ql = ("@app:playback\n" + TRADES +
          "@purge(enable='true', interval='10 sec')\n"
          "@retentionPeriod(sec='30 sec', min='all')\n"
          "define aggregation A from Trades select symbol, sum(volume) as t "
          "group by symbol aggregate by ts every seconds, minutes;\n")
    sends = [("Trades", [[f"s{i % 3}", 1.0, i, i * 1000]], i * 1000)
             for i in range(0, 95, 4)]
    snaps, _, _ = both(ql, sends, strings=(2,))
    assert len(snaps[("A", "SECONDS")][0]) < 24


@pytest.mark.parametrize("within", [
    ("2020-06-01 00:00:00", "2020-06-02 00:00:00"), ("2020-06-01",
                                                    "2020-07"),
    ("2019-12-31 23:59:59", "2020-**"), (1000, 5000)])
def test_within_per_and_buckets_equal_the_jax_parsing(within):
    """`parse_within`, `parse_per` and `truncate_buckets` (months and
    years by the calendar) give the JAX package's values."""
    from siddhi_tpu.core import aggregation as jagg
    from siddhi_tpu.query_api.expression import Constant as JC
    from siddhi_tpu_torch.core import aggregation as tagg
    from siddhi_tpu_torch.query_api.expression import Constant as TC

    def const(C, v):
        return C(v, "LONG") if isinstance(v, int) else C(v, "STRING")
    assert tagg.parse_within(tuple(const(TC, v) for v in within)) == \
        jagg.parse_within(tuple(const(JC, v) for v in within))
    for per in ("sec", "minutes", "HOURS", "day", "months", "year"):
        assert tagg.parse_per(TC(per, "STRING")) == \
            jagg.parse_per(JC(per, "STRING"))
    ts = np.array([0, T0 - 1, T0, T0 + 86_400_000 * 45, 1709251199999,
                   1709251200000], np.int64)
    for dur in tagg.DURATION_MS.keys() | {"MONTHS", "YEARS"}:
        np.testing.assert_array_equal(tagg.truncate_buckets(ts, dur),
                                      jagg.truncate_buckets(ts, dur))


# -- K27 / K28 plain versions against the JAX step and merge -----------------

STEP_APP = chip_smoke.AGX_QL


def _runtimes():
    jrt = JaxManager().create_siddhi_app_runtime(STEP_APP)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(STEP_APP)
    ja, ta = jrt.aggregations["A"], trt.aggregations["A"]
    assert [b.kind for b in ja.base] == ta.kinds
    return ja, ta


@pytest.mark.parametrize("B,n_valid,timer_only", [
    (1024, 1000, False), (64, 0, False), (16, 16, True), (512, 512, False)])
def test_agg_base_plain_equals_jax_step(B, n_valid, timer_only):
    import jax.numpy as jnp
    ja, ta = _runtimes()
    rng = np.random.default_rng(B + n_valid)
    ts, kind, valid, cols = chip_smoke.agx_batch(
        np, rng, B, n_valid, ev, ev.TIMER if timer_only else None)
    jkeep, jvals = ja._step(jnp.asarray(ts), jnp.asarray(kind),
                            jnp.asarray(valid),
                            tuple(jnp.asarray(c) for c in cols),
                            jnp.asarray(T0, jnp.int64))
    staged = ev.StagedBatch(ts, kind, valid, cols, B)
    batch = staged.to_device(ta.in_schema, torch.device("cpu"))
    keep, vals = agg_base.plain(ta.spec, batch, T0)
    np.testing.assert_array_equal(np.asarray(jkeep), keep.numpy())
    np.testing.assert_array_equal(np.asarray(jvals), vals.numpy())


def test_value_bytecode_equals_the_compiled_arguments():
    """K27's argument bytecode (`compile_value`, read as a value by the
    plain interpreter) against the compiled torch expressions it stands
    for, nulls included, bit for bit."""
    from siddhi_tpu_torch.kernels.filter_bytecode import compile_value, \
        interpret
    _, ta = _runtimes()
    rng = np.random.default_rng(9)
    ts, kind, valid, cols = chip_smoke.agx_batch(np, rng, 512, 512, ev)
    batch = ev.StagedBatch(ts, kind, valid, cols, 512).to_device(
        ta.in_schema, torch.device("cpu"))
    env = {ta.input_stream_id: tuple(batch.cols), "__ts__": batch.ts,
           "__now__": 0}
    n = 0
    for b in ta.base:
        if b.expr is None:
            continue
        code, _, _ = compile_value(b.expr, ta._scope, ta.input_stream_id)
        got = interpret(code, lambda c: batch.cols[c], None, value=True)
        want = b.src.fn(env)
        assert got.dtype == want.dtype
        if got.dtype == torch.float32:
            # a NaN is the null: its bits are free, its place is not
            nan = torch.isnan(got)
            assert torch.equal(nan, torch.isnan(want))
            got, want = got[~nan].view(torch.int32), \
                want[~nan].view(torch.int32)
        assert torch.equal(got, want)
        n += 1
    assert n >= 5


def _merge_inputs(rng, nb, cap, B, D):
    slab = rng.normal(0, 1e3, (D, nb, cap))
    slab[:, :, rng.random(cap) < 0.1] = np.inf
    slab[:, :, rng.random(cap) < 0.1] = -0.0
    vals = rng.normal(0, 1e16, (nb, B)) * (rng.random((nb, B)) < 0.5) + \
        rng.integers(-3, 3, (nb, B))
    vals[rng.random((nb, B)) < 0.05] = -np.inf
    vals[rng.random((nb, B)) < 0.05] = np.inf
    vals[rng.random((nb, B)) < 0.05] = -0.0
    slots = rng.integers(-1, max(cap // 4, 2), (D, B)).astype(np.int32)
    return slab, vals, slots


@pytest.mark.parametrize("B,cap,seed", [(256, 64, 1), (2048, 16, 2),
                                        (32, 1024, 3)])
def test_agg_merge_plain_equals_jax_merge(B, cap, seed):
    import jax.numpy as jnp
    ja, ta = _runtimes()
    nb = len(ta.kinds)
    rng = np.random.default_rng(seed)
    slab, vals, slots = _merge_inputs(rng, nb, cap, B, 3)
    # the JAX merge maps slot -1 past its own capacity, which drops it
    # from this smaller slab as well
    want = np.stack([np.asarray(ja._merge(jnp.asarray(slab[d].copy()),
                                          jnp.asarray(slots[d]),
                                          jnp.asarray(vals)))
                     for d in range(3)])
    got = torch.from_numpy(slab.copy())
    agg_merge.plain(got, torch.from_numpy(slots), torch.from_numpy(vals),
                    ta.kinds)
    np.testing.assert_array_equal(want, got.numpy())
    assert np.array_equal(np.signbit(want), np.signbit(got.numpy()))


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 1, 0), (1, 0, 2)])
def test_agg_merge_sum_is_in_row_order(order):
    """One slot, three rows whose f64 sum depends on the order: the
    merge adds them in row order, as XLA's CPU scatter does."""
    v = np.array([1.0, 1e16, -1e16])[list(order)]
    want = 0.0
    for x in v:
        want = want + x
    slab = torch.zeros((1, 1, 4), dtype=torch.float64)
    agg_merge.plain(slab, torch.tensor([[2, 2, 2]], dtype=torch.int32),
                    torch.from_numpy(v[None, :].copy()), ["sum"])
    assert slab[0, 0, 2].item() == want


def test_xla_min_max_signed_zero_and_nan():
    a = torch.tensor([0.0, -0.0, 1.0, float("nan"), 2.0])
    b = torch.tensor([-0.0, 0.0, float("nan"), 1.0, 2.0])
    mn, mx = agg_merge.xla_min(a, b), agg_merge.xla_max(a, b)
    assert torch.signbit(mn[:2]).all() and not torch.signbit(mx[:2]).any()
    assert torch.isnan(mn[2:4]).all() and torch.isnan(mx[2:4]).all()
    assert mn[4] == mx[4] == 2.0


# -- a state carried across mid-stream ---------------------------------------

def test_aggregation_from_jax_mid_stream():
    ql = _agg_app("avg(price) as ap, sum(volume) as total, min(price) as "
                  "lo, count() as n", durations="seconds...months")
    jm, tm = JaxManager(), TorchManager(device="cpu")
    jrt = jm.create_siddhi_app_runtime(ql)
    trt = tm.create_siddhi_app_runtime(ql)
    jrt.start()
    trt.start()
    rng = np.random.default_rng(3)
    first = [("IBM", float(rng.uniform(1, 9)), int(rng.integers(1, 9)),
              T0 + int(rng.integers(0, 50)) * 1000) for _ in range(40)]
    for r in first:
        jrt.get_input_handler("Trades").send(list(r))
    # both packages intern the same strings in the same order from here
    tm.interner.intern("IBM")
    convert.aggregation_from_jax(jrt.aggregations["A"], trt.aggregations["A"])
    later = [(("IBM", "WSO2")[i % 2], float(rng.uniform(1, 9)),
              int(rng.integers(1, 9)), T0 + int(rng.integers(0, 90)) * 1000)
             for i in range(40)]
    for rt in (jrt, trt):
        for r in later:
            rt.get_input_handler("Trades").send(list(r))
    for dur in trt.aggregations["A"].durations:
        jts, jc = jrt.aggregations["A"].snapshot_rows(dur, None)
        tts, tc = trt.aggregations["A"].snapshot_rows(dur, None)
        np.testing.assert_array_equal(np.asarray(jts), tts)
        for x, y in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(x), y)
    jm.shutdown()
    tm.shutdown()


# -- what raises --------------------------------------------------------------

@pytest.mark.parametrize("ql,item", [
    (_agg_app("sum(volume) as t", ann="@store(type='memory')"), "A15"),
    (_agg_app("custom:agg(price) as c"), "A4"),
])
def test_out_of_scope_forms_raise(ql, item):
    with pytest.raises(CompileError, match=f"ROADMAP {item}"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_partitioned_join_against_an_aggregation():
    """A partitioned join whose other side is an aggregation: the
    aggregation is shared by the keys (no partition key column), as in
    the reference."""
    ql = TRADES + """
    define stream Req (symbol string);
    define aggregation A from Trades select symbol, sum(volume) as total
    group by symbol aggregate by ts every seconds...days;
    partition with (symbol of Req)
    begin
      @info(name='q')
      from Req join A on Req.symbol == A.symbol
        within "2020-06-01 00:00:00", "2020-06-02 00:00:00" per "days"
      select A.symbol as symbol, A.total as total insert into Out;
    end;
    """
    sends = _trades([("IBM", 1.0, 10, T0), ("WSO2", 1.0, 5, T0)]) + [
        ("Req", [["IBM"], ["WSO2"]], T0 + 10)]
    both(ql, sends, join="q", strings=(2,))


# -- chip_smoke's AG1 / AGJ1 checks at a small size ---------------------------

def test_chip_smoke_ag1_at_a_small_size(monkeypatch):
    """chip_smoke.run_ag1's numpy model (every retained second and every
    minute, AGJ1's rows and counts, the on-demand read per hours) held to
    the port's plain path at 64 symbols."""
    monkeypatch.setattr(chip_smoke, "check_launched", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda *a: {
        "wall_ms": 0.0, "device_ms": None, "idle_share": None, "top": []})
    chip_smoke.run_ag1(torch, np, torch.device("cpu"), sends=20, syms=64,
                       B=1024, cap=4096)
