"""`@fuse(batches='K')` in the port (`siddhi_tpu_torch/core/fusion.py`)
against the JAX package (`siddhi_tpu/core/fusion.py`), on the CPU.

Each app runs through both packages from the same seeded sends, and the
events each query delivered are compared after EVERY send (a fused query
delivers when its stack fills, so the per-send view holds the lag too),
then after `flush()`.  Tolerance: exact, except float values, which may
differ by summation order: relative 1e-5, or absolute 1e-4 (the rounding
residue a float32 sliding-window sum keeps after its rows expire).
The port's fused runs are also held to its own unfused runs.

Shapes from `tests/test_fused.py`: filter (K = 1, 4, 8), sliding window
with group by, join bursts whose side switches split the stack, the
4-state pattern, partial-stack flush, lag until full, a signature change
mid-stack, the exclusions and the annotation forms, @fuse with @pipeline.
Left out: `test_snapshot_drains_fuse_stack` (snapshots, ROADMAP A13),
`test_fused_dispatch_metrics` and `test_fused_recompile_owner_in_metrics_
exposition` (statistics and exposition, A15).

Plain versions: K29's (`kernels/multi_filter.py`) against K1's plain
version per (program, batch), and the stacked pattern mode's against S
sequential plain steps.
"""
import math

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch

REL, ABS = 1e-5, 1e-4


def same(a, b) -> bool:
    """Events equal; floats within REL or ABS (summation order)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            if not isinstance(y, (tuple, list)) or not same(x, y):
                return False
        elif isinstance(x, float) or isinstance(y, float):
            if x is None or y is None:
                if x is not y:
                    return False
            elif math.isnan(x) or math.isnan(y):
                if not (math.isnan(x) and math.isnan(y)):
                    return False
            elif not math.isclose(x, y, rel_tol=REL, abs_tol=ABS):
                return False
        elif x != y:
            return False
    return True


def teq(x, y) -> bool:
    """Tensors equal bit for bit (NaNs included)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype.is_floating_point:
        x, y = x.view(torch.int32 if x.element_size() == 4 else
                      torch.int64), y.view(torch.int32 if y.element_size()
                                           == 4 else torch.int64)
    return torch.equal(x, y)


def collect(rt, qnames):
    got = {q: [] for q in qnames}
    for q in qnames:
        rt.add_callback(q, lambda ts, cur, exp, q=q: got[q].extend(
            [("C", ts, tuple(e.data)) for e in (cur or [])] +
            [("E", ts, tuple(e.data)) for e in (exp or [])]))
    return got


def drive(manager, ql, feed, qnames=("q",)):
    """(events after each send, events after flush) per query."""
    rt = manager.create_siddhi_app_runtime(ql)
    got = collect(rt, qnames)
    rt.start()
    per_send = []
    for sid, rows, ts in feed():
        rt.get_input_handler(sid).send(rows, timestamp=ts)
        per_send.append({q: list(v) for q, v in got.items()})
    rt.flush()
    final = {q: list(v) for q, v in got.items()}
    rt.shutdown()
    return per_send, final


def jax_mgr():
    return siddhi_tpu.SiddhiManager()


def port_mgr():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def assert_parity(template, feed, k, qnames=("q",)):
    """Fused port == fused JAX after every send; the fused query (the
    first name) == the unfused port's once flushed (a downstream reader
    sees the lag in its `now`)."""
    ql = template.format(ann=f"@fuse(batches='{k}')")
    jp, jf = drive(jax_mgr(), ql, feed, qnames)
    tp, tf = drive(port_mgr(), ql, feed, qnames)
    for s, (a, b) in enumerate(zip(jp, tp)):
        for q in qnames:
            assert same(a[q], b[q]), (s, q, a[q][-3:], b[q][-3:])
    for q in qnames:
        assert same(jf[q], tf[q])
    _, uf = drive(port_mgr(), template.format(ann=""), feed, qnames)
    assert same(uf[qnames[0]], tf[qnames[0]])
    return tf


FILTER_QL = """
@app:playback
define stream S (v int, p float);
{ann} @info(name='q') from S[v > 2 and p < 0.9]
select v, p * 2.0 as d insert into Out;
"""


def feed_filter():
    rng = np.random.default_rng(11)
    for i in range(13):
        yield "S", [[int(rng.integers(0, 6)), round(float(rng.random()), 3)]
                    for _ in range(8)], 1000 + i


@pytest.mark.parametrize("k", [1, 4, 8])
def test_fused_filter_parity(k):
    out = assert_parity(FILTER_QL, feed_filter, k)
    assert out["q"]


WINDOW_QL = """
@app:playback
define stream S (g long, p float);
{ann} @info(name='q') from S#window.length(4)
select g, sum(p) as sp group by g insert into Out;
"""


def feed_window():
    for i in range(11):
        yield "S", [[i % 3, float(i)], [(i + 1) % 3, i * 0.5]], 1000 + i


def test_fused_sliding_window_parity():
    assert assert_parity(WINDOW_QL, feed_window, 4)["q"]


JOIN_QL = """
@app:playback
define stream L (s long, p float);
define stream R (s long, n int);
@emit(rows='4096') {ann} @info(name='q')
from L#window.length(8) join R#window.length(8) on L.s == R.s
select L.s as s, L.p as p, R.n as v insert into Out;
"""


def feed_join():
    rng = np.random.default_rng(3)
    for i in range(6):
        # bursts per side: same-side batches stack; the side switch breaks
        # the stack signature and drains it in order
        for _ in range(3):
            yield "L", [[int(rng.integers(0, 4)),
                         round(float(rng.random()), 3)]], 1000 + i
        for _ in range(3):
            yield "R", [[int(rng.integers(0, 4)),
                         int(rng.integers(1, 9))]], 1000 + i


def test_fused_join_parity():
    assert assert_parity(JOIN_QL, feed_join, 3)["q"]


PATTERN_QL = """
@app:playback
define stream S (k long, p float, v int);
@capacity(keys='1', slots='8') @emit(rows='4096') {ann}
@info(name='q')
from every e1=S[v == 1] -> e2=S[v == 2 and p >= e1.p]
     -> e3=S[v == 3] -> e4=S[v == 4 and p >= e3.p]
select e1.p as p1, e2.p as p2, e4.p as p4 insert into M;
"""


def feed_pattern():
    rng = np.random.default_rng(7)
    for i in range(12):
        vols = rng.integers(1, 5, 16).tolist()
        prices = [round(float(x), 3) for x in rng.random(16)]
        yield "S", [[0, prices[j], vols[j]] for j in range(16)], 1000 + i


@pytest.mark.parametrize("k", [1, 4])
def test_fused_4state_pattern_parity(k):
    assert assert_parity(PATTERN_QL, feed_pattern, k)["q"]


RISE_QL = """
@app:playback
define stream StockStream (symbol string, price float);
{ann} @info(name='q')
from every e1=StockStream -> e2=StockStream[price > e1.price]
  within 1 min
select e1.symbol as symbol, e1.price as buy, e2.price as sell
insert into RiseStream;
"""


def feed_rise():
    rng = np.random.default_rng(5)
    for i in range(9):
        yield "StockStream", [[f"s{int(rng.integers(0, 3))}",
                               round(float(rng.random()) * 100, 2)]
                              for _ in range(5)], 1000 + 20_000 * i


def test_fused_pattern_matching_sample_parity():
    """The PM1 shape (samples/apps/pattern_matching.siddhi): `within`
    expiring across stacked batches."""
    assert assert_parity(RISE_QL, feed_rise, 4)["q"]


# ---------------------------------------------------------------------------
# stack mechanics and exclusions
# ---------------------------------------------------------------------------

def _events(got):
    return [e[2][0] for e in got]


@pytest.mark.parametrize("mk", [jax_mgr, port_mgr])
def test_partial_stack_flush_delivers_pending(mk):
    rt = mk().create_siddhi_app_runtime("""
    define stream S (v int);
    @fuse(batches='8') @info(name='q')
    from S select v * 2 as w insert into Out;
    """)
    got = collect(rt, ["q"])["q"]
    rt.start()
    qr = rt.query_runtimes["q"]
    assert qr._fuse is not None and qr._fuse.k == 8
    h = rt.get_input_handler("S")
    for v in range(3):
        h.send([v])
    assert got == [] and len(qr._fuse.items) == 3
    rt.flush()
    assert _events(got) == [0, 2, 4]
    assert qr._fuse.items == []
    rt.shutdown()


@pytest.mark.parametrize("mk", [jax_mgr, port_mgr])
def test_full_stack_dispatches_without_flush(mk):
    rt = mk().create_siddhi_app_runtime("""
    define stream S (v int);
    @fuse(batches='3') @info(name='q')
    from S select v + 1 as w insert into Out;
    """)
    got = collect(rt, ["q"])["q"]
    rt.start()
    h = rt.get_input_handler("S")
    for v in range(3):
        h.send([v])
    assert _events(got) == [1, 2, 3]
    rt.shutdown()


def test_signature_change_drains_in_order():
    ql = """
    define stream S (v int);
    @fuse(batches='4') @info(name='q')
    from S select v as w insert into Out;
    """
    outs = []
    for mk in (jax_mgr, port_mgr):
        rt = mk().create_siddhi_app_runtime(ql)
        got = collect(rt, ["q"])["q"]
        rt.start()
        h = rt.get_input_handler("S")
        h.send([1])
        h.send([2])
        seen = list(got)
        # 9 events -> 32-bucket: different capacity, drains the pending pair
        h.send([[v] for v in range(3, 12)])
        rt.flush()
        outs.append((seen, _events(got)))
        rt.shutdown()
    assert outs[0] == outs[1]
    assert outs[1][1] == [1, 2] + list(range(3, 12))


EXCLUDED = {
    "time window": """
    define stream S (v int);
    @fuse(batches='4') @info(name='q') from S#window.time(1 sec)
    select sum(v) as t insert into Out;
    """,
    "partitioned pattern": """
    define stream S (k long, v int);
    partition with (k of S) begin
    @capacity(keys='16', slots='4') @fuse(batches='4') @info(name='q')
    from every e1=S[v == 1] -> e2=S[v == 2]
    select e1.k as k insert into Out;
    end;
    """,
    "keyed window": """
    define stream S (k long, v int);
    partition with (k of S) begin
    @fuse(batches='4') @info(name='q') from S#window.length(3)
    select k, sum(v) as t insert into Out;
    end;
    """,
}


@pytest.mark.parametrize("case", sorted(EXCLUDED))
def test_exclusions_match(case):
    """A query the JAX package does not fuse is not fused in the port,
    for the same reason."""
    rj = jax_mgr().create_siddhi_app_runtime(EXCLUDED[case])
    rp = port_mgr().create_siddhi_app_runtime(EXCLUDED[case])
    qj, qp = rj.query_runtimes["q"], rp.query_runtimes["q"]
    assert qj._fuse is None and qp._fuse is None
    assert qj._fuse_excluded == qp._fuse_excluded


@pytest.mark.parametrize("ql", [
    """@app:fuse(batches='2')
    define stream S (v int);
    @info(name='q') from S select v as w insert into Out;""",
    """@fuse(batches='2')
    define stream S (v int);
    @info(name='q') from S select v as w insert into Out;"""])
def test_app_and_stream_level_fuse(ql):
    rt = port_mgr().create_siddhi_app_runtime(ql)
    got = collect(rt, ["q"])["q"]
    rt.start()
    assert rt.query_runtimes["q"]._fuse.k == 2
    h = rt.get_input_handler("S")
    h.send([1])
    assert got == []
    h.send([2])
    assert _events(got) == [1, 2]
    rt.shutdown()


def test_fuse_composes_with_pipeline():
    ql = """
    @app:playback
    define stream S (v int);
    @fuse(batches='2') @pipeline @info(name='q')
    from S select v * 10 as w insert into Out;
    """

    def feed():
        for v in range(5):
            yield "S", [v], 1000 + v
    jp, jf = drive(jax_mgr(), ql, feed)
    tp, tf = drive(port_mgr(), ql, feed)
    assert jp == tp and jf == tf
    assert _events(tf["q"]) == [0, 10, 20, 30, 40]


def test_fused_pipeline_sample():
    """FP1's app (samples/apps/fused_pipeline.siddhi) at a small size: the
    fused query and its downstream reader."""
    ql = "@app:playback\n" + open("samples/apps/fused_pipeline.siddhi").read()

    def feed():
        rng = np.random.default_rng(2)
        for i in range(19):
            n = 7
            yield "SensorStream", [
                [f"d{int(rng.integers(0, 5))}",
                 round(float(rng.uniform(-10, 100)), 2),
                 bool(rng.random() < 0.9)] for _ in range(n)], 1000 + i
    out = assert_parity(ql.replace("@fuse(batches='8')", "{ann}"), feed, 8,
                        ("fusedClean", "alerts"))
    assert out["fusedClean"] and out["alerts"]


# ---------------------------------------------------------------------------
# plain versions: K29 and the stacked pattern mode
# ---------------------------------------------------------------------------

def test_multi_filter_plain_equals_k1_per_program_and_batch():
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.executor import Scope, compile_expression
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.kernels import filter_compact as k1
    from siddhi_tpu_torch.kernels import multi_filter as k29
    app = SiddhiCompiler.parse("""
    define stream S (a int, b float, c bool);
    from S[a > 3 and b < 0.5] select a insert into O1;
    from S[c == true] select a insert into O2;
    from S select a insert into O3;
    """)
    schema = ev.Schema(app.stream_definition_map["S"], ev.StringInterner())
    cpu = torch.device("cpu")
    specs = []
    for q in app.execution_element_list:
        scope = Scope(cpu)
        scope.add_source("S", schema)
        comp = [compile_expression(h.expression, scope)
                for h in q.input_stream.stream_handlers]
        specs.append(k1.FilterSpec(schema.types, comp, None, "S"))
    rng = np.random.default_rng(0)
    S, B = 3, 32
    ts = torch.from_numpy(rng.integers(0, 100, (S, B)).astype(np.int64))
    kind = torch.from_numpy(rng.choice([0, 0, 0, 1], (S, B)).astype(np.int32))
    valid = torch.from_numpy(rng.random((S, B)) < 0.8)
    cols = (torch.from_numpy(rng.integers(0, 8, (S, B)).astype(np.int32)),
            torch.from_numpy(rng.random((S, B)).astype(np.float32)),
            torch.from_numpy(rng.random((S, B)) < 0.5))
    gs = [torch.from_numpy(rng.integers(0, 4, (S, B)).astype(np.int32))
          for _ in specs]
    seqs = [torch.tensor([5]), None, torch.tensor([0])]
    ref_seqs = [None if x is None else x.clone() for x in seqs]
    got = k29.multi_filter(specs, ts, kind, valid, cols, gs, [1, 2, 3],
                           seqs, [False, True, False])
    for p, spec in enumerate(specs):
        for s in range(S):
            rows, n = k1.plain(spec, ts[s], kind[s], valid[s], gs[p][s],
                               tuple(c[s] for c in cols), s + 1, ref_seqs[p],
                               keep_expired=(p == 1))
            r2, n2 = got[p][s]
            assert torch.equal(n, n2)
            for x, y in zip(rows[:5], r2[:5]):
                assert teq(x, y)
            for x, y in zip(rows.cols, r2.cols):
                assert teq(x, y)
    for a, b in zip(seqs, ref_seqs):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


def test_stacked_pattern_plain_equals_sequential_steps():
    """The stacked mode's plain version walks S batches as S sequential
    plain steps from one state: same state, headers and rows."""
    rt = port_mgr().create_siddhi_app_runtime(COUNT_QL.format(
        ann="@fuse(batches='4')"))
    qr = rt.query_runtimes["q"]
    p = qr.planned
    assert not p.block
    from siddhi_tpu_torch.core import event as ev
    schema = p.in_schemas["S"]
    sends = list(feed_pattern())[:4]
    staged = [ev.pack_np(schema, [ev.Event(ts, r) for r in rows])
              for _, rows, ts in sends]
    stack = ev.StackedBatch(staged)
    B = staged[0].ts.shape[0]
    sel = np.stack([np.where(st.valid, np.arange(B), -1).astype(
        np.int32)[None, :] for st in staged])
    batch, (sel_t,) = stack.to_device(schema, torch.device("cpu"), [sel])
    key = torch.zeros(1, dtype=torch.int32)
    nows = [ts for _, _, ts in sends]

    def clone(state):
        (b32, b64, sc), sel_state = state
        return ((b32.clone(), b64.clone(), tuple(x.clone() for x in sc)),
                [x.clone() for x in sel_state])
    st0 = clone(qr.state)
    pk, ss, outs, _ = p.steps["S"].stacked(
        st0[0], st0[1], batch.cols, batch.ts, sel_t, key, nows)
    st1 = clone(qr.state)
    pk1, ss1 = st1
    for s in range(4):
        pk1, ss1, out, _ = p.steps["S"].plain(
            pk1, ss1, tuple(c[s] for c in batch.cols), batch.ts[s],
            sel_t[s], key, nows[s])
        for x, y in zip(out[:5], outs[s][:5]):
            assert teq(x, y)
        for x, y in zip(out[5], outs[s][5]):
            assert teq(x, y)
    for x, y in zip(pk[:2], pk1[:2]):
        assert teq(x, y)


COUNT_QL = """
@app:playback
define stream S (k long, p float, v int);
{ann} @info(name='q')
from every e1=S[v == 1]<2:3> -> e2=S[v == 2 and p >= e1[0].p]
select e1[0].p as p1, e1[1].p as p2, e2.p as pe insert into M;
"""


@pytest.mark.parametrize("k", [8])
def test_fused_count_pattern_parity(k):
    """A top-level plan off the block NFA: on CUDA the general mode's
    stacked launch walks the stack (9 sends: a full stack and a partial
    one that flush drains)."""
    def feed():
        return list(feed_pattern())[:9]
    assert assert_parity(COUNT_QL, feed, k)["q"]


ROUTE_QL = """
@app:playback
define stream S (sym string, p float, n int, ok bool);
{ann} @info(name='q') from S[ok == true] select sym, p * 2.0 as d, n, ok
insert into T;
@info(name='r') from T[d > 0.5 or n is null] select sym, d, n
insert into U;
"""


def feed_route():
    rng = np.random.default_rng(21)
    for i in range(9):
        rows = []
        for _ in range(6):
            p = float(rng.random())
            rows.append([f"s{int(rng.integers(0, 4))}" if rng.random() < 0.8
                         else None,
                         None if p < 0.1 else float("nan") if p < 0.2
                         else round(p, 3),
                         None if p > 0.9 else int(rng.integers(0, 9)),
                         bool(rng.random() < 0.8)])
        yield "S", rows, 1000 + i


def test_routed_rows_equal_events():
    """A query's rows inserted into a stream without decoding them to
    events (no callback on the query) reach the reader and the stream
    callback as the events would: strings, nulls and NaN included."""
    def go(mgr, ann):
        rt = mgr.create_siddhi_app_runtime(ROUTE_QL.format(ann=ann))
        got = collect(rt, ["r"])["r"]
        seen = []
        rt.add_callback("T", lambda evs: seen.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        for sid, rows, ts in feed_route():
            rt.get_input_handler(sid).send(rows, timestamp=ts)
        rt.flush()
        rt.shutdown()
        return got, seen
    want = go(jax_mgr(), "")
    assert want[0] and want[1]
    got = go(port_mgr(), "")
    assert same(got[0], want[0]) and same(got[1], want[1])
    # fused, the reader's `now` lags with the stack: its rows are the same
    got = go(port_mgr(), "@fuse(batches='4')")
    assert same([e[2] for e in got[0]], [e[2] for e in want[0]])
    assert same(got[1], want[1])
