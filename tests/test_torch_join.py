"""Stream-stream joins through both packages' `SiddhiManager`s give the same
events: timestamps, kinds, order, values and nulls, and the batch
payload's [n_valid, n_current, n_expired, n_dropped].  The batch payload's
rows are also compared in their device order (before the host's stable
timestamp sort), which holds the port's join probe (K7) to the reference
step's pair and unmatched index lists; the plain lane table (K6) is held
against the reference's `_bucket_lanes`.

Inputs come from numpy seeds, at small windows and few sends (the full
sizes are `chip_smoke.py`'s work).  Tolerance: exact everywhere (a join
moves values; prices are compared as float32 bit patterns, NaN equal to
NaN).  The JAX side runs on the CPU, as its own tests run it.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core import join as jaxjoin
from siddhi_tpu.exceptions import CompileError as JaxCompileError
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core import join as tjoin
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.kernels import join_lanes, join_probe

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QL = """
@app:playback
define stream L (symbol long, price float, lid int);
define stream R (symbol long, qty int, rid int);
{ann} @info(name='q')
from L{fl}#window.{wl} {jt} R#window.{wr}
  on {on}
select {sel} {having} insert into Out;
"""
SEL = "L.symbol as s, L.price as p, lid, R.qty as v, rid"


def _ql(jt="join", wl="length(16)", wr="length(16)",
        on="L.symbol == R.symbol", sel=SEL, ann="", fl="", having=""):
    return QL.format(ann=ann, fl=fl, wl=wl, jt=jt, wr=wr, on=on, sel=sel,
                     having=having)


def _sends(n=4, B=24, keys=8, seed=13, step=700, sides=("L", "R")):
    """n sends per side; every row carries a unique id (lid / rid)."""
    rng = np.random.default_rng(seed)
    out, uid = [], 0
    for i in range(n):
        for s in sides:
            ids = np.arange(uid, uid + B, dtype=np.int32)
            uid += B
            mid = (rng.integers(0, 64, B) / 64).astype(np.float32) \
                if s == "L" else rng.integers(1, 9, B).astype(np.int32)
            out.append((s, [rng.integers(0, keys, B).astype(np.int64), mid,
                            ids], 1000 + i * step))
    return out


def _run(manager, ql, sends, qname="q", prepare=None):
    """Events, batch counts and the batch payloads' valid rows in device
    order."""
    rt = manager.create_siddhi_app_runtime(ql)
    if prepare is not None:
        prepare(rt)
    events, counts, rows = [], [], []
    rt.add_callback(qname, lambda ts, c, e: events.append(
        (ts, [(x.timestamp, tuple(x.data)) for x in c or []],
         [(x.timestamp, tuple(x.data)) for x in e or []])))

    def on_batch(ts, b):
        counts.append((b["n_valid"], b["n_current"], b["n_expired"],
                       b["n_dropped"]))
        v = b["valid"]
        rows.append([tuple(r) for r in zip(
            b["ts"][v].tolist(), b["kind"][v].tolist(),
            *(np.asarray(c)[v].view(np.int32).tolist()
              if np.asarray(c).dtype == np.float32 else
              np.asarray(c)[v].tolist() for c in b["cols"].values()))])
    rt.add_batch_callback(qname, on_batch)
    rt.start()
    for stream, cols, ts in sends:
        rt.get_input_handler(stream).send_columns(
            cols, timestamps=np.full(len(cols[0]), ts, np.int64))
    rt.shutdown()
    return events, counts, rows, rt.query_runtimes[qname]


def _same(ql, sends, qname="q", expect_mode=None):
    """Both packages over the same sends; everything equal.  Returns the
    port's query runtime."""
    je, jc, jr, _ = _run(JaxManager(), ql, sends, qname)
    te, tc, tr, tq = _run(TorchManager(device="cpu"), ql, sends, qname)
    assert jc == tc, "batch counts"
    assert jr == tr, "rows in device order"
    if "@app:playback" not in ql:
        # the callback's own timestamp is the wall clock; the events' are
        # the sent ones
        je, te = [e[1:] for e in je], [e[1:] for e in te]
    assert je == te, "events"
    assert any(c[0] for c in tc), "the sends produced no joined rows"
    if expect_mode is not None:
        assert tq.planned.fastpath == expect_mode
    return tq


@pytest.mark.parametrize("jt", ["join", "left outer join",
                                "right outer join", "full outer join"])
def test_join_types_bucket_path(jt):
    _same(_ql(jt=jt), _sends(), expect_mode="bucket")


@pytest.mark.parametrize("where", ["left", "right"])
def test_unidirectional(where):
    ql = _ql(jt="left outer join")
    if where == "left":
        ql = ql.replace("from L#", "from L#").replace(
            " left outer join R", " unidirectional left outer join R")
    else:
        ql = ql.replace("R#window.length(16)",
                        "R#window.length(16) unidirectional")
    tq = _same(ql, _sends(), expect_mode="bucket")
    assert tq.planned.trigger == ("LEFT" if where == "left" else "RIGHT")


def test_bucket_path_against_grid_path_with_residual():
    """The fast path off (grid) and on (bucket) give the same events on
    both packages; the ON condition carries a residual conjunct."""
    ql = _ql(jt="full outer join",
             on="L.symbol == R.symbol and L.price > 0.25")
    sends = _sends(seed=21)
    tq = _same(ql, sends, expect_mode="bucket")
    assert tq.planned.residual
    tjoin.FASTPATH_ENABLED = False
    try:
        ge, gc, gr, gq = _run(TorchManager(device="cpu"), ql, sends)
    finally:
        tjoin.FASTPATH_ENABLED = True
    assert gq.planned.fastpath is None
    be, bc, br, _ = _run(TorchManager(device="cpu"), ql, sends)
    assert (ge, gc, gr) == (be, bc, br)


@pytest.mark.parametrize("on", ["L.symbol < R.symbol and R.qty > 4",
                                "not (L.symbol == R.symbol) or L.price > 0.9"])
def test_non_equi_on_grid_path(on):
    _same(_ql(jt="left outer join", wl="length(8)", wr="length(12)", on=on),
          _sends(n=3, B=16), expect_mode=None)


def test_side_filter_forces_grid_path():
    tq = _same(_ql(jt="right outer join", fl="[price > 0.3 and lid != 7]"),
               _sends(seed=5))
    assert tq.planned.fastpath is None
    assert "stream filter" in tq.planned.fastpath_reason


@pytest.mark.parametrize("wl,wr", [("time(1 sec)", "length(16)"),
                                   ("time(900)", "time(2 sec)")])
def test_time_window_sides_with_timer_expiry(wl, wr):
    """Sends 700 ms apart: TIMER steps expire rows between sends and their
    EXPIRED rows probe the other side."""
    tq = _same(_ql(jt="full outer join", wl=wl, wr=wr), _sends(n=5, B=16),
               expect_mode="bucket")
    assert tq.planned.needs_timer


def test_self_join_shared_staged_batch():
    ql = """
    @app:playback
    define stream P (sym long, price float);
    @info(name='q')
    from P#window.length(16) as e1 join P#window.length(16) as e2
      on e1.sym == e2.sym
    select e1.sym as s, e1.price as a, e2.price as b insert into Out;
    """
    rng = np.random.default_rng(17)
    sends = [("P", [rng.integers(0, 6, 24).astype(np.int64),
                    (rng.integers(0, 64, 24) / 64).astype(np.float32)],
              1000 + i) for i in range(5)]
    _same(ql, sends, expect_mode="bucket")


def test_batch_longer_than_window_and_partly_filled():
    """B > C: a batch evicts its own earlier arrivals; the first sends meet
    partly filled windows of different lengths."""
    sends = _sends(n=2, B=5, seed=3) + _sends(n=2, B=40, seed=4)[2:]
    _same(_ql(jt="left outer join", wl="length(12)", wr="length(30)"),
          sends, expect_mode="bucket")


def test_lane_growth_under_skew():
    """One hot key fills the window: lanes grow to the full occupancy
    before any step could drop candidates."""
    tq = _same(_ql(wl="length(32)", wr="length(32)"), _sends(keys=1, B=32),
               expect_mode="bucket")
    assert tq.planned.lane_k >= 32


def test_key_slots_recycle_under_rotation():
    """Fresh keys every send, far more than the key allocator holds: slots
    recycle as both windows forget a key."""
    ql = _ql(wl="length(16)", wr="length(16)")
    B, rounds = 512, 36
    sends = []
    for i in range(rounds):
        keys = np.arange(i * B, (i + 1) * B, dtype=np.int64)
        ids = np.arange(B, dtype=np.int32)
        sends.append(("L", [keys, np.ones(B, np.float32), ids], 1000 + i))
        sends.append(("R", [keys, np.full(B, 7, np.int32), ids], 1000 + i))
    tq = _same(ql, sends, expect_mode="bucket")
    alloc = tq.planned.join_key_allocator
    assert rounds * B > alloc.capacity and len(alloc) <= alloc.capacity


def test_cross_dtype_keys():
    ql = _ql().replace("define stream L (symbol long",
                       "define stream L (symbol int")
    sends = _sends(keys=6)
    for i, (s, cols, ts) in enumerate(sends):
        if s == "L":
            sends[i] = (s, [cols[0].astype(np.int32)] + cols[1:], ts)
    tq = _same(ql, sends, expect_mode="bucket")
    assert str(tq.planned.key_dtypes[0]) == "int64"


@pytest.mark.parametrize("ann", ["", "@emit(rows='64')"])
def test_emission_cap_implicit_growth_and_explicit(ann):
    """Dense fan-out: without @emit the cap grows once and the overflowing
    batch loses its surplus; with @emit the surplus drops every batch."""
    tq = _same(_ql(ann=ann, wl="length(64)", wr="length(64)"),
               _sends(keys=2, B=48, n=3))
    assert tq.planned.emit_explicit == bool(ann)
    assert tq.planned.compact_rows is not None


def test_having_and_coalesce_projection():
    _same(_ql(jt="full outer join",
              sel="L.symbol as s, coalesce(R.qty, -1) as v, lid, rid",
              having="having v > 2 or lid is null"), _sends(seed=9))


def _sample(name):
    with open(os.path.join(_ROOT, "samples", "apps", name)) as fh:
        return fh.read()


def _sample_sends(streams, n=5, B=256, seed=23):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        for s, mk in streams:
            out.append((s, [rng.integers(0, 256, B).astype(np.int32),
                            mk(rng, B)], 1000 + i))
    return out


def test_join_streams_sample():
    sends = _sample_sends([
        ("TempStream", lambda r, B: (r.integers(0, 4096, B) / 64
                                     ).astype(np.float32)),
        ("RegulatorStream", lambda r, B: r.random(B) < 0.5)])
    _same(_sample("join_streams.siddhi"), sends, qname="joinQuery",
          expect_mode="bucket")


def test_outer_join_enrichment_sample():
    """Both queries: the left outer join, and the filter with coalesce over
    its output (null qty rows included) through the junction."""
    ql = _sample("outer_join_enrichment.siddhi")
    sends = _sample_sends([
        ("Orders", lambda r, B: (r.integers(0, 4096, B) / 64
                                 ).astype(np.float32)),
        ("Fills", lambda r, B: r.integers(1, 9, B).astype(np.int32))])
    _same(ql, sends, qname="enrich", expect_mode="bucket")
    je = _run(JaxManager(), ql, sends, "bigFills")
    te = _run(TorchManager(device="cpu"), ql, sends, "bigFills")
    assert [e[1:] for e in je[0]] == [e[1:] for e in te[0]]
    assert je[1:3] == te[1:3] and any(c[0] for c in te[1])


@pytest.mark.parametrize("seed,keys,k", [(1, 40, 8), (2, 3, 4), (3, 900, 2)])
def test_plain_lanes_match_reference(seed, keys, k):
    """The plain K6 against `_bucket_lanes` on the same live rows; rows
    past the lane width are counted, not dropped silently."""
    rng = np.random.default_rng(seed)
    C, n, nbl = 64, 50, 64
    jslot = rng.integers(0, keys, C).astype(np.int32)
    alive = np.arange(C) < n
    ref = np.asarray(jaxjoin._bucket_lanes(jnp.asarray(jslot),
                                           jnp.asarray(alive), nbl, k))
    # the port's ring holds the same rows from a nonzero head
    head = 23
    ring = np.zeros(C, np.int32)
    ring[(head + np.arange(C)) % C] = jslot
    over = torch.zeros(1, dtype=torch.int64)
    got = join_lanes.plain(torch.from_numpy(ring),
                           torch.tensor([head, head + n, 0, 0]), nbl, k,
                           over)
    np.testing.assert_array_equal(got.numpy(), ref)
    b = jslot[:n] % nbl
    want_over = int(np.maximum(np.bincount(b, minlength=nbl) - k, 0).sum())
    assert int(over) == want_over


def test_lane_overflow_is_reported():
    """A lane narrower than a bucket's rows (the host mirror bypassed):
    the step's header reports the overflow and the runtime raises."""
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(_ql())
    qr = rt.query_runtimes["q"]
    qr._jk.needed_k = lambda: 0
    qr.planned.lane_k = 2
    seen = []
    rt.add_batch_callback("q", lambda ts, b: seen.append(b["n_valid"]))
    rt.start()
    sends = _sends(n=1, B=24, keys=1)
    from siddhi_tpu_torch.core import event as ev
    for s, cols, ts in sends:
        schema = rt.schemas[s]
        staged = ev.pack_np(schema, [ev.Event(ts, [c[i].item() for c in cols])
                                     for i in range(len(cols[0]))])
        if s == "L":
            qr.process_staged(True, staged, ts)
        else:
            with pytest.raises(RuntimeError, match="did not fit the "
                                                   "equi-join candidate"):
                qr.process_staged(False, staged, ts)
    assert join_probe.plain_calls > 0


@pytest.mark.parametrize("body,err,item", [
    ("from L#window.length(4) join R#window.length(4) on L.symbol == "
     "R.symbol select L.symbol as s, distinctCount(R.qty) as q group by "
     "L.symbol insert into O;", CompileError, "B14"),
    ("from L#window.length(4) join R#window.frequent(2) on "
     "L.symbol == R.symbol select count() as c insert into O;",
     CompileError, "sliding"),
    ("@sink(type='log') from L#window.length(4) join R#window.length(4) "
     "on L.symbol == R.symbol select L.symbol as s insert into O;",
     CompileError, "A15"),
    ("from L#window.length(4) join T on L.symbol == T.symbol and "
     "L.symbol in T select L.symbol as s insert into O;", CompileError,
     "B-probe"),
    ("from L#window.length(4) join W on L.symbol == W.symbol "
     "select L.symbol as s insert into O;", CompileError,
     "probe-able buffer"),
])
def test_out_of_subset_joins_raise(body, err, item):
    extra = ""
    if " T " in body:
        extra = "define table T (symbol long, qty int);\n"
    if " W " in body:
        # a named window of a kind that keeps no buffer to probe
        extra = "define window W (symbol long, qty int) frequent(2);\n"
    ql = ("define stream L (symbol long, price float);\n"
          "define stream R (symbol long, qty int);\n" + extra + body)
    with pytest.raises(err, match=item):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_join_outside_cuda_subset_raises_at_plan_time():
    """On CUDA a side wider than the kernels' 16 columns raises before
    anything is built on the device."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    cols = ", ".join(f"c{i} int" for i in range(16))
    ql = (f"define stream W ({cols});\n"
          f"define stream R (c0 int, qty int);\n"
          f"from W#window.length(4) join R#window.length(4) "
          f"on W.c0 == R.c0 select W.c1 as a insert into O;")
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    q = SiddhiCompiler.parse(ql).execution_element_list[0]
    with pytest.raises(NotImplementedError, match="kernels' subset"):
        tjoin.plan_join_query(q, "q", rt.schemas, rt.manager.interner,
                              device=torch.device("cuda"))


def test_single_query_planner_refuses_a_join():
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.planner import plan_single_query
    ql = _ql()
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    q = SiddhiCompiler.parse(ql).execution_element_list[0]
    with pytest.raises(CompileError, match="plan_join_query"):
        plan_single_query(q, "q", rt.schemas, rt.manager.interner)


@pytest.mark.parametrize("body,msg", [
    ("from L#window.lengthBatch(4) join R#window.length(4) on L.symbol == "
     "R.symbol select L.symbol as s insert into O;", "sliding"),
    ("from L join R#window.length(4) on L.symbol == R.symbol "
     "select L.symbol as s insert into O;", "window on each side"),
])
def test_join_window_errors_match_reference(body, msg):
    ql = ("define stream L (symbol long, price float);\n"
          "define stream R (symbol long, qty int);\n" + body)
    with pytest.raises(JaxCompileError, match=msg):
        JaxManager().create_siddhi_app_runtime(ql)
    with pytest.raises(CompileError, match=msg):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("expr,types", [
    ("coalesce(a, b)", ("INT", "INT")),
    ("coalesce(a, b, 2.5)", ("INT", "FLOAT")),
    ("coalesce(b, a)", ("LONG", "INT")),
])
def test_coalesce_executor_and_bytecode(expr, types):
    """`coalesce` in the port's executor and as the COALESCE opcode of the
    filter bytecode (the kernels' interpreter) against the JAX executor,
    nulls included."""
    from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
    from siddhi_tpu.core.executor import Scope as JScope
    from siddhi_tpu.core.executor import compile_expression as jcompile
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core import event as ev
    from siddhi_tpu_torch.core.executor import Scope, compile_expression
    from siddhi_tpu_torch.kernels.filter_bytecode import compile_filter, \
        interpret
    from siddhi_tpu_torch.query_api.expression import Compare, Constant
    ql = (f"define stream S (a {types[0].lower()}, b {types[1].lower()});\n"
          f"from S[{expr} > 1] select a insert into O;")
    node = SiddhiCompiler.parse(ql).execution_element_list[0] \
        .input_stream.stream_handlers[0].expression
    rng = np.random.default_rng(3)
    cols = []
    for t in types:
        v = rng.integers(-3, 4, 64)
        if t == "FLOAT":
            c = v.astype(np.float32)
            c[rng.random(64) < 0.3] = np.nan
        else:
            c = v.astype(np.int32 if t == "INT" else np.int64)
            c[rng.random(64) < 0.3] = np.iinfo(c.dtype).min
        cols.append(c)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    sc = Scope()
    sc.interner = trt.interner
    sc.add_source("S", trt.schemas["S"])
    jrt = JaxManager().create_siddhi_app_runtime(ql)
    js = JScope()
    js.interner = jrt.interner
    js.add_source("S", jrt.schemas["S"])
    inner = node.left
    jinner = JaxCompiler.parse(ql).execution_element_list[0] \
        .input_stream.stream_handlers[0].expression.left
    want = np.asarray(jcompile(jinner, js).fn({"S": tuple(cols)}))
    got = compile_expression(inner, sc).fn(
        {"S": tuple(torch.from_numpy(c) for c in cols)}).numpy()
    np.testing.assert_array_equal(got, want)
    # the whole filter as bytecode, against the executor's mask
    code = compile_filter(node, sc, "S", {})
    mask = interpret(code, lambda c: torch.from_numpy(cols[c]),
                     lambda a, c: None)
    np.testing.assert_array_equal(
        mask.numpy(), compile_expression(node, sc).fn(
            {"S": tuple(torch.from_numpy(c) for c in cols)}).numpy())
    assert isinstance(node, Compare) and isinstance(node.right, Constant)
    if len(inner.parameters) == 2:      # both null in some rows
        assert ev.null_mask(torch.from_numpy(want), compile_expression(
            inner, sc).type).any()
