"""The port's `externalTime`, `externalTimeBatch`, `timeLength`, `delay`
and `sort` windows (`core/window_ext.py`: the plain versions of K16, K12's
external mode and K17) against the JAX package.

Whole apps run through both packages (events exact): the corpus cases of
`chip_smoke.X2_CASES` of these kinds (the shapes of
`tests/test_window_ext.py` and `test_window_corpus*.py`, out-of-order
event times, a start parameter, time and length evictions together), and
the step itself from a JAX state carried across with
`convert.query_state_from_jax`: every step's valid rows, its wake and the
window's state equal to the JAX step's (exact: the windows move rows and
compute nothing), over random batches with padding rows, out-of-order
timestamps and TIMER rows.  Then the reference's externalTime defect the
port does not copy, a capacity shortfall that raises, and the parameter
lists and unported kinds that raise (of the window_ext kinds too that
other files hold to the JAX package: batch, cron, frequent, hopping), and
the keyed forms of these five kinds (inside a partition) against the JAX
package.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.window import Rows as JRows
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import BatchFacts, Rows
from siddhi_tpu_torch.exceptions import CompileError

_KINDS = ("externalTime", "externalTimeBatch", "timeLength", "delay", "sort")
CASES = [c for c in chip_smoke.X2_CASES if c[0].split()[0] in _KINDS]


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """chip_smoke.py's X2 expectations are the JAX package's events, and
    the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


# -- the step, from a converted state ----------------------------------------

STEP_QL = """
define stream S (et long, v float, w int, b bool);
@capacity(window='{cap}')
@info(name='q') from S#window.{win} select w, v insert all events into O;
"""


def _plans(win, cap):
    ql = STEP_QL.format(win=win, cap=cap)
    jq = JaxManager().create_siddhi_app_runtime(ql).query_runtimes["q"]
    tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"]
    return jq.planned, tq.planned, jq.state


class _Staged:
    def __init__(self, cols):
        self.cols = cols


def _batch(rng, B, now, timer=False):
    ts = now - rng.integers(0, 300, B)
    kind = np.full(B, ev.TIMER if timer else ev.CURRENT, np.int32)
    # valid rows first, as the runtime stages a send (the reference's
    # timeLength maps the k-th arrival to batch row k)
    valid = np.arange(B) < rng.integers(B // 2, B + 1)
    if timer:
        valid[:] = False
        valid[0] = True
        ts[0] = now
    cols = [now - 2000 + rng.integers(-700, 700, B).astype(np.int64),
            rng.integers(-8, 8, B).astype(np.float32) * 0.5,
            rng.integers(-3, 9, B).astype(np.int32), rng.random(B) < 0.5]
    return ts.astype(np.int64), kind, valid, cols


def _state_view(planned, wstate):
    """The port window state's defined content, as numpy."""
    from siddhi_tpu_torch.kernels.ext_window import ExtState
    from siddhi_tpu_torch.kernels.sort_window import SortState
    if isinstance(wstate, ExtState):
        a = wstate.alive()
        return {k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in a.items() if k != "missed"}
    if isinstance(wstate, SortState):
        n = int(wstate.meta[0])
        return {"meta": wstate.meta.numpy(),
                "rows": [x[:n].numpy() for x in wstate.tensors()[:-1]]}
    (p_ts, p_gs, p_cols), (q_ts, q_gs, q_cols) = wstate.slices()
    m = wstate.meta.numpy()
    return {"start": m[0], "seq": m[1],
            "rows": [x.numpy() for x in (p_ts, p_gs, *p_cols, q_ts, q_gs,
                                         *q_cols)]}


def _same(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what} {k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what} {i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert x.shape == y.shape and np.array_equal(x, y), what


def _run_steps(win, cap, n_steps, timer_every=0, warm=2, B=16, seed=0):
    """`warm` steps through the JAX window alone, its state carried over,
    then `n_steps` through both: each step's valid rows in seq order, its
    wake and the state compared."""
    rng = np.random.default_rng(seed)
    jp, tp, (jw_state, _) = _plans(win, cap)
    jw, tw = jp.window, tp.window
    st = None
    rows_seen = 0
    now = 5000
    for i in range(warm + n_steps):
        now += int(rng.integers(0, 400))
        timer = bool(timer_every) and i % timer_every == timer_every - 1
        ts, kind, valid, cols = _batch(rng, B, now, timer)
        if i == warm:
            st = convert.query_state_from_jax(tp, (jw_state, ()))[0]
            _same(_state_view(tp, st), _state_view(
                tp, convert.query_state_from_jax(tp, (jw_state, ()))[0]),
                "carried state")
        jrows = JRows(ts=ts, kind=kind, valid=valid,
                      seq=np.zeros(B, np.int64),
                      gslot=np.arange(B, dtype=np.int32) % 5,
                      cols=tuple(cols))
        jw_state, jout = jw.process(jw_state, jrows, np.int64(now))
        if i < warm:
            continue
        cur = valid & (kind == ev.CURRENT)
        facts = BatchFacts(ts[cur], B, _Staged(cols), cur)
        prow = Rows(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid), seq=None,
                    gslot=torch.from_numpy(np.arange(B, dtype=np.int32) % 5),
                    cols=tuple(torch.from_numpy(c) for c in cols))
        st, wout = tw.process(st, prow, tp.filter_spec, now, facts)
        jo = jout.rows
        jv = np.asarray(jo.valid)
        n = int(jv.sum())
        assert jv[:n].all()
        pv = wout.rows.valid.numpy()
        pn = int(pv.sum())
        assert pn == n, (i, pn, n)
        assert pv[:pn].all()
        for f in ("ts", "kind", "seq", "gslot"):
            _same(getattr(wout.rows, f)[:n].numpy(),
                  np.asarray(getattr(jo, f))[:n], f"step {i} {f}")
        for j, (x, y) in enumerate(zip(wout.rows.cols, jo.cols)):
            _same(x[:n].numpy(), np.asarray(y)[:n], f"step {i} col {j}")
        jwake = int(np.asarray(jout.next_wakeup))
        pwake = int(wout.next_wakeup[0]) if wout.next_wakeup is not None \
            else jwake
        assert pwake == jwake, (i, pwake, jwake)
        _same(_state_view(tp, st), _state_view(
            tp, convert.query_state_from_jax(tp, (jw_state, ()))[0]),
            f"step {i} state")
        rows_seen += n
    return rows_seen


@pytest.mark.parametrize("win,cap,timer", [
    ("externalTime(et, 1 sec)", 2048, 0),
    ("externalTimeBatch(et, 500)", 2048, 0),
    ("timeLength(700, 20)", 2048, 3),
    ("delay(400)", 2048, 3),
    ("sort(12, v)", 2048, 0),
    ("sort(9, w, 'desc')", 2048, 0),
])
def test_step_from_a_converted_state(win, cap, timer):
    """The port's step (plain K16 / K12 external / K17) from the JAX
    window's converted state gives the JAX step's rows, wake and state,
    step after step."""
    assert _run_steps(win, cap, 10, timer_every=timer) > 0


# -- the reference's externalTime defect -------------------------------------

DIV_QL = """
@app:playback
define stream S (eventTime long, v int);
{cap}
@info(name='q') from S#window.externalTime(eventTime, 1000)
select v, sum(v) as total insert all events into Out;
"""


def _div_sends(base):
    return [("S", [base + d, v], 1000 + i)
            for i, (d, v) in enumerate(((0, 1), (500, 2), (700, 8),
                                        (1600, 4)))]


def _events(make, ql, sends):
    return [(i, o) for _, i, o in chip_smoke.corpus_run(make(), ql, "q",
                                                         sends)]


def test_external_time_epoch_ms_divergence():
    """The reference orders its survivors by `ets * (C + 2B) + pos`
    (`siddhi_tpu/core/window_ext.py:124-127`); past BIG_SEQ (epoch-ms
    event times, C + 2B above about 1.3M) kept rows sort after dead ones
    and the rows due to expire are lost.  The port compares the pair: at
    1,760,000,000,000 ms and a 2,097,152-row window it gives the JAX
    package's events at the default capacity (total 12, EXPIRED (1, 10)
    and (2, 8)); the JAX package at that capacity gives total 15 and no
    EXPIRED rows."""
    base = 1_760_000_000_000
    big = DIV_QL.format(cap="@capacity(window='2097152')")
    small = DIV_QL.format(cap="")
    want = _events(JaxManager, small, _div_sends(base))
    assert want[-1] == ([(1003, (4, 12))],
                        [(base + 1000, (1, 10)), (base + 1500, (2, 8))])
    assert _events(lambda: TorchManager(device="cpu"), big,
                   _div_sends(base)) == want
    assert _events(lambda: TorchManager(device="cpu"), small,
                   _div_sends(base)) == want
    jax_big = _events(JaxManager, big, _div_sends(base))
    assert jax_big[-1] == ([(1003, (4, 15))], [])


def test_external_time_shortfall_raises(caplog):
    """More survivors than the window holds (its capacity is
    max(@capacity(window), twice the batch capacity) = 1,024 rows here):
    the reference drops the oldest silently; the port drops them too,
    counts them and raises."""
    ql = """
    define stream S (eventTime long, v int);
    @capacity(window='8')
    @info(name='q') from S#window.externalTime(eventTime, 1 min)
    select v insert all events into Out;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.add_callback("q", lambda *a: None)
    rt.start()
    rt.get_input_handler("S").send([[1000 + i, i] for i in range(1100)],
                                   timestamp=5)
    assert "76 rows did not fit the externalTime window's buffer of 1024 " \
        "rows" in caplog.text


# -- raises -------------------------------------------------------------------

@pytest.mark.parametrize("win,exc,match", [
    ("externalTime(1000, 5)", ValueError, "parameter 0 must be an attribute"),
    ("externalTime(et)", CompileError, "missing window parameter"),
    ("sort(2)", ValueError, "parameter 1 must be an attribute"),
    ("sort(2, v, 'desc', w)", ValueError, "single sort key"),
    ("timeLength(1 sec)", CompileError, "missing window parameter"),
    ("cron(5)", ValueError, "cron expression"),
    ("frequent(v)", CompileError, "constants"),
    ("frequent(2, 3)", ValueError, "parameter 1 must be an attribute"),
    ("lossyFrequent(1.5)", ValueError, "support"),
    ("hopping(et, 500)", CompileError, "constants"),
    ("expression(5)", CompileError, "constant string expression"),
    ("expressionBatch('sum(first.v) < 2')", CompileError,
     "not allowed inside window-expression aggregates"),
])
def test_parameters_and_unported_kinds_raise(win, exc, match):
    ql = ("define stream S (et long, v float, w int, b bool);\n"
          f"from S#window.{win} select v insert into O;")
    with pytest.raises(exc, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("win", ["externalTime(et, 1 sec)",
                                 "externalTimeBatch(et, 1 sec)",
                                 "timeLength(1 sec, 4)", "delay(1 sec)",
                                 "sort(3, v)"])
def test_keyed_forms_raise(win):
    """Inside a partition these windows are kept per key (kernels K20 and
    K21, `kernels/keyed_ext.py`; once a B12 CompileError): the port gives
    the JAX package's events, keys interleaved in each send."""
    ql = ("@app:playback\n"
          "define stream S (et long, v float, w int, b bool);\n"
          "partition with (w of S) begin\n"
          f"@info(name='q') from S#window.{win} select w, v, count() as n "
          "insert all events into O;\nend;")
    sends = [("S", [[1000 + 300 * i + 40 * j, float(i + j), j % 3, j % 2 == 0]
                    for j in range(5)], 1000 + 400 * i) for i in range(6)]
    want = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    assert sum(len(c) + len(e) for _, c, e in want) > 0
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q",
                                 sends) == want
