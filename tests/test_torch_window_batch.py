"""The port's `batch`, `cron` and `hopping` windows (`core/window_ext.py`:
the plain versions of K12's chunk and cron modes and of K18) against the
JAX package.

Whole apps run through both packages (events exact): the corpus cases of
`chip_smoke.X2_CASES` of these kinds (the shapes of
`tests/test_window_ext.py`, `test_window_corpus.py` and
`test_window_corpus2.py`, a grouped chunk, a collapsed hop, the `hoping`
spelling).  Then each window's step from a JAX state carried across with
`convert.query_state_from_jax`: every step's valid rows, its wake and the
window's state equal to the JAX step's (exact: the windows move rows and
compute nothing), over random batches with padding rows, TIMER rows, a
cron flush that carries arrivals and hops collapsed in one gap.  Then the
two places the port departs from the JAX package (a cron fire time
flushes once; a chunk above the reference's capacity is kept whole),
the shortfalls that raise, the parameter lists that raise and the keyed
forms (inside a partition) against the JAX package.  chip_smoke's CB1,
CR1 and HP1 models are held to the port's rows at a small size.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core import runtime as jax_runtime
from siddhi_tpu.core.window import Rows as JRows
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import BatchFacts, Rows
from siddhi_tpu_torch.exceptions import CompileError

_KINDS = ("batch", "cron", "hopping", "hoping")
CASES = [c for c in chip_smoke.X2_CASES if c[0].split()[0] in _KINDS]


@pytest.fixture
def one_entry_per_fire_time(monkeypatch):
    """The JAX scheduler keeping one timer entry per (time, query), as
    the port's does (`siddhi_tpu_torch/core/runtime.py` notify_at)."""
    orig = jax_runtime._Scheduler.notify_at

    def notify_at(self, ts, q):
        with self._cv:
            if any(t == ts and x is q for t, _, x in self._heap):
                return
        orig(self, ts, q)
    monkeypatch.setattr(jax_runtime._Scheduler, "notify_at", notify_at)


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want,
                                     one_entry_per_fire_time):
    """chip_smoke.py's X2 expectations are the JAX package's events, and
    the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


def test_cron_fires_each_time_once():
    """The JAX scheduler queues a fire time once per step that schedules
    it and flushes at each entry: two sends inside a second flush their
    batch at :01 and flush it again right away (EXPIRED at :01, not with
    the next batch).  The port's scheduler keeps one entry, so the batch
    expires with the next fire, as the reference's CronWindowProcessor
    does.  The CURRENT rows agree."""
    name, ql, qname, sends, want = next(c for c in CASES
                                        if c[0] == "cron every second")
    jax = chip_smoke.corpus_run(JaxManager(), ql, qname, sends)
    port = chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends)
    assert port == want and jax != want
    assert [r for _, cur, _ in jax for r in cur] == \
        [r for _, cur, _ in port for r in cur]
    assert jax[1] == (1000, [], [(100, (2,)), (300, (None,))])


# -- the step, from a converted state ----------------------------------------

STEP_QL = """
define stream S (et long, v float, w int, b bool);
@capacity(window='{cap}')
@info(name='q') from S[w >= 0]#window.{win} select w, v
insert all events into O;
"""


@pytest.fixture(scope="module")
def plans():
    """Each window's JAX and port plans, built once for the module."""
    cache = {}

    def get(win, cap):
        if (win, cap) not in cache:
            ql = STEP_QL.format(win=win, cap=cap)
            jq = JaxManager().create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            # the JAX step jitted once
            cache[(win, cap)] = (jq.planned, tq.planned, jq.state,
                                 jax.jit(jq.planned.window.process))
        return cache[(win, cap)]
    return get


class _Staged:
    def __init__(self, ts, kind, valid, cols):
        self.ts, self.kind, self.valid, self.cols = ts, kind, valid, cols


def _batch(rng, B, now, timer=False, spread=300, mixed=False):
    """A batch of B rows, valid ones first; `timer`: a TIMER row at row 0,
    the others invalid TIMER rows or (`mixed`) CURRENT arrivals."""
    ts = now - rng.integers(0, spread, B)
    kind = np.full(B, ev.TIMER if timer and not mixed else ev.CURRENT,
                   np.int32)
    valid = np.arange(B) < rng.integers(B // 2, B + 1)
    if timer:
        if not mixed:
            valid[:] = False
        valid[0] = True
        kind[0] = ev.TIMER
        ts[0] = now
    cols = [rng.integers(0, 1 << 40, B).astype(np.int64),
            rng.integers(-8, 8, B).astype(np.float32) * 0.5,
            rng.integers(-2, 9, B).astype(np.int32), rng.random(B) < 0.5]
    return ts.astype(np.int64), kind, valid, cols


def _state_view(wstate):
    """The port window state's defined content, as numpy."""
    from siddhi_tpu_torch.kernels.hop_window import HopState
    if isinstance(wstate, HopState):
        return {k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in wstate.alive().items() if k != "missed"}
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


def _run_steps(plans, win, cap, n_steps, timers=(), warm=2, B=16, seed=0,
               gaps=(0, 400), mixed=False):
    """`warm` steps through the JAX window alone, its state carried over,
    then `n_steps` through both: each step's valid rows in seq order, its
    wake and the state compared.  Steps in `timers` are TIMER steps."""
    rng = np.random.default_rng(seed)
    jp, tp, (jw_state, _), jstep = plans(win, cap)
    tw = tp.window
    st = None
    rows_seen = 0
    now = 5000
    for i in range(warm + n_steps):
        now += int(rng.integers(*gaps))
        timer = i in timers
        ts, kind, valid, cols = _batch(rng, B, now, timer, mixed=mixed)
        if i == warm:
            st = convert.query_state_from_jax(tp, (jw_state, ()))[0]
        keep = valid & ((kind != ev.CURRENT) | (cols[2] >= 0))
        jrows = JRows(ts=ts, kind=kind, valid=keep,
                      seq=np.zeros(B, np.int64),
                      gslot=np.arange(B, dtype=np.int32) % 5,
                      cols=tuple(cols))
        jw_state, jout = jstep(jw_state, jrows, np.int64(now))
        if i < warm:
            continue
        cur = valid & (kind == ev.CURRENT)
        facts = BatchFacts(ts[cur], B, _Staged(ts, kind, valid, cols), cur)
        prow = Rows(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid), seq=None,
                    gslot=torch.from_numpy(np.arange(B, dtype=np.int32) % 5),
                    cols=tuple(torch.from_numpy(c) for c in cols))
        st, wout = tw.process(st, prow, tp.filter_spec.bind(None), now,
                              facts)
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
        if tp.needs_timer and not getattr(tw, "host_scheduled", False):
            assert int(wout.next_wakeup[0]) == \
                int(np.asarray(jout.next_wakeup)), i
        assert int(wout.next_wakeup[1]) == 0, i
        _same(_state_view(st), _state_view(
            convert.query_state_from_jax(tp, (jw_state, ()))[0]),
            f"step {i} state")
        rows_seen += n
    return rows_seen


@pytest.mark.parametrize("win,timers,gaps,mixed", [
    ("batch()", (4, 7), (0, 400), False),
    ("batch(5)", (), (0, 400), False),
    ("cron('* * * * * ?')", (3, 4, 7, 9), (0, 400), True),
    ("hopping(700, 300)", (5, 8), (0, 400), False),
    ("hoping(900)", (), (0, 2500), False),
], ids=["batch", "batch-length", "cron", "hopping", "hoping-collapsed"])
def test_step_from_a_converted_state(plans, win, timers, gaps, mixed):
    """The port's step (plain K12 chunk / cron, plain K18) from the JAX
    window's converted state gives the JAX step's rows, wake and state,
    step after step: a cron step with a TIMER row flushes the pending rows
    while its own arrivals start the next batch; gaps of several hops
    collapse into one flush."""
    assert _run_steps(plans, win, 2048, 10, timers=timers, gaps=gaps,
                      mixed=mixed) > 0


@pytest.mark.parametrize("check", ["cb1", "cr1", "hp1"])
def test_chip_model_at_a_small_size(check):
    """chip_smoke's CB1, CR1 and HP1 numpy models equal the port's rows
    through SiddhiManager on the CPU, at a small size (CB1's chunks above
    the reference's 512 rows, CR1's fires, HP1's timer hops)."""
    assert getattr(chip_smoke, f"{check}_small_check")(
        np, TorchManager(device="cpu"))


# -- where the port departs, and what raises ---------------------------------

def _sends(mgr, ql, batches):
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback("q", lambda ts, i, o: got.append(
        (len(i or []), len(o or []))))
    rt.start()
    h = rt.get_input_handler("S")
    for rows, ts in batches:
        h.send(rows, timestamp=ts)
    rt.flush()
    mgr.shutdown()
    return got


def test_batch_keeps_a_chunk_above_the_reference_capacity():
    """The reference keeps at most its batch capacity (512 rows) of a
    chunk and replays only those as EXPIRED; the port's chunk buffer grows
    to the chunk, so a chunk of 600 rows leaves whole."""
    ql = """@app:playback
    define stream S (v int);
    @info(name='q') from S#window.batch() select v insert all events into O;
    """
    batches = [([[i] for i in range(600)], 1000), ([[1]], 1100)]
    jax = _sends(JaxManager(), ql, batches)
    port = _sends(TorchManager(device="cpu"), ql, batches)
    assert [c for c, _ in jax] == [c for c, _ in port] == [600, 1]
    assert sum(e for _, e in port) == 600
    assert sum(e for _, e in jax) == 512


@pytest.mark.parametrize("win,rows", [
    ("cron('* * * * * ?')", 1100), ("hopping(2 sec, 1 sec)", 1100)])
def test_a_shortfall_raises(win, rows, caplog):
    """Rows past the window's capacity (max(@capacity(window), 1024)):
    the reference drops them silently; the port counts them and raises
    (the junction logs the error and drops the batch)."""
    ql = f"""@app:playback
    define stream S (v int);
    @capacity(window='16')
    @info(name='q') from S#window.{win} select v insert all events into O;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.start()
    rt.get_input_handler("S").send([[i] for i in range(rows)], timestamp=100)
    assert f"{rows - 1024} rows did not fit the {win.split('(')[0]} " \
        "window's" in caplog.text


@pytest.mark.parametrize("win,exc,match", [
    ("cron()", ValueError, "cron expression"),
    ("cron(v)", ValueError, "cron expression"),
    ("cron('* * *')", ValueError, "bad cron expression"),
    ("hopping()", CompileError, "missing window parameter"),
    ("hopping(v, 1 sec)", CompileError, "constants"),
])
def test_parameters_that_raise(win, exc, match):
    ql = f"""define stream S (v int);
    @info(name='q') from S#window.{win} select v insert into O;"""
    with pytest.raises(exc, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("win", ["batch()", "cron('* * * * * ?')",
                                 "hopping(2 sec, 1 sec)"])
def test_keyed_form_raises_naming_b12(win, one_entry_per_fire_time):
    """Inside a partition these windows are kept per key (kernels K21 and
    K23, `kernels/keyed_ext.py`; once a CompileError naming B12): the port
    gives the JAX package's events, keys interleaved in each send, with
    the timer's ticks over every key."""
    ql = f"""@app:playback
    define stream S (k string, v int);
    partition with (k of S) begin
    @info(name='q') from S#window.{win} select k, v, count() as n
    insert all events into O; end;"""
    sends = [("S", [[k, 10 * i + j] for j, k in enumerate("abcab"[:2 + i % 4])],
              1000 + 700 * i) for i in range(6)]
    want = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    assert sum(len(c) + len(e) for _, c, e in want) > 0
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q",
                                 sends) == want
