"""The port's `session(gap, key, allowed.latency)` window
(`core/window_ext.py` `SessionLatencyWindow`: the plain version of K11's
latency mode) against the JAX package.

Whole apps run through both packages (events exact): the latency cases
of `chip_smoke.X2_CASES` (the shapes of `tests/test_session_latency.py`:
two sessions expiring after their latency, a late arrival that pushes the
previous session's end forward and merges it into the current one, an
arrival too late for both sessions, independent keys, late joins into the
current session) and that file's late arrival into the previous session
in the same batch as the rotation.  Then the keyed step from a JAX state
carried across with `convert.latency_slab_from_jax`, against the window
half of the reference's `kstep`: interleaved keys, arrivals late into the
current session, into the previous one and too late for both, merges,
rotations, timer ticks over every key, padding key rows and a key above
its capacity (the reference drops its rows silently; the port drops the
same rows and counts them).  Tolerance: exact.  Then a session above its
capacity that raises, chip_smoke's SL1 model at a small size, and what
raises.
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
from siddhi_tpu_torch.kernels import keyed_window as kw
from test_torch_keyed_window import K, _batch, _group, _jax_window_half

CASES = [c for c in chip_smoke.X2_CASES if c[0].startswith("latency")]
# the cases whose JAX events are recomputed here (a JAX app of this window
# compiles for seconds; the others' events were computed by the same
# call when chip_smoke's _X10_WANT was written)
_RERUN = ("latency session late merge", "latency session late into current")


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """chip_smoke.py's X2 latency expectations are the JAX package's
    events, and the port gives them on the CPU."""
    if name in _RERUN:
        assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


def _late_into_previous(mgr):
    rt = mgr.create_siddhi_app_runtime("""
    @app:playback
    define stream S (user long, item int);
    @capacity(keys='16')
    @info(name='q') from S#window.session(2 sec, user, 1 sec)
    select user, item insert all events into Out;
    """)
    got = []
    rt.add_callback("q", lambda ts, cur, exp: got.append(
        (ts, [(e.timestamp, tuple(e.data)) for e in (cur or [])],
         [(e.timestamp, tuple(e.data)) for e in (exp or [])])))
    rt.start()
    h = rt.get_input_handler("S")
    h.send([7, 101], timestamp=1000)
    h.send_columns([np.array([7, 7], np.int64),
                    np.array([200, 90], np.int32)],
                   timestamps=np.array([3100, 900], np.int64))
    h.send([8, 0], timestamp=30000)
    h.send([8, 1], timestamp=60000)
    rt.flush()
    mgr.shutdown()
    return got


def test_late_arrival_into_previous_in_the_rotating_batch():
    """One batch rotates the session and carries an arrival older than
    the new session's start - gap: it joins the previous session
    backwards (no merge), which expires with it first in ts order."""
    want = _late_into_previous(JaxManager())
    assert _late_into_previous(TorchManager(device="cpu")) == want
    assert [x for _, _, x in want if x][0] == [(900, (7, 90)),
                                               (1000, (7, 101))]


# -- the keyed step, from a converted slab -----------------------------------

QL = """
@app:playback
define stream S (k long, v float, w int, b bool);
@capacity(keys='{K}', window='{cap}')
@info(name='q') from S[w >= 0]#window.session({gap}, k, {lat})
select k, sum(v) as sv, count() as c insert all events into O;
"""


@pytest.fixture(scope="module")
def plans():
    """The JAX and port plans of each (gap, latency, capacity), built once
    for the module."""
    cache = {}

    def get(gap, lat, cap):
        key = (gap, lat, cap)
        if key not in cache:
            ql = QL.format(K=K, cap=cap, gap=gap, lat=lat)
            jq = JaxManager().create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            cache[key] = (jq.planned, tq.planned, jq.state)
        return cache[key]
    return get


def _same_slab(jslab, slab, types):
    a = convert.latency_slab_from_jax(jslab, types).logical()
    b = slab.logical()
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), k


def _run(plans, steps, gap=300, lat=200, cap=128, warm=1):
    """`warm` steps through the JAX window half alone, its slab carried
    over, then both: each step's rows (key-major), the slab and, on steps
    without padding rows, the least wake.  Returns (rows compared, the
    largest missed count the port reported, the steps' row kinds)."""
    jp, tp, (jslab, _) = plans(gap, lat, cap)
    types = tp.in_schema.types
    slab = None
    n_rows, missed = 0, 0
    for i, (ts, kind, valid, cols, gslot, key_idx, sel, now) in \
            enumerate(steps):
        if i == warm:
            slab = convert.query_state_from_jax(tp, (jslab, ()))[0]
            assert slab.mode == kw.MODE_LATENCY
            _same_slab(jslab, slab, types)
        jslab, jrows, jwake = _jax_window_half(
            jp.window, jslab, ts, kind, valid, gslot, cols, key_idx, sel,
            now)
        if i < warm:
            continue
        out, wake = kw.plain(
            slab, tp.filter_spec, torch.from_numpy(ts),
            torch.from_numpy(kind), torch.from_numpy(valid),
            torch.from_numpy(gslot), [torch.from_numpy(c) for c in cols],
            torch.from_numpy(key_idx), torch.from_numpy(sel), now, gap, lat)
        jts, jkind, jseq, jgs, jcols = jrows
        assert out.ts.numpy().tolist() == jts.tolist(), i
        assert out.kind.numpy().tolist() == jkind.tolist(), i
        assert out.seq.numpy().tolist() == jseq.tolist(), i
        assert out.gslot.numpy().tolist() == jgs.tolist(), i
        for x, y in zip(out.cols, jcols):
            x = x.numpy()
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), i
        if not (key_idx >= K).any():
            assert int(wake[0]) == jwake, i
        _same_slab(jslab, slab, types)
        n_rows += len(jts)
        missed = max(missed, int(wake[1]))
    return n_rows, missed


def _steps(rng, n, B, late=0.0, timer_at=(), pads=0, hot=None, E=16):
    """Steps of B rows over the K keys: every key row in a random order
    (a key without rows in the step still runs its batch-start timeouts),
    `pads` padding rows, each key's rows padded to E columns, so every
    step has one shape (the JAX side compiles once)."""
    steps = []
    now = 1000
    for i in range(n):
        now += int(rng.integers(50, 500))
        if i in timer_at:
            # a TIMER row over every key, in a batch of B rows
            ts = np.zeros(B, np.int64)
            ts[0] = now
            valid = np.arange(B) == 0
            cols = [np.zeros(B, np.int64), np.zeros(B, np.float32),
                    np.zeros(B, np.int32), np.zeros(B, np.bool_)]
            sel = np.full((K, E), -1, np.int32)
            sel[:, 0] = 0
            steps.append((ts, np.full(B, ev.TIMER, np.int32), valid, cols,
                          np.zeros(B, np.int32),
                          np.arange(K, dtype=np.int32), sel, now))
            continue
        kk = rng.integers(0, K, B)
        if hot is not None:
            kk[:hot] = 3
        ts = now - rng.integers(0, 40, B)
        ts = np.where(rng.random(B) < late, ts - rng.integers(100, 1200, B),
                      ts)
        b = _batch(rng, B, kk, ts)
        key_idx, sel = _group(kk, b[2], rng.permutation(K), pads)
        assert sel.shape[1] <= E
        sel = np.pad(sel, ((0, 0), (0, E - sel.shape[1])),
                     constant_values=-1)
        steps.append(b + (key_idx, sel, now))
    return steps


@pytest.mark.parametrize("seed,late,timers", [
    (3, 0.0, (4, 8)), (5, 0.4, (6, 10)), (9, 0.7, (3,))],
    ids=["on-time", "late", "mostly-late"])
def test_keyed_step_from_a_converted_slab(plans, seed, late, timers):
    """Arrivals up to 1.2 s older than their step: into the current
    session, into the previous one (and merging it forward), or dropped;
    rotations, timer ticks over every key."""
    rng = np.random.default_rng(seed)
    rows, _ = _run(plans, _steps(rng, 12, 40, late=late, timer_at=timers))
    assert rows > 0


def test_padding_rows_and_a_key_above_capacity(plans):
    """Padding key rows touch nothing; a key with more rows than its
    capacity (max(@capacity(window), 128) = 128 rows) keeps what fits, as
    the reference does, and the port counts the rest."""
    rng = np.random.default_rng(7)
    _, missed = _run(plans, _steps(rng, 5, 80, pads=2, hot=60, E=72),
                     gap=5000, lat=1000, cap=32)
    assert missed > 0


def test_a_session_above_capacity_raises(caplog):
    """A latency session above its per-key capacity (max(@capacity(window),
    128) = 128 rows): the reference drops the rows silently; the port
    counts them and raises (the junction logs the error)."""
    ql = """
    @app:playback
    define stream S (user string, item int);
    @capacity(keys='16', window='16')
    @info(name='q') from S#window.session(2 sec, user, 1 sec)
    select user, item insert all events into Out;
    """
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.start()
    rt.get_input_handler("S").send([["u", i] for i in range(150)],
                                   timestamp=1000)
    assert "22 rows did not fit the session window's session (per key)" \
        in caplog.text


def test_sl1_model_at_a_small_size():
    """chip_smoke's SL1 numpy model equals the port's rows through
    SiddhiManager on the CPU, at a small size."""
    assert chip_smoke.sl1_small_check(np, TorchManager(device="cpu"))


@pytest.mark.parametrize("ql,exc,match", [
    ("""define stream S (user string, item int);
     from S#window.session(2 sec, user, 3 sec) select user insert into O;""",
     ValueError, "latency"),
    ("""define stream S (user string, item int);
     from S#window.session(2 sec, 5, 1 sec) select user insert into O;""",
     ValueError, "2nd parameter"),
    ("""define stream S (user string, item int);
     partition with (user of S) begin
     from S#window.session(1 sec, user, 500) select user insert into O;
     end;""", CompileError, "redundant"),
])
def test_what_raises(ql, exc, match):
    """latency > gap (the reference's validateAllowedLatency), a session
    key that is not an attribute, and the latency form inside a
    partition, as the JAX package raises them."""
    with pytest.raises(Exception, match=match):
        JaxManager().create_siddhi_app_runtime(ql)
    with pytest.raises(exc, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)
