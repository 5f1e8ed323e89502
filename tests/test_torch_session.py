"""The port's session windows (`core/window_ext.py` `SessionWindow`: the
plain version of K11's session mode) against the JAX package.

Whole apps run through both packages (events exact): the session cases of
`chip_smoke.X2_CASES` (the shapes of `tests/test_window_ext.py`,
`test_session_matrix.py` and `test_session_keyed.py`: late joins that
sort first, arrivals too late to join, a start that moves back, the gap
counted from the last arrival, per-key sessions outside a partition with
and without group by, `session(gap)` in a partition).  Then the keyed
step from a JAX slab carried across with `convert.keyed_slab_from_jax`,
against the window half of the reference's `kstep`: keys interleaved,
late and too-late arrivals, timer ticks over every key, padding key rows
and a key above its capacity (the reference drops its rows silently; the
port drops the same rows and counts them).  Tolerance: exact.  Then what
raises.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.exceptions import CompileError
from siddhi_tpu_torch.kernels import keyed_window as kw
from test_torch_keyed_window import (K, _batch, _group, _jax_window_half,
                                     _plans, _same_state, _timer)

CASES = [c for c in chip_smoke.X2_CASES if c[0].startswith("session")]


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """chip_smoke.py's X2 session expectations are the JAX package's
    events, and the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


def _run(steps, gap=300, cap=128, warm=1):
    """`warm` steps through the JAX window half alone, its slab carried
    over, then both: each step's rows (key-major), the slab and, on steps
    without padding rows, the least wake.  Returns (rows compared, the
    largest missed count the port reported)."""
    jp, tp, (jslab, _) = _plans(f"session({gap})", cap)
    mode = kw.MODE_SESSION
    slab = None
    n_rows, missed = 0, 0
    for i, (ts, kind, valid, cols, gslot, key_idx, sel, now) in \
            enumerate(steps):
        if i == warm:
            slab = convert.keyed_slab_from_jax(jslab, mode,
                                               tp.in_schema.types)
            _same_state(jslab, slab, mode)
        jslab, jrows, jwake = _jax_window_half(
            jp.window, jslab, ts, kind, valid, gslot, cols, key_idx, sel,
            now)
        if i < warm:
            continue
        out, wake = kw.plain(
            slab, tp.filter_spec, torch.from_numpy(ts),
            torch.from_numpy(kind), torch.from_numpy(valid),
            torch.from_numpy(gslot), [torch.from_numpy(c) for c in cols],
            torch.from_numpy(key_idx), torch.from_numpy(sel), now, gap)
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
        _same_state(jslab, slab, mode)
        n_rows += len(jts)
        missed = max(missed, int(wake[1]))
    return n_rows, missed


def _steps(rng, n, B, late=0.0, timer_at=(), pads=0, hot=None):
    steps = []
    now = 1000
    for i in range(n):
        now += int(rng.integers(50, 500))
        if i in timer_at:
            steps.append(_timer(now) + (now,))
            continue
        keys = rng.integers(0, K, B)
        if hot is not None:
            keys[:hot] = 3
        ts = now - rng.integers(0, 40, B)
        ts = np.where(rng.random(B) < late, ts - rng.integers(100, 900, B),
                      ts)
        b = _batch(rng, B, keys, ts)
        order = rng.permutation(np.unique(keys[b[2]]))
        key_idx, sel = _group(keys, b[2], order, pads)
        steps.append(b + (key_idx, sel, now))
    return steps


def test_keyed_sessions_from_a_converted_slab():
    """Interleaved keys whose sessions live on and expire at the steps'
    `now` and at timer ticks over every key."""
    rng = np.random.default_rng(3)
    rows, _ = _run(_steps(rng, 12, 40, timer_at=(4, 8)))
    assert rows > 0


def test_late_and_too_late_arrivals():
    """Arrivals up to 900 ms older than their step: those at or after a
    live session's start - gap join it (and sort first on expiry), older
    ones are dropped."""
    rng = np.random.default_rng(5)
    rows, _ = _run(_steps(rng, 12, 40, late=0.3, timer_at=(6, 10)))
    assert rows > 0


def test_padding_rows_and_a_key_above_capacity():
    """Padding key rows touch nothing; a key with more rows than its
    capacity (max(@capacity(window), 128) = 128 rows) keeps what fits, as
    the reference does, and the port counts the rest."""
    rng = np.random.default_rng(7)
    _, missed = _run(_steps(rng, 5, 80, pads=2, hot=60), gap=5000, cap=32)
    assert missed > 0


def test_top_level_session_is_one_key():
    """session(gap) outside a partition runs K11's session mode on a slab
    of one key: the JAX SessionWindow's state converts into it, late
    arrival first in ts and the session's start pulled back."""
    ql = """
    @app:playback
    define stream S (user string, item int);
    @info(name='q') from S#window.session(1 sec)
    select user, item insert all events into Out;
    """
    jm = JaxManager()
    jrt = jm.create_siddhi_app_runtime(ql)
    jrt.start()
    h = jrt.get_input_handler("S")
    for i, t in enumerate((1000, 1200, 900, 1500)):
        h.send(["u", i], timestamp=t)
    jrt.flush()
    jq = jrt.query_runtimes["q"]
    tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"]
    slab = convert.query_state_from_jax(tq.planned, jq.state)[0]
    assert slab.K == 1 and slab.mode == kw.MODE_SESSION
    lg = slab.logical()
    assert lg["count"].tolist() == [4]
    assert lg["ts"][0, :4].tolist() == [1000, 1200, 900, 1500]
    assert slab.key_state["start"].tolist() == [900]
    assert slab.key_state["last"].tolist() == [1500]


@pytest.mark.parametrize("ql,match", [
    ("""define stream S (user string, item int);
     partition with (user of S) begin
     from S#window.session(1 sec, user) select user insert into O; end;""",
     "redundant"),
    ("""define stream S (user string, item int);
     partition with (user of S) begin
     from S#window.session(1 sec, user, 500) select user insert into O;
     end;""", "redundant"),
    ("""define stream S (user string, item int);
     define window W (user string, item int) session(1 sec, user);""",
     "define window"),
])
def test_what_raises(ql, match):
    with pytest.raises(CompileError, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


def test_session_key_must_be_an_attribute():
    ql = """define stream S (user string, item int);
    from S#window.session(1 sec, 5) select user insert into O;"""
    with pytest.raises(ValueError, match="parameter 1 must be an attribute"):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)
