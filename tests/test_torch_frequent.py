"""The port's `frequent` and `lossyFrequent` windows (`core/window_ext.py`:
the plain version of K19) against the JAX package.

Whole apps run through both packages (events exact): the corpus cases of
`chip_smoke.X2_CASES` of these kinds (the shapes of
`tests/test_window_ext.py` and `test_window_corpus.py`, every column as
the key, lossyFrequent's error parameter).  Then the step from a JAX
state carried across with `convert.query_state_from_jax`: every step's
rows in seq order and the counters (counts, the keys and stored events of
those in use, the seq counter) equal to the JAX step's, exact, over random
batches with padding rows, rows the filter drops, float keys with -0.0,
+0.0 and NaNs of two payloads, keys of two columns, and a full miss that
evicts a cascade of counters, and the K19 edge cases of
`chip_smoke.FQ_EDGE_CASES`.  Then chip_smoke's FQ1 model at a small
size, the output bound, the parameter lists that raise, and the keyed
forms (kernel K24) against the JAX package's events.
"""
import jax
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
from siddhi_tpu_torch.kernels import frequent as fq

CASES = [c for c in chip_smoke.X2_CASES
         if c[0].split()[0] in ("frequent", "lossyFrequent")]


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
define stream S (k long, v float, w int, b bool);
@info(name='q') from S[w >= 0]#window.{win} select k, v, w
insert all events into O;
"""
# float keys: -0.0 and +0.0, and two NaNs with different payloads
_NAN2 = np.array([0x7fc00001], np.uint32).view(np.float32)[0]
_FLOATS = np.array([-0.0, 0.0, 0.5, -1.5, np.nan, _NAN2], np.float32)


@pytest.fixture(scope="module")
def plans():
    """Each window's JAX and port plans, built once for the module."""
    cache = {}

    def get(win):
        if win not in cache:
            ql = STEP_QL.format(win=win)
            jq = JaxManager().create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
                .query_runtimes["q"]
            # the JAX step jitted once (its scan body compiles once)
            cache[win] = (jq.planned, tq.planned, jq.state,
                          jax.jit(jq.planned.window.process))
        return cache[win]
    return get


def _batch(rng, B, n_keys, edge=None, i=0):
    """A batch of B rows with padding and rows the filter drops; the keys
    uniform over n_keys, or step i's of a K19 edge case."""
    valid = np.arange(B) < rng.integers(B // 2, B + 1)
    keys = rng.integers(0, n_keys, B).astype(np.int64) if edge is None else \
        chip_smoke.fq_edge_keys(np, rng, edge, B, i)
    cols = [keys,
            _FLOATS[rng.integers(0, _FLOATS.shape[0], B)],
            rng.integers(-1, 3, B).astype(np.int32), rng.random(B) < 0.5]
    return np.arange(1000, 1000 + B, dtype=np.int64), valid, cols


def _counters(st):
    """The counters in use, as numpy (floats by their bits)."""
    a = st.alive()
    out = {}
    for k, v in a.items():
        v = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        out[k] = v.view(np.int32) if v.dtype == np.float32 else v
    return out


def _run_steps(plans, win, n_steps, n_keys, B=24, warm=2, seed=0,
               edge=None):
    """`warm` steps through the JAX window alone, its state carried over,
    then `n_steps` through both, each step's rows and the counters
    compared.  Returns the rows compared."""
    rng = np.random.default_rng(seed)
    jp, tp, (jw_state, _), jstep = plans(win)
    tw = tp.window
    st, rows = None, 0
    for i in range(warm + n_steps):
        ts, valid, cols = _batch(rng, B, n_keys, edge, i)
        if i == warm:
            st = convert.query_state_from_jax(tp, (jw_state, ()))[0]
        kind = np.full(B, ev.CURRENT, np.int32)
        jrows = JRows(ts=ts, kind=kind, valid=valid & (cols[2] >= 0),
                      seq=np.zeros(B, np.int64),
                      gslot=np.arange(B, dtype=np.int32) % 5,
                      cols=tuple(cols))
        jw_state, jout = jstep(jw_state, jrows, np.int64(ts[-1]))
        if i < warm:
            continue
        cur = valid.copy()
        facts = BatchFacts(ts[cur], B, None, cur)
        prow = Rows(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid), seq=None,
                    gslot=torch.from_numpy(np.arange(B, dtype=np.int32) % 5),
                    cols=tuple(torch.from_numpy(c) for c in cols))
        st, wout = tw.process(st, prow, tp.filter_spec, int(ts[-1]), facts)
        jo = jout.rows
        n = int(np.asarray(jo.valid).sum())
        out = wout.rows
        assert out.ts.shape[0] == n, (i, out.ts.shape[0], n)
        for f in ("ts", "kind", "seq", "gslot"):
            assert np.array_equal(getattr(out, f).numpy(),
                                  np.asarray(getattr(jo, f))[:n]), (i, f)
        for x, y in zip(out.cols, jo.cols):
            x, y = x.numpy(), np.asarray(y)[:n]
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), i
        want = _counters(convert.query_state_from_jax(
            tp, (jw_state, ()))[0])
        got = _counters(st)
        assert sorted(got) == sorted(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), (i, k)
        rows += n
    return rows


_EDGES = [(w.replace("cardNo", "k"), 0, name)
          for name, w in chip_smoke.FQ_EDGE_CASES]


@pytest.mark.parametrize("win,n_keys,edge", [
    ("frequent(4, k)", 6, None),    # hits, inserts and full misses
    ("frequent(3, v)", 8, None),    # float keys: -0.0 != +0.0, NaN payloads
    ("frequent(5, k, v)", 3, None),     # a key of two columns
    ("frequent(2)", 2, None),       # every column is the key
    ("lossyFrequent(0.25, 0.01, k)", 40, None),  # n = 4; many full misses
] + _EDGES, ids=["int", "float", "two-columns", "every-column", "lossy"] +
    [name.replace(" ", "-") for _, _, name in _EDGES])
def test_step_from_a_converted_state(plans, win, n_keys, edge):
    """The port's step (plain K19) from the JAX window's converted state
    gives the JAX step's rows and counters, step after step; the K19 edge
    cases (chip_smoke.FQ_EDGE_CASES: a full miss mid-group, repeated new
    keys in a group, a full miss evicting every counter, keys colliding in
    the kernel's hash, a batch of only hits) take batches of 64 rows, two
    of the kernel's groups of 32 arrivals."""
    assert _run_steps(plans, win, 6, n_keys, B=24 if edge is None else 64,
                      edge=edge) > 0


def test_full_miss_evicts_a_cascade(plans):
    """Counters all at count 1, then an arrival that misses every one of
    them: all are evicted as EXPIRED rows in counter order, ahead of no
    CURRENT row, and the next arrivals take the freed counters from the
    lowest index."""
    jp, tp, (jw_state, _), jstep = plans("frequent(4, k)")
    st = convert.query_state_from_jax(tp, (jw_state, ()))[0]
    B = 8
    cols = [np.array([5, 6, 7, 8, 9, 10, 11, 5], np.int64),
            np.zeros(B, np.float32), np.zeros(B, np.int32),
            np.zeros(B, np.bool_)]
    ts = np.arange(B, dtype=np.int64) + 100
    kind = np.full(B, ev.CURRENT, np.int32)
    valid = np.ones(B, np.bool_)
    jw_state, jout = jstep(
        jw_state, JRows(ts=ts, kind=kind, valid=valid,
                        seq=np.zeros(B, np.int64),
                        gslot=np.zeros(B, np.int32), cols=tuple(cols)),
        np.int64(200))
    prow = Rows(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                valid=torch.from_numpy(valid), seq=None,
                gslot=torch.zeros(B, dtype=torch.int32),
                cols=tuple(torch.from_numpy(c) for c in cols))
    st, wout = tp.window.process(st, prow, tp.filter_spec, 200,
                                 BatchFacts(ts, B, None, valid))
    out = wout.rows
    kinds = out.kind.tolist()
    # 4 inserts, the miss at row 4 evicts all 4, then 9/10/11 insert at
    # 0/1/2 and 5 at 3
    assert kinds == [ev.CURRENT] * 4 + [ev.EXPIRED] * 4 + [ev.CURRENT] * 3
    assert out.cols[0][4:8].tolist() == [5, 6, 7, 8]
    assert out.seq[4:8].tolist() == [4 * 5 + j for j in range(4)]
    n = int(np.asarray(jout.rows.valid).sum())
    assert out.seq.tolist() == np.asarray(jout.rows.seq)[:n].tolist()
    assert st.counts.tolist() == [1, 1, 1, 0]


def test_the_output_is_sized_by_the_bound():
    """A step emits at most 3A + n rows (A arrivals): the kernel's output
    bound, not the reference's A * (n + 1) grid.  Held on the plain
    version's worst cases: every arrival a hit, and alternating inserts
    and full misses."""
    n = 3
    for keys in ([1] * 12, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]):
        A = len(keys)
        st = fq.FreqState(torch.zeros(n, dtype=torch.int64),
                          torch.zeros((n, 1), dtype=torch.int64),
                          torch.zeros(n, dtype=torch.int64),
                          torch.zeros(n, dtype=torch.int32),
                          [torch.zeros(n, dtype=torch.int64)],
                          torch.zeros(1, dtype=torch.int64))
        arr = Rows(ts=torch.arange(A), kind=None, valid=None,
                   seq=torch.arange(A), gslot=torch.zeros(A,
                                                          dtype=torch.int32),
                   cols=(torch.tensor(keys, dtype=torch.int64),))
        out = fq.plain(st, arr, torch.tensor([A]), [0])
        assert out.ts.shape[0] <= 3 * A + n


def test_fq1_model_at_a_small_size():
    """chip_smoke's FQ1 numpy model (Misra-Gries over the purchases that
    pass the filter) equals the port's rows through SiddhiManager on the
    CPU, at a small size."""
    assert chip_smoke.fq1_small_check(np, TorchManager(device="cpu"))


@pytest.mark.parametrize("win,exc,match", [
    ("lossyFrequent(0.0)", ValueError, "support"),
    ("lossyFrequent(1.0, k)", ValueError, "support"),
    ("lossyFrequent(k)", ValueError, "support fraction"),
    ("frequent(2, 7)", ValueError, "parameter 1 must be an attribute"),
    ("frequent()", CompileError, "missing window parameter"),
])
def test_parameters_that_raise(win, exc, match):
    ql = f"""define stream S (k long, v float, w int, b bool);
    @info(name='q') from S#window.{win} select k insert into O;"""
    with pytest.raises(exc, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)


@pytest.mark.parametrize("win", ["frequent(2, v)", "lossyFrequent(0.1)"])
def test_keyed_form_raises_naming_b12(win):
    """Inside a partition these windows are kept per key (kernel K24,
    `kernels/keyed_freq.py`; once a CompileError naming B12): the port
    gives the JAX package's events, keys interleaved in each send."""
    ql = f"""@app:playback
    define stream S (k long, v float, w int, b bool);
    partition with (k of S) begin
    @info(name='q') from S#window.{win} select k, v, w
    insert all events into O; end;"""
    rng = np.random.default_rng(3)
    sends = [("S", [[int(rng.integers(0, 3)), float(rng.integers(0, 3)),
                     int(rng.integers(0, 9)), bool(rng.random() < 0.5)]
                    for _ in range(6)], 1000 + i) for i in range(4)]
    want = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    assert any(o for _, _, o in want)
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q",
                                 sends) == want
