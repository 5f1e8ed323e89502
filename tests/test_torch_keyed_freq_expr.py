"""The port's keyed `frequent` / `lossyFrequent` (`kernels/keyed_freq.py`:
the plain version of K24) and the expression windows kept per partition
key (`kernels/expr_window.py`: the plain versions of K25 / K26), against
the JAX package.

Whole apps first (events exact): the keyed frequent cases of
`chip_smoke.X12_CASES` (the JAX package's events: every column as the key,
one card, -0.0 / +0.0 / NaN keys, lossyFrequent in a value and a range
partition, @purge), each recomputed on the JAX package.  Then each window's
step from a JAX state carried across with `convert.keyed_slab_from_jax`:
every valid row (ts, kind, seq, group slot, columns), the wake and every
key's state equal to the window half of the JAX `kstep`
(`test_torch_keyed_ext._jax_window_half`, jitted once per window), over
random [Kb, E] batches with keys interleaved, invalid rows, rows the
filter drops, padding key rows, NaN and -0.0 values, TIMER ticks over all
keys and a TIMER row beside a key's arrivals.  The windows: float keys,
a key of one column and of every column, a sum, the clamp at j = hi - C,
runs above C (a key row wider than C) and both batch options.
Tolerance: exact (quarter-valued data: every f64 prefix sum is exact).
Then the round trips of the new conversions, `@purge` on the new slabs,
and chip_smoke's KFQ1 / EW1 / KEB1 numpy models held to the port's rows
at a small size.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_keyed_ext import (_jax_window_half, _plans, _same_state,
                                  _steps)
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core.planner import _keyed_shape
from siddhi_tpu_torch.kernels import expr_window as ew
from siddhi_tpu_torch.kernels import keyed_freq as kf
from siddhi_tpu_torch.kernels import keyed_window as kw

CASES = [c for c in chip_smoke.X12_CASES
         if c[0].split()[0] not in ("top", "value", "range")
         or "Frequent" in c[0]]
JAX_RECHECK = tuple(c[0] for c in CASES)


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """The port gives X4's keyed frequent events (the JAX package's)."""
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


@pytest.mark.parametrize("name", JAX_RECHECK)
def test_corpus_is_the_jax_events(name):
    _, ql, qname, sends, want = next(c for c in CASES if c[0] == name)
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want


# -- the keyed step, from a converted state ----------------------------------

# window -> (slab mode, @capacity(window))
WINDOWS = {
    "frequent(2, v)": (kw.MODE_FREQ, 128),
    "lossyFrequent(0.34, 0.01, k)": (kw.MODE_FREQ, 128),
    "frequent(3)": (kw.MODE_FREQ, 128),
    "expression('sum(v) < 6.0 and count() <= 5')": (kw.MODE_EXPR, 8),
    "expression('first.v < 1.0')": (kw.MODE_EXPR, 4),
    "expressionBatch('count() <= 9')": (kw.MODE_EXPRB, 4),
    "expressionBatch('sum(w) < 20', true, true)": (kw.MODE_EXPRB, 8),
}


def _plain(mode):
    return kf.plain if mode == kw.MODE_FREQ else ew.plain


@pytest.mark.parametrize("win", list(WINDOWS))
def test_step_equals_the_jax_step(win):
    """Every step of the port's plain K24 / K25 / K26 equals the JAX
    kstep's window half, from a state converted after two JAX steps
    (`first.v < 1.0` at a capacity of 4 holds at j = hi - C once a key
    holds 5 rows; a key row of up to 15 events runs past C = 4)."""
    mode, cap = WINDOWS[win]
    jp, tp, (jslab, _) = _plans(win, cap)
    _, _, wkw, _ = _keyed_shape(tp.window, "q")
    prm = wkw["prm"]
    rng = np.random.default_rng(sum(win.encode()))
    slab, rows = None, 0
    for i, (ts, kind, valid, cols, gslot, key_idx, sel, now) in \
            enumerate(_steps(rng, 8)):
        if i == 2:
            slab = convert.keyed_slab_from_jax(jslab, mode,
                                               tp.in_schema.types)
            _same_state(jslab, slab, mode)
        jslab, (jts, jkind, jseq, jgs, jcols), jwake = _jax_window_half(
            jp.window, jslab, ts, kind, valid, gslot, cols, key_idx, sel,
            now)
        if i < 2:
            continue
        out, wake = _plain(mode)(
            slab, tp.filter_spec, torch.from_numpy(ts),
            torch.from_numpy(kind), torch.from_numpy(valid),
            torch.from_numpy(gslot), [torch.from_numpy(c) for c in cols],
            torch.from_numpy(key_idx), torch.from_numpy(sel), now, prm)
        assert out.ts.tolist() == jts.tolist(), i
        assert out.kind.tolist() == jkind.tolist(), i
        assert out.seq.tolist() == jseq.tolist(), i
        assert out.gslot.tolist() == jgs.tolist(), i
        for x, y in zip(out.cols, jcols):
            x = x.numpy()
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), i
        assert wake.tolist() == [jwake, 0]
        _same_state(jslab, slab, mode)
        rows += len(jts)
    assert rows > 0


@pytest.mark.parametrize("win", ["lossyFrequent(0.34, 0.01, k)",
                                 "expression('first.v < 1.0')",
                                 "expressionBatch('count() <= 9')"])
def test_state_round_trip(win):
    """A JAX keyed state carried into the port (`keyed_slab_from_jax`:
    the frequent counters with their keys and stored events, an
    expression window's rows by add_seq, an expressionBatch's previous
    batch of C + 1 rows), out again (`keyed_slab_to_jax`) and back in
    holds what it held."""
    mode, cap = WINDOWS[win]
    jp, tp, (jslab, _) = _plans(win, cap)
    rng = np.random.default_rng(11)
    for ts, kind, valid, cols, gslot, key_idx, sel, now in _steps(rng, 3):
        jslab = _jax_window_half(jp.window, jslab, ts, kind, valid, gslot,
                                 cols, key_idx, sel, now)[0]
    slab = convert.keyed_slab_from_jax(jslab, mode, tp.in_schema.types)
    again = convert.keyed_slab_from_jax(convert.keyed_slab_to_jax(slab),
                                        mode, tp.in_schema.types)
    _same_state(jslab, again, mode)
    lg = convert.keyed_slab_logical(slab, mode)
    assert (lg["f_counts"] if mode == kw.MODE_FREQ else lg["count"]).any()


def test_purge_resets_the_new_slabs():
    """@purge empties a key: its counters free (MODE_FREQ), its rows and
    previous batch gone (MODE_EXPR / MODE_EXPRB), its counter at 0."""
    f = kw.KeyedSlab.empty(kw.MODE_FREQ, ["LONG", "FLOAT"], 4, 3, "cpu",
                           nkeys=2)
    f.f_counts[:] = 2
    f.f_keys[:] = 7
    f.seq[:] = 9
    f.reset_keys(torch.tensor([1, 3]))
    assert f.f_counts[:, 0].tolist() == [2, 0, 2, 0]
    assert f.seq.tolist() == [9, 0, 9, 0]
    assert f.logical()["f_keys"][1].abs().sum() == 0
    c = f.clone()
    c.reset_keys(torch.tensor([0]))
    assert c.f_counts[:, 0].tolist() == [0, 0, 2, 0]
    assert f.f_counts[:, 0].tolist() == [2, 0, 2, 0]
    b = kw.KeyedSlab.empty(kw.MODE_EXPRB, ["INT"], 3, 4, "cpu")
    assert tuple(b.p_ts.shape) == (3, 5)
    b.count[:], b.p_count[:] = 2, 5
    b.reset_keys(torch.tensor([2]))
    assert b.count.tolist() == [2, 2, 0]
    assert b.p_count.tolist() == [5, 5, 0]


def test_configuration_models_hold_at_a_small_size():
    """chip_smoke's KFQ1, EW1 and KEB1 numpy models hold every checked
    row of the port's at 64 keys (counters evicted, trades expiring and
    bills cut each happen)."""
    got = chip_smoke.kf_small_checks(np, lambda: TorchManager(device="cpu"))
    assert all(n > 0 for n in got), got
