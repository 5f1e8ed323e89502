"""The port's keyed window step (the plain version of kernel K11,
`kernels/keyed_window.py`) agrees with the window half of the JAX
package's keyed step `kstep` (`siddhi_tpu/core/planner.py:539-566`: the
gather to [Kb, E], `window.process` under `vmap` over the [K, ...] slab,
the scatter back that drops padding keys, the flattened rows), step by
step, from a state carried across with `convert.keyed_slab_from_jax`.

Inputs come from numpy seeds: several keys interleaved in one batch,
invalid rows and rows the filter drops, a key with more events in one
send than its capacity (and than 64), padding key rows, two keys of a
lengthBatch window flushing in one step, a time window's expiry by a
TIMER tick over all K keys, out-of-order timestamps, and arrivals older
than an in-order ring's survivors.  Tolerance:
exact.  The windows move rows and compute nothing; each step's valid rows
in order (key-major, then each key's seq order), every key's alive rows
and counters, and the wake are compared.  The JAX side takes the least
wake over every key row, padding rows included (a padding row runs on a
clamped copy of key K - 1); the port's skips padding rows, so wakes are
compared on steps without padding rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.window import Buffer as JBuffer
from siddhi_tpu.core.window import Rows as JRows
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.kernels import keyed_window as kw

K = 16
QL = """
@app:playback
define stream S (k long, v float, w int, b bool);
partition with (k of S)
begin
  @capacity(keys='{K}', window='{cap}')
  @info(name='q') from S[w >= 0]#window.{win}
  select k, sum(v) as sv, count() as c insert all events into O;
end;
"""
MODES = {"length": kw.MODE_LENGTH, "time": kw.MODE_TIME,
         "lengthBatch": kw.MODE_BATCH, "timeBatch": kw.MODE_TBATCH}


def _plans(win, cap=128):
    ql = QL.format(K=K, cap=cap, win=win)
    jq = JaxManager().create_siddhi_app_runtime(ql).query_runtimes["q"]
    tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"]
    return jq.planned, tq.planned, jq.state


_JIT = {}


def _jax_window_half(wproc, wslab, ts, kind, valid, gslot, cols, key_idx,
                     sel, now):
    """The window half of the reference's kstep, as written there, with
    its one pre-window filter `w >= 0` (jitted once per window)."""
    fn = _JIT.get(id(wproc))
    if fn is None:
        def half(wslab, ts, kind, valid, gslot, cols, key_idx, sel, now):
            is_cur = kind == ev.CURRENT
            keep = valid & (~is_cur | (cols[2] >= 0))
            sidx = jnp.clip(sel, 0)

            def take(a):
                return a[sidx]
            evalid = jnp.logical_and(sel >= 0, take(keep))
            rows_k = JRows(ts=take(ts), kind=take(kind), valid=evalid,
                           seq=jnp.zeros_like(take(ts)), gslot=take(gslot),
                           cols=tuple(take(c) for c in cols))
            kidx = jnp.clip(key_idx, 0, K - 1)
            st_k = jax.tree.map(lambda x: x[kidx], wslab)
            st_k2, wout = jax.vmap(wproc.process, in_axes=(0, 0, None))(
                st_k, rows_k, now)
            wslab = jax.tree.map(
                lambda s, n: s.at[key_idx].set(n, mode="drop"), wslab,
                st_k2)
            return wslab, wout.rows, jnp.min(wout.next_wakeup)
        fn = _JIT[id(wproc)] = (jax.jit(half), wproc)
    wslab, ork, wake = fn[0](wslab, ts, kind, valid, gslot, tuple(cols),
                             key_idx, sel, np.int64(now))
    live = (key_idx < K)[:, None]
    v = np.asarray(ork.valid) & live
    flat = v.reshape(-1)

    def f(a):
        a = np.asarray(a)
        return a.reshape((-1,) + a.shape[2:])[flat]
    rows = (f(ork.ts), f(ork.kind), f(ork.seq), f(ork.gslot),
            [f(c) for c in ork.cols])
    return wslab, rows, int(np.asarray(wake))


def _batch(rng, B, keys, ts, kinds=None, invalid=0.1, filt=0.1):
    """A batch whose row i belongs to key keys[i] (an int64 column)."""
    B = len(keys)
    kind = np.full(B, ev.CURRENT, np.int32) if kinds is None else kinds
    valid = rng.random(B) >= invalid
    w = np.where(rng.random(B) < filt, -1, rng.integers(0, 9, B))
    cols = [np.asarray(keys, np.int64),
            (rng.integers(0, 64, B) / 64).astype(np.float32),
            w.astype(np.int32), rng.random(B) < 0.5]
    gslot = (np.asarray(keys) % 7).astype(np.int32)
    return np.asarray(ts, np.int64), kind, valid, cols, gslot


def _group(keys, valid, order, pads=0):
    """key_idx / sel as slots_and_group lays them out: one row per key in
    `order`, its batch rows in batch order, -1 after; `pads` padding
    rows (key_idx = K)."""
    rows = [np.nonzero((np.asarray(keys) == k) & valid)[0] for k in order]
    E = max([len(r) for r in rows] + [1])
    sel = np.full((len(order) + pads, E), -1, np.int32)
    for i, r in enumerate(rows):
        sel[i, :len(r)] = r
    key_idx = np.concatenate([np.asarray(order, np.int32),
                              np.full(pads, K, np.int32)])
    return key_idx, sel


def _timer(now, ncols=4):
    B = 8
    ts = np.zeros(B, np.int64)
    ts[0] = now
    kind = np.full(B, ev.TIMER, np.int32)
    valid = np.zeros(B, np.bool_)
    valid[0] = True
    cols = [np.zeros(B, np.int64), np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.zeros(B, np.bool_)]
    return (ts, kind, valid, cols, np.zeros(B, np.int32),
            np.arange(K, dtype=np.int32), np.zeros((K, 1), np.int32))


def _same_state(jslab, slab, mode):
    a = convert.keyed_slab_logical(jslab, mode)
    b = convert.keyed_slab_logical(slab, mode)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), k


def _run(win, steps, cap=128, warm=1):
    """Run `warm` steps through the JAX window half alone, carry its slab
    over, then run the rest through both and compare each step."""
    jp, tp, (jslab, _) = _plans(win, cap)
    mode = MODES[win.split("(")[0]]
    t = getattr(tp.window, "time_ms", 0)
    slab = None
    n_rows = 0
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
            torch.from_numpy(key_idx), torch.from_numpy(sel), now, t)
        jts, jkind, jseq, jgs, jcols = jrows
        assert out.ts.numpy().tolist() == jts.tolist(), i
        assert out.kind.numpy().tolist() == jkind.tolist()
        assert out.seq.numpy().tolist() == jseq.tolist()
        assert out.gslot.numpy().tolist() == jgs.tolist()
        assert bool(out.valid.all())
        for x, y in zip(out.cols, jcols):
            x = x.numpy()
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y)
        if not (key_idx >= K).any():
            assert int(wake[0]) == jwake, i
        _same_state(jslab, slab, mode)
        n_rows += len(jts)
    return n_rows


def _interleaved(rng, n_steps, B, t0=1000, dt=40, spread=30, timer_at=()):
    """Steps of B events over random keys (interleaved), key rows in a
    random order; timer ticks at the listed step indices."""
    steps = []
    for i in range(n_steps):
        now = t0 + dt * i
        if i in timer_at:
            steps.append(_timer(now) + (now,))
            continue
        keys = rng.integers(0, K, B)
        ts = now - rng.integers(0, spread, B)
        b = _batch(rng, B, keys, np.sort(ts))
        order = rng.permutation(np.unique(keys[b[2]]))
        key_idx, sel = _group(keys, b[2], order)
        steps.append(b + (key_idx, sel, int(b[0].max())))
    return steps


@pytest.mark.parametrize("win", ["length(3)", "time(100)",
                                 "lengthBatch(3)"])
def test_interleaved_keys(win):
    rng = np.random.default_rng(3)
    timers = (4, 7) if win.startswith("time") else ()
    steps = _interleaved(rng, 9, 40, timer_at=timers)
    assert _run(win, steps) > 20


def test_time_tick_over_all_keys_expires():
    """A TIMER tick over all K keys expires every key's due rows; a second
    tick at the same time expires nothing."""
    rng = np.random.default_rng(5)
    steps = _interleaved(rng, 3, 48, dt=10)
    steps += [_timer(1200) + (1200,), _timer(1200) + (1200,),
              _timer(5000) + (5000,)]
    assert _run("time(100)", steps) > 48


def test_time_out_of_order_and_equal_timestamps():
    rng = np.random.default_rng(9)
    steps = []
    for i in range(6):
        now = 1000 + 30 * i
        keys = rng.integers(0, 4, 30)
        ts = now - rng.integers(0, 80, 30)          # unsorted, repeats
        b = _batch(rng, 30, keys, ts)
        key_idx, sel = _group(keys, b[2], np.unique(keys[b[2]]))
        steps.append(b + (key_idx, sel, now))
    steps.append(_timer(1300) + (1300,))
    assert _run("time(60)", steps) > 30


def test_time_late_arrivals_after_an_ordered_ring():
    """Rings in timestamp order, then a send in which some keys get one
    arrival older than all their survivors (the least alive ts, so the
    wake, is the late row's), one key gets more sorted arrivals than its
    capacity, all older than its survivors (every survivor drops, the
    oldest arrivals too, and the ring ends in order), and the rest arrive
    in order; then ticks.  `ordered` is part of the compared state."""
    rng = np.random.default_rng(29)
    steps = []
    for i in range(4):
        now = 1000 + 250 * i
        keys = np.repeat(np.arange(K), 4)
        b = _batch(rng, len(keys), keys, np.full(len(keys), now),
                   invalid=0.0, filt=0.0)
        steps.append(b + _group(keys, b[2], rng.permutation(K)) + (now,))
    late = np.arange(6)
    keys = np.concatenate([late, np.full(130, 7), np.arange(8, K)])
    ts = np.concatenate([np.full(6, 1400), 1400 + np.arange(130),
                         np.full(K - 8, 2300)])
    b = _batch(rng, len(keys), keys, ts, invalid=0.0, filt=0.0)
    steps.append(b + _group(keys, b[2], np.unique(keys)) + (2300,))
    steps += [_timer(2400) + (2400,), _timer(2600) + (2600,)]
    assert _run("time(1000)", steps) > 200


@pytest.mark.parametrize("win", ["length(5)", "time(1000)",
                                 "lengthBatch(4)"])
def test_hot_key_above_capacity(win):
    """One key with more events in one send than its capacity (128 for
    the time window) and than 64, beside a few cold keys."""
    rng = np.random.default_rng(13)
    steps = []
    for i in range(3):
        now = 1000 + 10 * i
        keys = np.concatenate([np.full(150, 3), rng.integers(0, K, 20)])
        rng.shuffle(keys)
        b = _batch(rng, len(keys), keys, np.full(len(keys), now),
                   invalid=0.0, filt=0.0)
        order = np.unique(keys)
        key_idx, sel = _group(keys, b[2], order)
        steps.append(b + (key_idx, sel, now))
    assert _run(win, steps, warm=1) > 150


@pytest.mark.parametrize("win", ["length(2)", "time(50)", "lengthBatch(2)"])
def test_padding_key_rows(win):
    """Padding rows (key_idx = K) touch no key; key K - 1 holds rows so a
    clamped write would show."""
    rng = np.random.default_rng(17)
    steps = []
    for i in range(5):
        now = 1000 + 20 * i
        keys = np.concatenate([np.full(3, K - 1), rng.integers(0, K, 12)])
        b = _batch(rng, len(keys), keys, np.full(len(keys), now))
        key_idx, sel = _group(keys, b[2], np.unique(keys[b[2]]),
                              pads=3 if i else 0)
        steps.append(b + (key_idx, sel, now))
    assert _run(win, steps) > 10


def test_length_batch_two_keys_flush_in_one_step():
    """Two keys complete their batches in one send (one of them twice):
    each flush's EXPIRED, RESET and CURRENT rows come out key-major."""
    rng = np.random.default_rng(21)
    k1 = [1, 2, 1, 2, 1]
    steps = []
    b = _batch(rng, 5, k1, np.full(5, 1000), invalid=0.0, filt=0.0)
    steps.append(b + _group(k1, b[2], [1, 2]) + (1000,))
    k2 = [2, 1, 2, 1, 2, 1, 1, 2, 1]
    b = _batch(rng, 9, k2, np.full(9, 1001), invalid=0.0, filt=0.0)
    steps.append(b + _group(k2, b[2], [2, 1]) + (1001,))
    b = _batch(rng, 9, k2, np.full(9, 1002), invalid=0.0, filt=0.0)
    steps.append(b + _group(k2, b[2], [1, 2]) + (1002,))
    assert _run("lengthBatch(2)", steps, warm=1) > 10


def test_empty_slab_roundtrip():
    """An empty JAX slab converts to an empty port slab for every mode."""
    for win, mode in (("length(4)", kw.MODE_LENGTH),
                      ("time(10)", kw.MODE_TIME),
                      ("lengthBatch(3)", kw.MODE_BATCH)):
        _, tp, (jslab, _) = _plans(win)
        slab = convert.keyed_slab_from_jax(jslab, mode, tp.in_schema.types)
        _same_state(jslab, slab, mode)
        fresh = tp.init_state()[0]
        assert isinstance(fresh, kw.KeyedSlab) and fresh.K == K
        assert int(fresh.count.sum()) == 0


@pytest.mark.parametrize("win", ["length(3)", "time(100)",
                                 "lengthBatch(3)", "timeBatch(100)"])
def test_slab_round_trip_to_jax(win):
    """A JAX slab carried to the port (through `query_state_from_jax`) and
    back (`keyed_slab_to_jax`) steps in the JAX package exactly as the
    original: the same rows and the same state after the step."""
    rng = np.random.default_rng(23)
    jp, tp, (jslab, jsel) = _plans(win)
    mode = MODES[win.split("(")[0]]
    steps = _interleaved(rng, 5, 40, timer_at=(3,) if mode in (
        kw.MODE_TIME, kw.MODE_TBATCH) else ())
    def half(slab, st):
        ts, kind, valid, cols, gslot, key_idx, sel, now = st
        return _jax_window_half(jp.window, slab, ts, kind, valid, gslot, cols,
                                key_idx, sel, now)
    for st in steps[:4]:
        jslab = half(jslab, st)[0]
    slab, _ = convert.query_state_from_jax(tp, (jslab, jsel))
    back = convert.keyed_slab_to_jax(slab, getattr(tp.window, "time_ms", 0))
    n_buf = 2 if mode in (kw.MODE_BATCH, kw.MODE_TBATCH) else 1
    back = tuple(jax.tree.map(jnp.asarray, JBuffer(*x))
                 for x in back[:n_buf]) + \
        tuple(jnp.asarray(x) for x in back[n_buf:])
    a, b = half(jslab, steps[4]), half(back, steps[4])
    for x, y in zip(a[1][:4], b[1][:4]):
        assert np.array_equal(x, y)
    for x, y in zip(a[1][4], b[1][4]):
        assert np.array_equal(x, y)
    assert a[2] == b[2]
    _same_state(a[0], convert.keyed_slab_from_jax(
        b[0], mode, tp.in_schema.types), mode)
