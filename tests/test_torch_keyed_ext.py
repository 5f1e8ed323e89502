"""The port's keyed windows of K20-K23 (`kernels/keyed_ext.py`, their plain
versions): `externalTime`, `timeLength`, `delay`, `externalTimeBatch`,
`batch`, `cron`, `sort` and `hopping` kept per partition key, against the
JAX package.

Whole apps first (events exact): `chip_smoke.X11_CASES` holds the JAX
package's events of the keyed corpus (each kind inside a value partition
with several keys a send, group by and having, a filter after the window,
nulls, range partitions, @purge, timer-driven keys); the port gives them,
and a few are recomputed on the JAX package here (cron with the JAX
scheduler's timer entries deduplicated, as the port keeps them).  Then
each window's step from a JAX state carried across with
`convert.keyed_slab_from_jax`: every valid row (ts, kind, seq, group slot,
columns), the wake and every key's alive rows and counters equal to the
window half of the JAX `kstep`, over random [Kb, E] batches with keys
interleaved, invalid rows, rows the filter drops, padding key rows, TIMER
ticks over all keys and a TIMER row beside a key's arrivals.  Tolerance:
exact (the windows move rows and compute nothing).  The JAX side takes the
least wake over every key row, padding rows included; the port's skips
them, so wakes are compared on steps without padding rows.  Then the
places the port departs from the reference on purpose (a chunk above 64
rows a key kept whole; event times that overflow the reference's
survivor key; rows past a key's capacity raise), a state carried across
mid-stream through `convert.query_state_from_jax`, the RESET epochs
across keys, `@purge` on the new slabs, and chip_smoke's KX1 / KXB1 /
KSO1 / KHP1 models held to the port's rows at a small size.
"""
import jax
import jax.numpy as jnp
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
from siddhi_tpu_torch.core.planner import _keyed_shape
from siddhi_tpu_torch.kernels import keyed_ext as ke
from siddhi_tpu_torch.kernels import keyed_window as kw

CASES = chip_smoke.X11_CASES
JAX_RECHECK = ("keyed externalTime", "keyed batch", "keyed cron",
               "keyed hopping")


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
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """The port gives X3's events (the JAX package's) on the CPU."""
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


@pytest.mark.parametrize("name", JAX_RECHECK)
def test_corpus_is_the_jax_events(name, one_entry_per_fire_time):
    """X3's expectations are the JAX package's events (recomputed for a
    few cases)."""
    _, ql, qname, sends, want = next(c for c in CASES if c[0] == name)
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want


def test_reset_epochs_count_across_keys():
    """A RESET row of one key's batch flush starts a new epoch for every
    key whose rows follow it in the step (`siddhi_tpu/core/selector.py:
    331-334`): key a's EXPIRED rows after key b's flush count from zero
    (-1, -2), as the reference gives them."""
    _, ql, qname, sends, want = next(c for c in CASES
                                     if c[0] == "keyed batch")
    got = chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname, sends)
    assert got == want
    assert [r for _, _, o in got for _, r in o][-3:] == \
        [("a", -1), ("a", -2), ("b", -1)]


# -- the step, from a converted state ----------------------------------------

K = 16
STEP_QL = """
@app:playback
define stream S (k long, et long, v float, w int, b bool);
partition with (k of S)
begin
  @capacity(keys='{K}', window='{cap}')
  @info(name='q') from S[w >= 0]#window.{win}
  select k, v, w insert all events into O;
end;
"""
WINDOWS = {
    "externalTime(et, 300)": kw.MODE_EXT,
    "timeLength(200, 4)": kw.MODE_TLEN,
    "delay(150)": kw.MODE_DELAY,
    "externalTimeBatch(et, 300)": kw.MODE_XBATCH,
    "externalTimeBatch(et, 300, 950)": kw.MODE_XBATCH,
    "batch()": kw.MODE_CHUNK,
    "cron('* * * * * ?')": kw.MODE_CRON,
    "sort(3, v, 'desc')": kw.MODE_SORT,
    "sort(2, w)": kw.MODE_SORT,
    "hopping(400, 150)": kw.MODE_HOP,
}


def _plans(win, cap=128):
    ql = STEP_QL.format(K=K, cap=cap, win=win)
    jq = JaxManager().create_siddhi_app_runtime(ql).query_runtimes["q"]
    tq = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"]
    return jq.planned, tq.planned, jq.state


def _jax_window_half(wproc, wslab, ts, kind, valid, gslot, cols, key_idx,
                     sel, now):
    """The window half of the reference's kstep, as written there, with
    its one pre-window filter `w >= 0`."""
    fn = _JIT.get(id(wproc))
    if fn is not None:
        return _flat(fn[0](wslab, ts, kind, valid, gslot, tuple(cols),
                           key_idx, sel, np.int64(now)), key_idx)

    def half(wslab, ts, kind, valid, gslot, cols, key_idx, sel, now):
        is_cur = kind == ev.CURRENT
        keep = valid & (~is_cur | (cols[3] >= 0))
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
            lambda s, n: s.at[key_idx].set(n, mode="drop"), wslab, st_k2)
        return wslab, wout.rows, jnp.min(wout.next_wakeup)
    # jitted once per window (the plan keeps it alive)
    _JIT[id(wproc)] = (jax.jit(half), wproc)
    return _jax_window_half(wproc, wslab, ts, kind, valid, gslot, cols,
                            key_idx, sel, now)


_JIT = {}


def _flat(res, key_idx):
    wslab, ork, wake = res
    live = (key_idx < K)[:, None]
    flat = (np.asarray(ork.valid) & live).reshape(-1)

    def f(a):
        a = np.asarray(a)
        return a.reshape((-1,) + a.shape[2:])[flat]
    return wslab, (f(ork.ts), f(ork.kind), f(ork.seq), f(ork.gslot),
                   [f(c) for c in ork.cols]), int(np.asarray(wake))


def _same_state(jslab, slab, mode):
    a = convert.keyed_slab_logical(jslab, mode)
    b = convert.keyed_slab_logical(slab, mode)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), k


def _steps(rng, n_steps, pads_at=(1, 4), tick_at=(3,), fire_at=(5,),
           drops=0.15):
    """Random keyed steps: B events over 8 of the K keys (6 and 2 padding
    rows at `pads_at`; key rows in a random order), ts 40 apart with
    jitter, event times jittered further (out of order), v in quarters
    (some NaN, -0), w of -1 (the filter drops the row) at the rate
    `drops`, invalid rows; a TIMER tick over all K keys at `tick_at`; at
    `fire_at` a valid TIMER row at row 0 beside each key row's arrivals.
    Every data step's sel is [8, 16], so the JAX step compiles twice."""
    steps = []
    for i in range(n_steps):
        now = 1000 + 90 * i
        if i in tick_at:
            B = 8
            ts = np.zeros(B, np.int64)
            ts[0] = now
            kind = np.full(B, ev.TIMER, np.int32)
            valid = np.zeros(B, np.bool_)
            valid[0] = True
            cols = [np.zeros(B, np.int64), np.zeros(B, np.int64),
                    np.zeros(B, np.float32), np.zeros(B, np.int32),
                    np.zeros(B, np.bool_)]
            steps.append((ts, kind, valid, cols, np.zeros(B, np.int32),
                          np.arange(K, dtype=np.int32),
                          np.zeros((K, 1), np.int32), now))
            continue
        B = 24
        pads = 2 if i in pads_at else 0
        nk = 8 - pads
        keys = rng.integers(0, nk, B)
        ts = now - rng.integers(0, 60, B)
        v = (rng.integers(-8, 8, B) / 4).astype(np.float32)
        v[rng.random(B) < 0.1] = np.nan
        v[rng.random(B) < 0.1] = -0.0
        w = np.where(rng.random(B) < drops, -1, rng.integers(0, 9, B))
        cols = [keys.astype(np.int64), ts - rng.integers(0, 250, B),
                v, w.astype(np.int32), rng.random(B) < 0.5]
        kind = np.full(B, ev.CURRENT, np.int32)
        valid = rng.random(B) >= 0.1
        order = rng.permutation(nk)
        rows = [np.nonzero((keys == k) & valid)[0] for k in order]
        E = 15
        assert max(len(r) for r in rows) <= E
        sel = np.full((8, E), -1, np.int32)
        for j, r in enumerate(rows):
            sel[j, :len(r)] = r
        key_idx = np.r_[order, np.full(pads, K)].astype(np.int32)
        gslot = (keys % 5).astype(np.int32)
        if i in fire_at:
            ts, kind, valid = np.r_[now, ts], np.r_[ev.TIMER, kind], \
                np.r_[True, valid]
            cols = [np.r_[np.zeros(1, c.dtype), c] for c in cols]
            gslot = np.r_[0, gslot].astype(np.int32)
            sel = np.c_[np.zeros(sel.shape[0], np.int32),
                        np.where(sel >= 0, sel + 1, -1)].astype(np.int32)
        else:
            sel = np.c_[sel, np.full(sel.shape[0], -1, np.int32)]
        steps.append((ts.astype(np.int64), kind.astype(np.int32), valid,
                      cols, gslot, key_idx, sel, now))
    return steps


@pytest.mark.parametrize("win", list(WINDOWS))
def test_step_equals_the_jax_step(win):
    """Every step of the port's plain K20-K23 equals the JAX kstep's window
    half, from a state converted after two JAX steps.  timeLength's steps
    hold no row that is not a kept arrival before one (a row the filter
    drops, a TIMER row; see
    test_time_length_filtered_rows_reference_defect)."""
    jp, tp, (jslab, _) = _plans(win)
    mode = WINDOWS[win]
    _, _, wkw, key_init = _keyed_shape(tp.window, "q")
    prm = wkw["prm"]
    rng = np.random.default_rng(sum(win.encode()))
    # timeLength: no row before a kept arrival that is not one
    clean = dict(drops=0, fire_at=()) if mode == kw.MODE_TLEN else {}
    slab, rows = None, 0
    for i, (ts, kind, valid, cols, gslot, key_idx, sel, now) in \
            enumerate(_steps(rng, 8, **clean)):
        if i == 2:
            slab = convert.keyed_slab_from_jax(
                jslab, mode, tp.in_schema.types, key_init=key_init)
            _same_state(jslab, slab, mode)
        jslab, (jts, jkind, jseq, jgs, jcols), jwake = _jax_window_half(
            jp.window, jslab, ts, kind, valid, gslot, cols, key_idx, sel,
            now)
        if i < 2:
            continue
        out, wake = ke.plain(
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
        if not (key_idx >= K).any():
            assert int(wake[0]) == jwake, i
        assert int(wake[1]) == 0
        _same_state(jslab, slab, mode)
        rows += len(jts)
    assert rows > 0


def _sort_steps(rng, n_steps, counts, drops):
    """Keyed steps of K22's shapes: key row j holds counts[j] events of
    key j (a random key order), so E = max(counts) every step; v in
    quarters with NaN, -0, +inf and -inf (each ties the dead places under
    one order); w = -1 (the filter drops the event, a place left dead
    between arrivals) at the rate `drops`."""
    steps = []
    E = max(counts)
    for i in range(n_steps):
        now = 1000 + 90 * i
        order = rng.permutation(len(counts))
        keys = np.concatenate([np.full(c, order[j]) for j, c in
                               enumerate(counts)])
        B = keys.shape[0]
        perm = rng.permutation(B)
        keys = keys[perm]
        v = (rng.integers(-8, 8, B) / 4).astype(np.float32)
        m = rng.random(B)
        v[m < 0.05] = np.nan
        v[(m >= 0.05) & (m < 0.1)] = -0.0
        v[(m >= 0.1) & (m < 0.15)] = np.inf
        v[(m >= 0.15) & (m < 0.2)] = -np.inf
        w = np.where(rng.random(B) < drops, -1, rng.integers(0, 9, B))
        ts = np.full(B, now, np.int64)
        cols = [keys.astype(np.int64), ts.copy(), v, w.astype(np.int32),
                rng.random(B) < 0.5]
        sel = np.full((len(counts), E), -1, np.int32)
        for j, k in enumerate(order):
            r = np.nonzero(keys == k)[0]
            sel[j, :len(r)] = r
        steps.append((ts, np.full(B, ev.CURRENT, np.int32),
                      np.ones(B, np.bool_), cols, (keys % 5).astype(np.int32),
                      order.astype(np.int32), sel, now))
    return steps


SORT_EDGES = [
    ("C + E = 32", "sort(16, v)", [16, 16, 9, 16, 3, 16], 5, 0.1),
    ("C + E = 33", "sort(1, v, 'desc')", [32, 30, 32, 7], 3, 0.1),
    ("C + E = 80, full rows beside short ones", "sort(64, v)",
     [16, 1, 16, 1, 16], 8, 0.1),
    ("C + E = 200, full rows beside short ones", "sort(184, v, 'desc')",
     [16, 16, 16, 1], 18, 0.1),
    ("just above the warp limit", f"sort({ke.SORT_LIMIT - 31}, v)",
     [32, 32], 9, 0.0),
    ("a hot key row", "sort(3, v, 'desc')", [300, 2, 5, 1, 3], 3, 0.1),
]


@pytest.mark.parametrize("win,counts,n_steps,drops",
                         [c[1:] for c in SORT_EDGES],
                         ids=[c[0] for c in SORT_EDGES])
def test_sort_step_at_the_mode_edges(win, counts, n_steps, drops):
    """The plain sort step (K22's reference) against the JAX kstep's
    window half at the edges of the kernel's modes: C + E = 32 and 33
    places (one and two candidates a lane), 80 and 200 places (a kept mask
    narrower than the lanes' bucket) with short rows beside full ones, a
    full slab of SORT_LIMIT - 31
    rows with 32 arrivals (SORT_LIMIT + 1 candidates: block mode), and a
    hot key row of 300 events among small ones.  Every row, the wake and
    every key's alive rows equal, from an empty state on."""
    jp, tp, (jslab, _) = _plans(win)
    _, _, wkw, key_init = _keyed_shape(tp.window, "q")
    slab = convert.keyed_slab_from_jax(jslab, kw.MODE_SORT,
                                       tp.in_schema.types, key_init=key_init)
    rng = np.random.default_rng(len(win) + sum(counts))
    rows = 0
    for i, (ts, kind, valid, cols, gslot, key_idx, sel, now) in \
            enumerate(_sort_steps(rng, n_steps, counts, drops)):
        jslab, (jts, jkind, jseq, jgs, jcols), jwake = _jax_window_half(
            jp.window, jslab, ts, kind, valid, gslot, cols, key_idx, sel,
            now)
        out, wake = ke.plain(
            slab, tp.filter_spec, torch.from_numpy(ts),
            torch.from_numpy(kind), torch.from_numpy(valid),
            torch.from_numpy(gslot), [torch.from_numpy(c) for c in cols],
            torch.from_numpy(key_idx), torch.from_numpy(sel), now,
            wkw["prm"])
        assert out.ts.tolist() == jts.tolist(), i
        assert out.kind.tolist() == jkind.tolist(), i
        assert out.seq.tolist() == jseq.tolist(), i
        assert out.gslot.tolist() == jgs.tolist(), i
        for x, y in zip(out.cols, jcols):
            x = x.numpy()
            if x.dtype.kind == "f":
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), i
        assert int(wake[0]) == jwake and int(wake[1]) == 0, i
        _same_state(jslab, slab, kw.MODE_SORT)
        rows += len(jts)
    assert rows > 0 and int(slab.count.max()) == slab.C


@pytest.mark.parametrize("C,E,Kb,want", [
    (10, 16, 65536, (False, 0, 0, 1)),
    (1, 32, 100, (False, 0, 0, 2)),
    (64, 16, 100, (False, 0, 0, 3)),
    (184, 16, 100, (False, 0, 0, 7)),
    (ke.SORT_LIMIT - 32, 32, 100, (False, 0, 0, ke.SORT_LIMIT // 32)),
    (ke.SORT_LIMIT - 31, 32, 100,
     (True, 100, ke.SORT_LIMIT + 1, ke.SORT_LIMIT // 32 + 1)),
    (10, 16384, 65536, (True, ke.SORT_HOT_GRID, 16394, 513)),
])
def test_sort_plan_from_capacity_and_width(C, E, Kb, want):
    """K22's host-side choices: block mode only where a key row's C + E
    candidates can pass the warp limit (32 lanes x SORT_R), its blocks
    and their workspace of C + E keys, and the kept-mask words a row:
    ceil((C + E) / 32), which may be fewer than the lanes' bucket of 4 or
    8 words (C + E = 80, 200), so a row stores only its own words."""
    assert ke.SORT_LIMIT == 32 * ke.SORT_R
    sp = ke.sort_plan(C, E, Kb)
    assert (sp.block, sp.hot_grid, sp.ws_words, sp.mwords) == want


@pytest.mark.parametrize("win", ["externalTime(et, 300)",
                                 "externalTimeBatch(et, 300, 950)",
                                 "sort(3, v, 'desc')", "hopping(400, 150)"])
def test_state_carries_across_mid_stream(win):
    """A JAX runtime's state (its keyed slab, the partition's key
    allocator, the selector) carried into the port's runtime with
    `convert.query_state_from_jax` mid-stream: both runtimes then give the
    same events."""
    ql = STEP_QL.format(K=K, cap=128, win=win).replace(
        "select k, v, w", "select k, v, w, count() as n")
    rng = np.random.default_rng(7)
    sends = []
    for i in range(8):
        n = 12
        sends.append([[int(rng.integers(0, 6)), 1000 + 90 * i -
                       int(rng.integers(0, 200)),
                       float(rng.integers(0, 8)) / 4, int(rng.integers(0, 9)),
                       bool(rng.random() < 0.5)] for _ in range(n)])
    jm = JaxManager()
    jrt = jm.create_siddhi_app_runtime(ql)
    jgot = []
    jrt.add_callback("q", lambda ts, i, o: jgot.append((i, o)))
    jrt.start()
    for i in range(4):
        jrt.get_input_handler("S").send(sends[i], timestamp=1000 + 90 * i)
    jrt.flush()
    tm = TorchManager(device="cpu")
    trt = tm.create_siddhi_app_runtime(ql)
    tq, jq = trt.query_runtimes["q"], jrt.query_runtimes["q"]
    tq.state = convert.query_state_from_jax(tq.planned, jq.state)
    convert._copy_allocator(tq.planned.window_key_allocator,
                            jq.planned.window_key_allocator)
    if tq.planned.slot_allocator is not None:
        convert._copy_allocator(tq.planned.slot_allocator,
                                jq.planned.slot_allocator)
    # the JAX runtime's pending timer entries for the query, too
    for t, _, q in list(jrt._scheduler._heap):
        if q is jq:
            trt._scheduler.notify_at(t, tq)
    tgot = []
    trt.add_callback("q", lambda ts, i, o: tgot.append((i, o)))
    trt.start()
    jgot.clear()
    for i in range(4, 8):
        for rt in (jrt, trt):
            rt.get_input_handler("S").send(sends[i], timestamp=1000 + 90 * i)
    jrt.flush()
    trt.flush()

    def plain(got):
        return [([(e.timestamp, tuple(e.data)) for e in i or []],
                 [(e.timestamp, tuple(e.data)) for e in o or []])
                for i, o in got]
    assert plain(tgot) == plain(jgot)
    assert tgot
    jm.shutdown()
    tm.shutdown()


# -- where the port departs from the reference on purpose --------------------

def test_batch_chunk_above_the_reference_capacity_is_kept_whole():
    """The reference keeps at most 64 rows of a key's chunk (its batch
    capacity inside a partition) and drops the rest silently; the port's
    slab grows to the widest key row, so the next chunk expires all 100
    rows of the key.  Reference defect, not copied."""
    ql = """@app:playback
    define stream S (k string, v int);
    partition with (k of S) begin
    @info(name='q') from S#window.batch() select k, v
    insert all events into Out; end;"""
    sends = [("S", [["a", i] for i in range(100)] + [["b", 1]], 1000),
             ("S", [["a", 100], ["b", 2]], 1100)]
    port = chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q", sends)
    jax_ = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    assert [len(c) for _, c, _ in port] == [101, 2]
    assert [len(e) for _, _, e in port] == [0, 101]
    assert [len(e) for _, _, e in jax_][1] == 65
    assert [c for _, c, _ in port] == [c for _, c, _ in jax_]


def test_time_length_filtered_rows_reference_defect():
    """The reference's timeLength maps the k-th kept arrival of a key to
    the k-th of the key's gathered rows (`phys`,
    `siddhi_tpu/core/window_ext.py:316-318`), which is another row when a
    row before it failed the filter: its eviction then carries the dropped
    row's columns and its buffer keeps the dropped row (a TIMER row beside
    the key's arrivals does the same).  The port takes the k-th kept
    arrival, as the top-level port (K16) does.  Reference defect, not
    copied."""
    ql = """@app:playback
    define stream S (k string, v int);
    partition with (k of S) begin
    @info(name='q') from S[v >= 0]#window.timeLength(1 sec, 2)
    select k, v insert all events into Out; end;"""
    sends = [("S", [["a", -1], ["a", 1], ["a", 2], ["a", 3]], 1000),
             ("S", [["a", 4]], 1100)]
    port = chip_smoke.corpus_run(TorchManager(device="cpu"), ql, "q", sends)
    jax_ = chip_smoke.corpus_run(JaxManager(), ql, "q", sends)
    cur = [[r for _, r in c] for _, c, _ in port]
    exp = [[r for _, r in e] for _, _, e in port]
    assert cur == [[("a", 1), ("a", 2), ("a", 3)], [("a", 4)]]
    assert exp == [[("a", 1)], [("a", 2)]]
    assert [[r for _, r in e] for _, _, e in jax_] == [[("a", -1)],
                                                       [("a", 1)]]
    assert [[r for _, r in c] for _, c, _ in jax_] == cur


def test_external_time_event_time_overflow():
    """The reference orders a key's survivors by `ets * (C + 2B) + pos`
    (`siddhi_tpu/core/window_ext.py:124-127`); with event times in epoch
    microseconds and a key of 2,048 rows that passes BIG_SEQ, kept rows
    sort after dead ones and rows due to expire are lost.  The port
    compares the pair: at that capacity it gives the JAX package's events
    at the default one."""
    base = 1_760_000_000_000_000
    ql = """@app:playback
    define stream S (k long, eventTime long, v int);
    partition with (k of S) begin
    @capacity(keys='2'{cap})
    @info(name='q') from S#window.externalTime(eventTime, 1000000)
    select v, sum(v) as total insert all events into Out; end;"""
    sends = [("S", [[7, base + d, v]], 1000 + i)
             for i, (d, v) in enumerate(((0, 1), (500_000, 2), (700_000, 8),
                                         (1_600_000, 4)))]
    big, small = ql.format(cap=", window='2048'"), ql.format(cap="")
    want = chip_smoke.corpus_run(JaxManager(), small, "q", sends)
    assert want[-1][1:] == ([(1003, (4, 12))],
                            [(base + 1_000_000, (1, 10)),
                             (base + 1_500_000, (2, 8))])
    for q in (big, small):
        assert chip_smoke.corpus_run(TorchManager(device="cpu"), q, "q",
                                     sends) == want
    assert chip_smoke.corpus_run(JaxManager(), big, "q", sends)[-1][1:] == \
        ([(1003, (4, 15))], [])


def test_rows_past_a_key_capacity_raise(caplog):
    """A key's delay buffer holds max(@capacity(window), 128) rows: 200
    rows of one key in one send overflow it; the reference drops them
    silently, the port counts them and raises naming the per-key
    buffer."""
    ql = """@app:playback
    define stream S (k string, v int);
    partition with (k of S) begin
    @info(name='q') from S#window.delay(1 sec) select k, v
    insert into Out; end;"""
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.add_callback("q", lambda *a: None)
    rt.start()
    rt.get_input_handler("S").send([["a", i] for i in range(200)] +
                                   [["b", 1]], timestamp=1000)
    assert "72 rows did not fit the delay window's buffer (per key) of " \
        "128 rows" in caplog.text


def test_purge_resets_the_new_slabs():
    """@purge empties a key's rows and puts its state back to a fresh
    key's: an externalTimeBatch's start to its parameter, a hopping
    window's next boundary to unset."""
    slab = kw.KeyedSlab.empty(kw.MODE_XBATCH, ["LONG", "INT"], 4, 8, "cpu",
                              {"start": 950})
    slab.count[:] = 3
    slab.p_count[:] = 2
    slab.seq[:] = 9
    slab.key_state["start"][:] = 4000
    slab.reset_keys(torch.tensor([1, 3]))
    assert slab.count.tolist() == [3, 0, 3, 0]
    assert slab.p_count.tolist() == [2, 0, 2, 0]
    assert slab.seq.tolist() == [9, 0, 9, 0]
    assert slab.key_state["start"].tolist() == [4000, 950, 4000, 950]
    c = slab.clone()
    c.reset_keys(torch.tensor([0]))
    assert c.key_state["start"].tolist() == [950, 950, 4000, 950]
    hop = kw.KeyedSlab.empty(kw.MODE_HOP, ["INT"], 3, 4, "cpu")
    hop.key_state["next"][:] = 5000
    hop.count[:] = 2
    hop.reset_keys(torch.tensor([2]))
    assert hop.key_state["next"].tolist() == [5000, 5000, -1]
    assert hop.count.tolist() == [2, 2, 0]


def test_configuration_models_hold_at_a_small_size():
    """chip_smoke's KX1, KXB1, KSO1 and KHP1 numpy models hold every
    checked row of the port's at 64 keys (expirations, flushes,
    evictions and hops each happen)."""
    got = chip_smoke.kx_small_checks(np, lambda: TorchManager(device="cpu"))
    assert all(n > 0 for n in got), got
