"""The port's pattern step (`PatternExec.tick`, and the dense and gather
`make_step`) agrees with the JAX package's.

Both packages plan the same query; the port's state starts from the JAX
state through `convert.state_from_jax`, both take the same seeded random
sends (volumes 1-4, random prices with NaNs, repeated and gappy keys,
padding events and rows), and after every step the state blobs, the
slab-overflow counter, the emission header and the output rows must be
equal.  Tolerance: integers, timestamps and kinds exact; float32 columns
exact with NaN equal to NaN and +0 equal to -0 (the reference's one-hot
compaction turns a captured -0.0 into +0.0).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.analysis.corpus import FLAGSHIP_QL_TEMPLATE
from siddhi_tpu.core.pattern_planner import StatePacker as JaxPacker
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import state_from_jax
from siddhi_tpu_torch.core.pattern_planner import StatePacker

FLAGSHIP = FLAGSHIP_QL_TEMPLATE.format(async_ann="", pipe_ann="",
                                       n_keys=512, slots=4)
WITHIN = """
define stream T (key long, price float, volume int, flag bool, sym string);
partition with (key of T)
begin
  @capacity(keys='512', slots='3')
  @info(name='q')
  from every e1=T[volume == 1 and not (sym is null)]
       -> e2=T[volume >= 2 and (price * 2.0 >= e1.price + 0.1 or flag)]
       -> e3=T[volume == 3 and e1.sym == sym] within 150 milliseconds
  select e1.key as k, e1.price as p1, e3.flag as f, e2.sym as s
  insert into M;
end;
"""
NON_EVERY_UNCAPPED = """
define stream T (key long, price float, volume int);
partition with (key of T)
begin
  @capacity(keys='512', slots='2')
  @emit(rows='100')
  @info(name='q')
  from e1=T[volume == 1] -> e2=T[volume == 2 and price > e1.price]
  select e1.price as a, e2.price as b
  insert into M;
end;
"""
COUNT = """
define stream T (key long, price float, volume int);
partition with (key of T)
begin
  @capacity(keys='512', slots='4')
  @info(name='q')
  from every e1=T[volume == 1]<1:3> -> e2=T[volume == 2]
  select e1[0].price as a, e1[last].price as l, e2.price as b
  insert into M;
end;
"""
LOGICAL = """
define stream T (key long, price float, volume int);
partition with (key of T)
begin
  @capacity(keys='512', slots='4')
  @info(name='q')
  from every e1=T[volume == 1] -> e2=T[volume == 2] and e3=T[volume == 3]
       -> e4=T[volume == 4]
  select e1.price as a, e2.price as b, e3.price as c
  insert into M;
end;
"""
SEQUENCE = """
define stream T (key long, price float, volume int);
partition with (key of T)
begin
  @capacity(keys='512', slots='4')
  @info(name='q')
  from every e1=T[volume == 1], e2=T[volume == 2 and price >= e1.price]
  select e1.price as a, e2.price as b
  insert into M;
end;
"""


class Pair:
    """One query planned by both packages (the port on the CPU)."""

    def __init__(self, ql, name):
        self.jm, self.tm = JaxManager(), TorchManager(device="cpu")
        self.jrt = self.jm.create_siddhi_app_runtime(ql)
        self.trt = self.tm.create_siddhi_app_runtime(ql)
        self.jq = self.jrt.query_runtimes[name]
        self.tq = self.trt.query_runtimes[name]
        self.sid = self.jq.planned.spec.stream_ids[0]
        self.schema = self.tq.planned.in_schemas[self.sid]
        self.K = self.tq.planned.key_capacity
        self.jstate = self.jq.state
        self.tstate = self.to_torch()

    def to_torch(self):
        (b32, b64, scal), sel = self.jstate
        return state_from_jax(np.asarray(b32), np.asarray(b64),
                              [np.asarray(s) for s in scal],
                              tuple(np.asarray(x) for x in sel))

    def close(self):
        self.jm.shutdown()
        self.tm.shutdown()


def random_send(rng, pair, Kb, E, dense, clock):
    B = Kb * E
    cols = []
    for t in pair.schema.types:
        if t == "LONG":
            cols.append(rng.integers(0, 64, B).astype(np.int64))
        elif t == "INT":
            cols.append(rng.integers(1, 5, B).astype(np.int32))
        elif t == "FLOAT":
            x = rng.random(B).astype(np.float32)
            x[rng.random(B) < 0.05] = np.nan
            x[rng.random(B) < 0.05] = -0.0
            cols.append(x)
        elif t == "BOOL":
            cols.append(rng.random(B) < 0.5)
        else:
            cols.append(rng.integers(-1, 3, B).astype(np.int32))
    ts = clock + np.sort(rng.integers(0, 120, B)).astype(np.int64)
    sel = rng.permutation(B).astype(np.int32).reshape(Kb, E)
    sel[rng.random((Kb, E)) < 0.15] = -1
    if dense:
        key_ref = int(rng.integers(0, pair.K - Kb + 1))
    else:
        key_ref = rng.choice(pair.K, Kb, replace=False).astype(np.int32)
        pad = rng.random(Kb) < 0.1
        key_ref[pad] = pair.K          # padding rows carry no events
        sel[pad] = -1
    now = int(ts.max()) + int(rng.integers(0, 200))
    return cols, ts, sel, key_ref, now


def step_both(pair, cols, ts, sel, key_ref, now, dense):
    jp, tp = pair.jq.planned, pair.tq.planned
    base = int(ts[0])
    delta = (ts - base).astype(np.int32)
    jsteps = jp.dense_steps_w if dense else jp.steps_w
    tsteps = tp.dense_steps_w if dense else tp.steps_w
    jkey = jnp.asarray(key_ref, jnp.int32)
    tkey = key_ref if dense else torch.from_numpy(key_ref)
    (jpk, jsel), (tpk, tsel) = pair.jstate, pair.tstate
    jres = jsteps[pair.sid](
        jpk, jsel, tuple(jnp.asarray(c) for c in cols),
        jnp.asarray(base, jnp.int64), jnp.asarray(delta), jnp.asarray(sel),
        jkey, jnp.asarray(now, jnp.int64), ())
    tres = tsteps[pair.sid](
        tpk, tsel, tuple(torch.from_numpy(c) for c in cols), base,
        torch.from_numpy(delta), torch.from_numpy(sel), tkey, now)
    pair.jstate = (jres[0], jres[1])
    pair.tstate = (tres[0], tres[1])
    return jres[2], tres[2]


def assert_state_equal(pair):
    (jb32, jb64, jsc), _ = pair.jstate
    (tb32, tb64, tsc), _ = pair.tstate
    np.testing.assert_array_equal(tb32.numpy(), np.asarray(jb32))
    np.testing.assert_array_equal(tb64.numpy(), np.asarray(jb64))
    assert [int(s) for s in tsc] == [int(s) for s in jsc]


def assert_out_equal(jout, tout):
    assert int(tout[0]) == int(jout[0]) and int(tout[1]) == int(jout[1])
    for j, t in zip(jout[2:5], tout[2:5]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for j, t in zip(jout[5], tout[5]):
        torch.testing.assert_close(t, torch.from_numpy(np.array(j)),
                                   rtol=0, atol=0, equal_nan=True)


CASES = [("flagship", FLAGSHIP, "flagship", 64, 4),
         ("within", WITHIN, "q", 64, 6),
         ("non_every_uncapped", NON_EVERY_UNCAPPED, "q", 32, 5),
         ("count", COUNT, "q", 32, 6),
         ("logical", LOGICAL, "q", 32, 6),
         ("sequence", SEQUENCE, "q", 32, 6)]


@pytest.mark.parametrize("case,ql,name,Kb,E", CASES,
                         ids=[c[0] for c in CASES])
def test_make_step_dense_and_gather(case, ql, name, Kb, E):
    pair = Pair(ql, name)
    rng = np.random.default_rng([c[0] for c in CASES].index(case))
    clock = 1000
    matched = 0
    for it in range(8):
        dense = it % 2 == 0
        send = random_send(rng, pair, Kb, E, dense, clock)
        clock += 100
        jout, tout = step_both(pair, *send, dense)
        assert_state_equal(pair)
        assert_out_equal(jout, tout)
        matched += int(tout[0])
    assert matched > 0
    pair.close()


def test_continue_from_jax_mid_stream_state():
    """Three sends through the JAX step alone, then the state crosses over
    and both packages continue in lock-step."""
    pair = Pair(FLAGSHIP, "flagship")
    rng = np.random.default_rng(11)
    jp = pair.jq.planned
    for it in range(3):
        cols, ts, sel, key_ref, now = random_send(rng, pair, 64, 4, True,
                                                  1000 + 100 * it)
        base = int(ts[0])
        pk, sl = pair.jstate
        res = jp.dense_steps_w[pair.sid](
            pk, sl, tuple(jnp.asarray(c) for c in cols),
            jnp.asarray(base, jnp.int64),
            jnp.asarray((ts - base).astype(np.int32)), jnp.asarray(sel),
            jnp.asarray(key_ref, jnp.int32), jnp.asarray(now, jnp.int64), ())
        pair.jstate = (res[0], res[1])
    pair.tstate = pair.to_torch()
    assert int(pair.tstate[0][2][0]) == int(pair.jstate[0][2][0])
    for it in range(4):
        dense = it % 2 == 1
        send = random_send(rng, pair, 64, 4, dense, 2000 + 100 * it)
        jout, tout = step_both(pair, *send, dense)
        assert_state_equal(pair)
        assert_out_equal(jout, tout)
    pair.close()


@pytest.mark.parametrize("case,ql,name", [c[:3] for c in CASES[:2]],
                         ids=[c[0] for c in CASES[:2]])
def test_tick_agrees(case, ql, name):
    """PatternExec.tick alone: one event per key, several ticks."""
    pair = Pair(ql, name)
    jx, tx = pair.jq.planned.exec, pair.tq.planned.exec
    K = 48
    jst, tst = jx.init_state(K), tx.init_state(K)
    packer = StatePacker(tst)
    jtick = jax.jit(lambda st, c, t, v, n: jx.tick(st, pair.sid, c, t, v, n))
    rng = np.random.default_rng(5)
    for it in range(10):
        cols, ts, _, _, _ = random_send(rng, pair, K, 1, True, 1000 + 40 * it)
        valid = rng.random(K) < 0.9
        now_k = np.where(valid, ts, ts.max() + 5)
        jst, jem = jtick(jst, tuple(jnp.asarray(c) for c in cols),
                         jnp.asarray(ts), jnp.asarray(valid),
                         jnp.asarray(now_k))
        tst, tem = tx.tick(tst, pair.sid,
                           tuple(torch.from_numpy(c) for c in cols),
                           torch.from_numpy(ts), torch.from_numpy(valid),
                           torch.from_numpy(now_k))
        tb32, tb64, tsc = packer.pack(tst)
        jb32, jb64, jsc = JaxPacker(jst).pack(jst)
        np.testing.assert_array_equal(tb32.numpy(), np.asarray(jb32))
        np.testing.assert_array_equal(tb64.numpy(), np.asarray(jb64))
        assert int(tsc[0]) == int(jsc[0])
        np.testing.assert_array_equal(tem["mask"].numpy(),
                                      np.asarray(jem["mask"]))
        for ck, (jts, jcols) in ((k, v) for k, v in jem.items()
                                 if isinstance(v, tuple)):
            tts, tcols = tem[ck]
            m = tem["mask"].numpy()
            np.testing.assert_array_equal(tts.numpy()[:, 0][m],
                                          np.asarray(jts)[:, 0][m])
            for jc, tc in zip(jcols, tcols):
                torch.testing.assert_close(
                    tc[:, 0][tem["mask"]],
                    torch.from_numpy(np.array(jc))[:, 0][tem["mask"]],
                    rtol=0, atol=0, equal_nan=True)
    pair.close()


def test_packer_layout_matches_reference():
    pair = Pair(FLAGSHIP, "flagship")
    (jb32, jb64, jsc), _ = pair.jstate
    tp = pair.tq.planned.packer
    assert (tp.w32, tp.w64, tp.n_scalars) == (50, 40, 1)
    assert jb32.shape == (50, pair.K) and jb64.shape == (40, pair.K)
    (tb32, tb64, _), _ = pair.tq.planned.init_state(pair.K)
    np.testing.assert_array_equal(tb32.numpy(), np.asarray(jb32))
    np.testing.assert_array_equal(tb64.numpy(), np.asarray(jb64))
    pair.close()
