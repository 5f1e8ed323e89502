"""The port's selector (`AggregatorBank` through the plain `group_agg`
version, `SelectorExec` with group by and having) agrees with the JAX
package's, step by step, from selector state carried across mid-stream
with `convert.selector_state_from_jax`.

Rows come from numpy seeds in seq order: CURRENT, EXPIRED, RESET and
invalid rows, group slots (-1 on RESET rows), null inputs (NaN floats,
INT/LONG minimum).  Tolerance: integers, counts, min/max and the kinds
exact; float32 sums and avg exact because the inputs are dyadic (k/64,
running sums far below 2^17), where any order of additions is exact.
stdDev is sqrt(E[x^2] - E[x]^2); XLA on the CPU may contract that into a
fused multiply-add, the port does not, so its variance agrees within a
few float32 ulps of E[x^2].  The bank's per-row running values are
compared on the rows that contribute (sign != 0): the port gives the
others the identity, a value no consumer reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.window import Rows as JaxRows
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import selector_state_from_jax
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.window import Rows

SCHEMA = "define stream S (k int, p float, v long, b bool);\n"
ALL_AGGS = """
@info(name='q') from S
select k, sum(p) as sp, sum(v) as sv, avg(p) as ap, count() as c,
       min(p) as mnp, max(v) as mxv, minForever(v) as mnf,
       maxForever(p) as mxf, stdDev(p) as sd, and(b) as ab, or(b) as ob,
       min(k) as mnk
group by k having sp > 0.5 or c > 2
insert into O;
"""


def _selectors(body):
    ql = SCHEMA + body
    jrt = JaxManager().create_siddhi_app_runtime(ql)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.query_runtimes["q"].planned, trt.query_runtimes["q"].planned


def _rows(rng, B, n_slots, p_reset, seq0):
    kind = rng.choice([ev.CURRENT, ev.EXPIRED, ev.RESET], B,
                      p=[0.6 - p_reset, 0.4, p_reset]).astype(np.int32)
    valid = rng.random(B) < 0.9
    gslot = rng.integers(0, n_slots, B).astype(np.int32)
    gslot[kind == ev.RESET] = -1
    k = gslot.copy()
    p = (rng.integers(0, 64, B) / 64).astype(np.float32)
    p[rng.random(B) < 0.1] = np.nan
    v = rng.integers(-40, 40, B).astype(np.int64)
    v[rng.random(B) < 0.1] = ev.NULL_LONG
    b = rng.random(B) < 0.7
    cols = [k, p, v, b]
    ts = (1000 + np.arange(B)).astype(np.int64)
    seq = seq0 + np.arange(B, dtype=np.int64)
    return ts, kind, valid, seq, gslot, cols


def _jax_env(sid, r):
    ts, kind, valid, seq, gslot, cols = r
    rows = JaxRows(jnp.asarray(ts), jnp.asarray(kind), jnp.asarray(valid),
                   jnp.asarray(seq), jnp.asarray(gslot),
                   tuple(jnp.asarray(c) for c in cols))
    return rows, {sid: rows.cols, "__ts__": rows.ts,
                  "__now__": jnp.asarray(0, jnp.int64),
                  "__kind__": rows.kind}


def _torch_env(sid, r):
    ts, kind, valid, seq, gslot, cols = r
    t = torch.from_numpy
    rows = Rows(t(ts), t(kind), t(valid), t(seq), t(gslot),
                tuple(t(c) for c in cols))
    return rows, {sid: rows.cols, "__ts__": rows.ts, "__now__": 0,
                  "__kind__": rows.kind}


def _var_close(ap, u, v):
    ok = np.isnan(u) == np.isnan(v)
    m = ~np.isnan(u)
    return ok.all() and np.all(
        np.abs(u[m] ** 2 - v[m] ** 2) <= 2.0 ** -21 * (ap[m] ** 2 + u[m] ** 2))


def _run(body, B=96, n_slots=5, p_reset=0.0, steps=6, warm=2, seed=0):
    jp, tp = _selectors(body)
    jsel, tsel = jp.selector_exec, tp.selector_exec
    sid = tp.input_stream_id
    jproc = jax.jit(lambda st, rows, env: jsel.process(st, rows, env))
    rng = np.random.default_rng(seed)
    jst = jsel.init_state()
    for i in range(steps):
        r = _rows(rng, B, n_slots, p_reset, 10_000 * i)
        if i == warm:
            tst = selector_state_from_jax(jax.device_get(jst))
        jrows, jenv = _jax_env(sid, r)
        jst, jout = jproc(jst, jrows, jenv)
        if i < warm:
            continue
        trows, tenv = _torch_env(sid, r)
        tst, tout = tsel.process(tst, trows, tenv)
        jts, jkind, jvalid, jcols = jax.device_get(jout)
        tts, tkind, tvalid, tcols = tout
        np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
        m = np.asarray(jvalid)
        np.testing.assert_array_equal(np.asarray(jkind)[m],
                                      tkind.numpy()[m])
        names = tp.out_schema.names
        for c, (a, b) in enumerate(zip(jcols, tcols)):
            a, b = np.asarray(a)[m], b.numpy()[m]
            if names[c] == "sd":
                assert _var_close(np.asarray(jcols[3])[m], a, b)
            else:
                np.testing.assert_array_equal(a, b, err_msg=names[c])
        for j, (a, b) in enumerate(zip(jax.device_get(jst), tst)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"state {j}")
    return tp


def test_every_aggregator_group_by_having_alias():
    tp = _run(ALL_AGGS)
    assert len(tp.selector_exec.bank.specs) >= 12


@pytest.mark.parametrize("p_reset", [0.03, 0.2])
def test_reset_epochs(p_reset):
    """RESET rows start new epochs: segments restart without the carry,
    and the state after a step with a RESET comes from the last epoch
    only."""
    _run(ALL_AGGS, p_reset=p_reset, seed=int(p_reset * 100))


def test_no_group_by_one_slot():
    _run("@info(name='q') from S select sum(p) as sp, count() as c, "
         "avg(v) as av insert into O;", n_slots=1, p_reset=0.05, seed=7)


def test_carry_across_many_steps():
    _run("@info(name='q') from S select k, sum(v) as sv, max(p) as mx "
         "group by k insert into O;", B=64, n_slots=3, steps=12, warm=3,
         seed=8)


def test_bank_scans_on_contributing_rows():
    """The bank's per-row running values, spec by spec."""
    jp, tp = _selectors(ALL_AGGS)
    sid = tp.input_stream_id
    rng = np.random.default_rng(9)
    r = _rows(rng, 200, 6, 0.05, 0)
    jrows, jenv = _jax_env(sid, r)
    trows, tenv = _torch_env(sid, r)
    bank = jp.selector_exec.bank
    jst, jscan = jax.jit(lambda st, rows, env: bank.process(st, rows, env))(
        jp.selector_exec.init_state(), jrows, jenv)
    tst, tscan = tp.selector_exec.bank.process(
        tp.selector_exec.init_state(), trows, tenv)
    kind, valid = r[1], r[2]
    contrib = valid & ((kind == ev.CURRENT) | (kind == ev.EXPIRED))
    for j, (a, b) in enumerate(zip(jscan, tscan)):
        np.testing.assert_array_equal(np.asarray(a)[contrib],
                                      b.numpy()[contrib], err_msg=str(j))
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("value,dtype,bits", [
    (1.0, torch.float32, 0x3F800000), (float("-inf"), torch.float32,
                                       -0x800000),
    (-5, torch.int64, -5), (2 ** 31 - 1, torch.int32, 2 ** 31 - 1)])
def test_kernel_slot_bits(value, dtype, bits):
    """Identities and reset values travel to the kernels as 64-bit slots:
    a float32 as its bit pattern (sign-extended), an integer as itself."""
    from siddhi_tpu_torch.kernels._nvcc import slot_bits
    assert slot_bits(value, dtype) == bits
