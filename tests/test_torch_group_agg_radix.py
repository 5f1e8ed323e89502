"""Group aggregation beyond 4,096 slots: the port's `AggregatorBank`
through the plain version of kernel K4 (the function K4's radix mode
computes on CUDA above MAX_SLOTS) agrees with the JAX package's
`AggregatorBank.process` (`siddhi_tpu/core/selector.py:320`) at 2^13 to
2^16 group slots: a partitioned query without a window whose slots are
the partition key's, rows spread over every slot, CURRENT, EXPIRED,
RESET and invalid rows, carry states from earlier steps.  A partitioned
query over more than 4,096 keys without a window, and one grouped by a
further attribute, run through both packages' `SiddhiManager`s with the
same events.

Inputs come from numpy seeds.  Tolerance: exact (integer sums, min/max,
counts; float32 sums of dyadic values below 2^17, where any order of
additions is exact).
"""
import jax
import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.convert import selector_state_from_jax
from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.kernels import group_agg as ga
from test_torch_selector import _jax_env, _torch_env

QL = """
define stream S (k int, p float, v long, b bool);
partition with (k of S)
begin
  @capacity(keys='{K}')
  @info(name='q') from S
  select k, sum(p) as sp, sum(v) as sv, count() as c, min(p) as mnp,
         max(v) as mxv, avg(p) as ap
  insert into O;
end;
"""


def _rows(rng, B, K, p_reset, seq0):
    kind = rng.choice([ev.CURRENT, ev.EXPIRED, ev.RESET], B,
                      p=[0.6 - p_reset, 0.4, p_reset]).astype(np.int32)
    valid = rng.random(B) < 0.9
    gslot = rng.integers(0, K, B).astype(np.int32)
    gslot[kind == ev.RESET] = -1
    p = (rng.integers(0, 64, B) / 64).astype(np.float32)
    v = rng.integers(-40, 40, B).astype(np.int64)
    cols = [gslot.copy(), p, v, rng.random(B) < 0.5]
    return (1000 + np.arange(B, dtype=np.int64), kind, valid,
            seq0 + np.arange(B, dtype=np.int64), gslot, cols)


@pytest.mark.parametrize("K", [1 << 13, 1 << 14, 1 << 16])
def test_bank_beyond_max_slots(K):
    assert K > ga.MAX_SLOTS
    ql = QL.format(K=K)
    jp = JaxManager().create_siddhi_app_runtime(ql).query_runtimes["q"] \
        .planned
    tp = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"].planned
    jbank, tbank = jp.selector_exec.bank, tp.selector_exec.bank
    assert tbank.K == K and not tbank.runs
    sid = tp.input_stream_id
    proc = jax.jit(lambda st, rows, env: jbank.process(st, rows, env))
    rng = np.random.default_rng(K)
    jst = jp.selector_exec.init_state()
    tst = None
    for i, p_reset in enumerate((0.0, 0.0, 0.002, 0.0)):
        r = _rows(rng, 4096, K, p_reset, 10_000 * i)
        if i == 1:
            tst = selector_state_from_jax(jax.device_get(jst))
        jrows, jenv = _jax_env(sid, r)
        jst, jscan = proc(jst, jrows, jenv)
        if i < 1:
            continue
        trows, tenv = _torch_env(sid, r)
        tst, tscan = tbank.process(tst, trows, tenv)
        kind, valid = r[1], r[2]
        contrib = valid & ((kind == ev.CURRENT) | (kind == ev.EXPIRED))
        for j, (a, b) in enumerate(zip(jscan, tscan)):
            np.testing.assert_array_equal(np.asarray(a)[contrib],
                                          b.numpy()[contrib], err_msg=str(j))
        for a, b in zip(jax.device_get(jst), tst):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("group", ["", "group by w"])
def test_more_keys_than_max_slots_through_both(group):
    """6,000 keys (16,384 group slots, more than 4,096) without a window,
    and a group by a further attribute inside the partition (up to
    12,000 groups)."""
    ql = f"""
    @app:playback
    define stream S (k long, w int, v int);
    partition with (k of S)
    begin
      @capacity(keys='16384')
      @info(name='q') from S select k, w, sum(v) as s, count() as c
      {group} insert into O;
    end;
    """
    rng = np.random.default_rng(61)
    sends = []
    for i in range(4):
        B = 3000
        sends.append(([rng.integers(0, 6000, B).astype(np.int64),
                       rng.integers(0, 2, B).astype(np.int32),
                       rng.integers(-9, 9, B).astype(np.int32)],
                      np.full(B, 1000 + 10 * i, np.int64)))
    out = []
    for mgr in (JaxManager(), TorchManager(device="cpu")):
        rt = mgr.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda ts, i, o: got.extend(
            tuple(e.data) for e in i or []))
        rt.start()
        h = rt.get_input_handler("S")
        for cols, ts in sends:
            h.send_columns(cols, timestamps=ts)
        rt.shutdown()
        assert rt.query_runtimes["q"].planned.selector_exec.bank.K == 16384
        out.append(got)
    assert out[0] == out[1] and len(out[0]) == 12000
