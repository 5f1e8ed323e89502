"""The general pattern NFA of the port against the JAX package's, step by
step, and the plan-time pieces of `pattern_step`'s general mode.

The step cases (three here, the others in
test_torch_pattern_general_steps.py) plan one query in both packages (the port on the CPU, so
its steps are the plain PyTorch version of the general mode), start the
port from the JAX state through `convert.state_from_jax`, and send both
the same seeded random sends (`test_torch_pattern_step.random_send`) on
each input stream in turn (the two streams are of one width here: the
reference cannot merge a narrower one, fault 1 below), with timer steps for the timed forms; after
every step the state blobs, the slab-overflow counter, the emission header
and the output rows must be equal.  Tolerance: integers, timestamps and
kinds exact; float32 columns exact with NaN equal to NaN and +0 equal to
-0.  Beside them: `KernelPlan` builds on the CPU for every X5 plan and
every phase-49 form (chip_smoke.py), a plan past a stated limit raises
naming it, LOAD_CAPD's torch interpreter equals the compiled expression,
and the query guide's counting and logical patterns (fault 1: the
reference's capture merge indexes a narrower stream's columns and
raises) run in the port as their padded twins run in the JAX package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.executor import compile_expression
from siddhi_tpu_torch.kernels import filter_bytecode as fb
from siddhi_tpu_torch.kernels import pattern_step as ps

from test_torch_pattern_step import Pair, assert_out_equal, \
    assert_state_equal, random_send

BASE = """
@app:playback
define stream T (key long, price float, volume int);
define stream U (key long, price float, volume int);
partition with (key of T, key of U)
begin
  @capacity(keys='256', slots='{slots}')
  @info(name='q')
  {body}
end;
"""
FORMS = [
    ("plus", 4, "from every e1=T[volume == 1], e2=T[volume == 2 and "
     "price >= e1.price]+, e3=T[volume >= 3 and e2[last].price > price] "
     "select e1.price as a, e2[last].price as b, e2[0].price as c "
     "insert into O;"),
    ("star", 4, "from every e1=T[volume == 1], e2=T[volume <= 2]*, "
     "e3=T[volume == 3] select e1.price as a, e2[0].price as b, "
     "e2[last].price as c insert into O;"),
    ("question", 4, "from every e1=T[volume == 2]?, e2=T[volume >= 3] "
     "select e1.price as a, e2.price as b insert into O;"),
    ("range", 6, "from every e1=T[volume <= 2]<2:4> -> e2=U[volume == 3] "
     "select e1[0].price as a, e1[1].price as b, e1[last].price as c, "
     "e2.volume as d insert into O;"),
    ("and", 4, "from every e1=T[volume == 1] -> e2=T[volume == 2] and "
     "e3=U[volume == 3] -> e4=T[volume == 4] select e1.price as a, "
     "e2.price as b, e3.volume as c insert into O;"),
    ("or", 4, "from every e1=T[volume == 1] -> e2=U[volume == 2] or "
     "e3=T[volume == 3] select e1.price as a, e2.volume as b, "
     "e3.price as c insert into O;"),
    ("instant_absent", 4, "from every e1=T[volume == 1] -> "
     "not U[volume == 2] and e3=T[volume == 3] select e1.price as a, "
     "e3.price as b insert into O;"),
    ("timed_absent", 4, "from every e1=T[volume == 1] -> "
     "not U[volume == 2] for 60 milliseconds and e3=T[volume == 3] "
     "select e1.price as a, e3.price as b insert into O;"),
    ("leading_absent", 4, "from every not U[volume == 2] for 30 "
     "milliseconds -> e2=T[volume == 3] select e2.price as a insert into "
     "O;"),
    ("having", 4, "from every e1=T[volume == 1] -> e2=T[volume == 2]<1:2> "
     "select e1.key as k, count() as n, sum(e2[last].volume) as s, "
     "max(e2[0].price) as m having m > 0.25 insert into O;"),
]


def _step(pair, sid, rng, Kb, E, dense, clock):
    pair.sid, pair.schema = sid, pair.tq.planned.in_schemas[sid]
    send = random_send(rng, pair, Kb, E, dense, clock)
    if pair.tq.planned.timer_step is not None and not dense:
        # no padding rows: the plain gather step ticks a clamped copy of
        # the last key for one, which can fire that key's deadlines
        cols, ts, sel, key_ref, now = send
        sel[key_ref == pair.K] = -1
        key_ref[key_ref == pair.K] = rng.choice(
            np.setdiff1d(np.arange(pair.K), key_ref),
            int((key_ref == pair.K).sum()), replace=False)
        send = (cols, ts, sel, key_ref, now)
    from test_torch_pattern_step import step_both
    return step_both(pair, *send, dense)


def _timer(pair, now):
    (jpk, jsel), (tpk, tsel) = pair.jstate, pair.tstate
    jres = pair.jq.planned.timer_step(jpk, jsel, jnp.asarray(now, jnp.int64),
                                      ())
    tres = pair.tq.planned.timer_step(tpk, tsel, now)
    pair.jstate, pair.tstate = (jres[0], jres[1]), (tres[0], tres[1])
    assert int(tres[3]) == int(jres[3])
    return jres[2], tres[2]


def general_steps_agree(name, slots, body):
    pair = Pair(BASE.format(slots=slots, body=body), "q")
    rng = np.random.default_rng([f[0] for f in FORMS].index(name) + 100)
    sids = pair.jq.planned.spec.stream_ids
    timed = pair.tq.planned.timer_step is not None
    clock, matched = 1000, 0
    for it in range(8):
        dense = it % 2 == 0
        jout, tout = _step(pair, sids[(it // 2) % len(sids)], rng, 64,
                           4 if it % 4 < 2 else 2, dense, clock)
        clock += 100
        assert_state_equal(pair)
        assert_out_equal(jout, tout)
        matched += int(tout[0])
        if timed:
            jout, tout = _timer(pair, clock)
            assert_state_equal(pair)
            assert_out_equal(jout, tout)
            matched += int(tout[0])
    assert matched > 0 or name == "leading_absent"
    pair.close()


HERE = ("plus", "range", "having")


@pytest.mark.parametrize("name,slots,body",
                         [f for f in FORMS if f[0] in HERE], ids=HERE)
def test_general_steps_agree(name, slots, body):
    general_steps_agree(name, slots, body)


def _kernel_plans(planned):
    kps = [ps.KernelPlan(planned.exec, planned.selector_exec, planned.packer,
                         sid, planned.compact_rows)
           for sid in planned.spec.stream_ids]
    if planned.timer_step is not None:
        kps.append(ps.KernelPlan(planned.exec, planned.selector_exec,
                                 planned.packer, planned.spec.stream_ids[0],
                                 8))
    return kps


def test_kernel_plan_builds_for_every_x5_plan():
    """Every X5 app's plan (top level and partitioned) and every phase-49
    form gets a kernel plan on the CPU, so a CUDA plan of it would not
    raise: the general mode for every plan outside the flagship's subset,
    the block NFA where the plan is a top-level simple chain."""
    n_general = 0
    apps = [(c[0], c[1]) for c in chip_smoke.X5_CASES] + [
        (f[0], chip_smoke.gen_app(f[2], 64, f[1]))
        for f in chip_smoke.GEN_FORMS]
    for name, ql in apps:
        mgr = TorchManager(device="cpu")
        rt = mgr.create_siddhi_app_runtime(ql)
        for qr in rt.query_runtimes.values():
            planned = qr.planned
            if planned.block:
                continue
            for kp in _kernel_plans(planned):
                assert kp.general == (not ps.flagship_subset(planned.spec))
                n_general += kp.general
                assert ctypes_size(kp.template) <= 4000
        mgr.shutdown()
    assert n_general > 100


def ctypes_size(t):
    import ctypes
    return ctypes.sizeof(t)


def _plan(ql):
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    return rt.query_runtimes["q"].planned


@pytest.mark.parametrize("body,what", [
    ("from every " + " -> ".join(f"e{i}=T[volume == {i % 4}]<1:2>"
                                  for i in range(9)) +
     " select e0.price as a insert into O;", "at most 8 atoms"),
    ("from every e1=T[volume == 1]<1:2> -> e2=T[" +
     " or ".join(f"price > {i}.5" for i in range(40)) +
     "] select e1[0].price as a insert into O;", "at most 256 bytecode"),
], ids=["atoms", "bytecode"])
def test_plan_past_a_stated_limit_raises(body, what):
    with pytest.raises(NotImplementedError, match=what):
        _kernel_plans(_plan(BASE.format(slots=4, body=body)))


def test_limit_on_slots_raises():
    planned = _plan(BASE.format(slots=33, body=FORMS[3][2]))
    with pytest.raises(NotImplementedError, match="at most 32 slots"):
        _kernel_plans(planned)


def test_load_capd_interpreter_equals_the_compiled_expression():
    """Indexed and partner capture loads: the bytecode (LOAD_CAPD) run by
    `interpret` against compile_expression over the same captures."""
    ql = BASE.format(slots=4, body=(
        "from every e1=T[volume == 1]<1:3> -> e2=T[volume == 2] or "
        "e3=U[volume == 3] -> e4=T[e1[0].price < price and "
        "e1[last].price >= e1[1].price and not (e3.volume is null) and "
        "(e2.price is null or e2.price * 2.0 > price)] "
        "select e4.price as a insert into O;"))
    planned = _plan(ql)
    pexec = planned.exec
    sides = list(pexec.spec.all_atoms())
    e4 = sides[-1]
    kp = _kernel_plans(planned)[0]
    t = kp.template
    s4 = sides.index(e4)
    code = list(t.code[t.s_code[s4]:t.s_code[s4] + t.s_code_len[s4]])
    assert fb.LOAD_CAPD in code
    assert (0, 1, -1) in fb.cap_loads(code, with_depth=True)
    rng = np.random.default_rng(3)
    K = 64
    env = {}
    caps = {}
    for i, x in enumerate(sides):
        if x.absent:
            continue
        sch = pexec.schemas[x.stream_id]
        D = x.capture_depth
        fill = rng.integers(0, D + 1, K)
        ts = np.where(np.arange(D)[:, None] < fill[None], 1000, -1)
        cols = []
        for dt in sch.dtypes:
            if dt == torch.float32:
                c = rng.random((D, K)).astype(np.float32)
                c[rng.random((D, K)) < 0.1] = np.nan
                c[rng.random((D, K)) < 0.1] = -0.0
            else:
                c = rng.integers(1, 4, (D, K)).astype(
                    np.int64 if dt == torch.int64 else np.int32)
            cols.append(torch.from_numpy(c))
        caps[i] = (torch.from_numpy(ts), cols)
        last = torch.from_numpy(np.clip(fill - 1, 0, D - 1))
        for d in range(D):
            env[f"{x.ref}@{d}"] = tuple(c[d] for c in cols)
        env[x.ref] = env[f"{x.ref}@0"]
        env[f"{x.ref}@-1"] = tuple(
            torch.where(c.gather(0, last[None])[0] == 0,
                        torch.zeros((), dtype=c.dtype),
                        c.gather(0, last[None])[0]) for c in cols)
    ev_cols = (torch.from_numpy(rng.integers(0, 9, K)),
               torch.from_numpy(rng.random(K).astype(np.float32)),
               torch.from_numpy(rng.integers(1, 4, K).astype(np.int32)))
    env_a = dict(env)
    env_a[e4.ref] = ev_cols
    want = compile_expression(e4.filter_expr,
                              pexec.filter_scopes[e4.ckey]).fn(env_a)

    def load_capd(s, c, d):
        return env[f"{sides[s].ref}@{d}"][c]
    got = fb.interpret(code, lambda c: ev_cols[c], None,
                       load_capd=load_capd)
    assert bool(want.any()) and not bool(want.all())
    assert torch.equal(got, torch.broadcast_to(want, got.shape))


def _events(mgr, ql, sends):
    return chip_smoke.corpus_run(mgr, ql, "q", sends)


@pytest.mark.parametrize("name", ["guide_counting_pattern",
                                  "guide_logical_pattern"])
def test_fault1_narrow_stream_matches_padded_twin(name):
    """The guide's counting and logical patterns mix streams of different
    widths: the port runs them as the JAX package runs their twins with
    the narrow stream padded (the reference raises on the narrow one's
    events and emits nothing)."""
    spec = next(s for s in chip_smoke.x5_specs() if s[0] == name)
    _, ql, q, sends, (twin_ql, twin_sends) = spec
    got = _events(TorchManager(device="cpu"), ql, sends)
    want = _events(JaxManager(), twin_ql, twin_sends)
    assert got == want and len(got) >= 2
    # the reference alone on the unpadded app: nothing comes out
    assert _events(JaxManager(), ql, sends) == []


def test_configuration_models_hold_at_a_small_size():
    """PK1, CP1, LG1 and TP1's models and closed forms (chip_smoke.py's
    phase 51) hold for the port's rows at a small size."""
    chip_smoke.s13_small_checks(torch, np)
