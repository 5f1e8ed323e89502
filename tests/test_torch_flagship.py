"""The whole slice: the flagship app through `SiddhiManager` in both
packages.

`FLAGSHIP_QL_TEMPLATE` at 4096 keys and 4 NFA slots, driven the way
`bench.py:run_tpu` drives it (1024-key blocks of 4 events per key through
`send_columns`) over two full key sweeps, then a shuffled send and a send
of gappy keys through `send`.  The block of keys 0-1023 takes the dense
step, the others the gather step (their padded Kb of 4096 overruns the
slab), so both step kinds run.  The `n_current` sums of the batch callback
and every `Matches` event (timestamp, values, order) must be equal.
Tolerance: none (the float values are the sent ones, compared exactly).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.analysis.corpus import FLAGSHIP_QL_TEMPLATE
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.executor import CompileError
from siddhi_tpu_torch.core.pattern import linearize
from siddhi_tpu_torch.kernels import pattern_step as ps

N_KEYS, BATCH = 4096, 1024
QL = FLAGSHIP_QL_TEMPLATE.format(async_ann="", pipe_ann="", n_keys=N_KEYS,
                                 slots=4)


def drive(manager, count_steps=None):
    rt = manager.create_siddhi_app_runtime(QL)
    events, n_current = [], [0]
    rt.add_callback("Matches", lambda evs: events.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    rt.add_batch_callback("flagship", lambda ts, b: n_current.__setitem__(
        0, n_current[0] + b["n_current"]))
    if count_steps is not None:
        count_steps(rt)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    vol4 = np.tile(np.array([1, 2, 3, 4], np.int32), BATCH)
    price4 = vol4.astype(np.float32)
    clock = 1000
    for _ in range(2):
        for b in range(N_KEYS // BATCH):
            keys = np.repeat(np.arange(b * BATCH, (b + 1) * BATCH,
                                       dtype=np.int64), 4)
            clock += 10
            ts = clock + np.tile(np.arange(4, dtype=np.int64), BATCH)
            h.send_columns([keys, price4, vol4], timestamps=ts)
    rng = np.random.default_rng(3)
    # one shuffled send: keys interleaved, volumes and prices random
    n = 4 * BATCH
    keys = rng.integers(0, N_KEYS, n).astype(np.int64)
    vols = rng.integers(1, 5, n).astype(np.int32)
    prices = rng.random(n).astype(np.float32)
    ts = clock + 10 + np.arange(n, dtype=np.int64)
    h.send_columns([keys, prices, vols], timestamps=ts)
    # gappy keys through the row API
    rows = [[int(k), float(np.float32(p)), int(v)] for k, p, v in zip(
        rng.choice(N_KEYS, 40, replace=False), rng.random(40),
        rng.integers(1, 5, 40))]
    h.send(rows, timestamp=int(ts[-1]) + 5)
    rt.flush()
    manager.shutdown()
    return events, n_current[0]


def test_flagship_matches_reference():
    kinds = {"dense": 0, "gather": 0}

    def count_steps(rt):
        p = rt.query_runtimes["flagship"].planned
        for attr, kind in (("dense_steps_w", "dense"), ("steps_w", "gather")):
            table = getattr(p, attr)
            inner = table["TradeStream"]

            def counted(*a, _inner=inner, _kind=kind):
                kinds[_kind] += 1
                return _inner(*a)
            table["TradeStream"] = counted

    ps.reset_counts()
    t_events, t_cur = drive(TorchManager(device="cpu"), count_steps)
    j_events, j_cur = drive(JaxManager())
    assert t_cur == j_cur
    assert 2 * N_KEYS <= t_cur == len(t_events)
    assert t_events == j_events
    assert kinds["dense"] > 0 and kinds["gather"] > 0
    # on the CPU the wrapper took its plain version and never the kernel
    assert ps.launches == 0 and ps.plain_calls > 0


def test_default_manager_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchManager()
    assert TorchManager(device="cpu").device.type == "cpu"


def _query(ql):
    app = SiddhiCompiler.parse(ql)
    part = app.execution_element_list[0]
    return app, part.query_list[0] if hasattr(part, "query_list") else part


@pytest.mark.parametrize("pattern,reason", [
    ("every e1=T[v == 1]<2:3> -> e2=T[v == 2]", "count"),
    ("every e1=T[v == 1] and e2=T[v == 2] -> e3=T[v == 3]", "logical"),
    ("every e1=T[v == 1], e2=T[v == 2]", "sequence"),
])
def test_outside_kernel_subset_raises_on_cuda(pattern, reason):
    """Outside the flagship mode's subset a plan takes the general mode;
    only a plan past a stated limit raises (test_torch_pattern_general.py
    holds the messages)."""
    ql = ("define stream T (k long, v int);\npartition with (k of T)\n"
          f"begin\n@info(name='q') from {pattern}\n"
          "select e1.v as x insert into O;\nend;")
    app, q = _query(ql)
    assert not ps.flagship_subset(linearize(q.input_stream))
    p = TorchManager(device="cpu").create_siddhi_app_runtime(
        ql).query_runtimes["q"].planned
    kp = ps.KernelPlan(p.exec, p.selector_exec, p.packer, "T",
                       p.compact_rows)
    assert kp.general and kp.entry == "siddhi_pattern_general"
    assert (kp.template.sequence == 1) == (reason == "sequence")


def test_flagship_is_inside_kernel_subset_and_plans_a_kernel():
    mgr = TorchManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(QL)
    p = rt.query_runtimes["flagship"].planned
    assert ps.flagship_subset(p.spec)
    kp = ps.KernelPlan(p.exec, p.selector_exec, p.packer, "TradeStream",
                       p.compact_rows)
    t = kp.template
    assert (t.P, t.S, t.every, t.stream_atom_mask) == (4, 4, 1, 0b1111)
    # layout rows: active/pos/count/lmask at 0/4/8/12, seed_on/done 16/17
    assert (t.off_active, t.off_pos, t.off_count, t.off_lmask,
            t.off_seed_on, t.off_done) == (0, 4, 8, 12, 16, 17)
    assert (t.off_start, t.off_entry) == (0, 4)
    assert list(t.cap_ts[:4]) == [8, 16, 24, 32]
    # the selector reads e1.key, e1.price, e2.price, e4.price
    assert kp.emit == [(0, 0), (0, 1), (1, 1), (3, 1)]
    assert t.code_len[0] > 0 and t.code_len[3] > t.code_len[2]


def test_non_partitioned_simple_chain_raises():
    """The non-partitioned simple chain that raised before the block NFA
    was ported (ROADMAP B6) now plans onto it and gives the JAX package's
    events."""
    ql = ("@app:playback\ndefine stream S (v int);\n@info(name='q')\n"
          "from every e1=S[v == 1] -> e2=S[v == 2] select e1.v as a "
          "insert into O;")
    rng = np.random.default_rng(12)
    vs = rng.integers(1, 3, 400).astype(np.int32)
    out = []
    for mgr in (TorchManager(device="cpu"), JaxManager()):
        rt = mgr.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda ts, i, o, got=got: got.extend(
            (e.timestamp, tuple(e.data)) for e in (i or [])))
        rt.start()
        rt.get_input_handler("S").send_columns(
            [vs], timestamps=1000 + np.arange(400, dtype=np.int64))
        rt.flush()
        mgr.shutdown()
        out.append(got)
    assert out[0] == out[1] and len(out[0]) > 50
    p = TorchManager(device="cpu").create_siddhi_app_runtime(ql) \
        .query_runtimes["q"].planned
    assert p.block


@pytest.mark.parametrize("ann", ["@sink(type='log')",
                                 "@OnError(action='STREAM')",
                                 "@store(type='rdbms')"])
def test_unported_annotations_raise(ann):
    mgr = TorchManager(device="cpu")
    ql = FLAGSHIP_QL_TEMPLATE.format(async_ann="", pipe_ann=ann, n_keys=64,
                                     slots=4)
    with pytest.raises(CompileError, match="ROADMAP"):
        mgr.create_siddhi_app_runtime(ql)


def test_chip_smoke_runs_the_corpus_flagship():
    def norm(ql):
        return " ".join(ql.split())
    assert norm(chip_smoke.FLAGSHIP_QL.format(n_keys=N_KEYS)) == norm(QL)
