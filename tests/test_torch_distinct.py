"""distinctCount and sizeOfSet(unionSet(createSet(x))) through the port
(the selector's refcount pass over pair slots and the count pass it
feeds, both K4's plain version) against the JAX package.

Whole apps run through both packages (events exact): the distinct cases
of `chip_smoke.X2_CASES` (`tests/test_join_groupby.py`'s distinct cases,
a distinct count by page, a flat partition), a state carried across
mid-stream (`convert.query_state_from_jax` for the refcounts and counts,
`convert.pair_allocators_from_jax` for the pair and group slots), and
chip_smoke's DC1 model at a small size against the port's rows.  Then a
reference defect the port does not copy (a filter before distinctCount),
the raises the reference gives, a full pair allocator, and `@purge`
leaving a distinctCount query alone.
"""
import logging

import numpy as np
import pytest

import chip_smoke
from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch import convert
from siddhi_tpu_torch.exceptions import CompileError

CASES = [c for c in chip_smoke.X2_CASES
         if "distinct" in c[0] or "unionSet" in c[0]]


@pytest.mark.parametrize("name,ql,qname,sends,want", CASES,
                         ids=[c[0] for c in CASES])
def test_corpus_gives_the_jax_events(name, ql, qname, sends, want):
    """chip_smoke.py's X2 distinct expectations are the JAX package's
    events, and the port gives them on the CPU."""
    assert chip_smoke.corpus_run(JaxManager(), ql, qname, sends) == want
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), ql, qname,
                                 sends) == want


def _sends(rng, n, B=64):
    return [(rng.integers(0, 6, B).astype(np.int64),
             rng.integers(0, 9, B).astype(np.int64)) for _ in range(n)]


def _collect(rt):
    got = []
    rt.add_batch_callback("q", lambda ts, b: got.append(
        (b["cols"]["g"][b["valid"]].tolist(),
         b["cols"]["dc"][b["valid"]].tolist())))
    return got


def test_state_carried_across():
    """Three sends through the JAX package, its refcounts, counts, pair
    slots and group slots carried into the port, then three more sends
    through both: every delivered row equal."""
    ql = """
    define stream S (g long, x long);
    @info(name='q')
    from S select g, distinctCount(x) as dc group by g insert into Out;
    """
    rng = np.random.default_rng(11)
    sends = _sends(rng, 6)
    jrt = JaxManager().create_siddhi_app_runtime(ql)
    trt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    jgot, tgot = _collect(jrt), _collect(trt)
    jrt.start()
    trt.start()
    for g, x in sends[:3]:
        jrt.get_input_handler("S").send_columns([g, x])
    jrt.flush()
    jq, tq = jrt.query_runtimes["q"], trt.query_runtimes["q"]
    convert.pair_allocators_from_jax(tq.planned, jq.planned)
    tq.state = convert.query_state_from_jax(tq.planned, jq.state)
    assert [s.shape[0] for s in tq.state[1]] == [8 * 4096, 4096]
    del jgot[:]
    for g, x in sends[3:]:
        jrt.get_input_handler("S").send_columns([g, x])
        trt.get_input_handler("S").send_columns([g, x])
    jrt.flush()
    trt.flush()
    assert tgot == jgot and len(tgot) == 3


def test_dc1_model_at_a_small_size(monkeypatch):
    """chip_smoke.py's DC1 numpy set model accepts every row the port
    delivers (a flat partition by IP, pools of 8 users)."""
    for k, v in {"DC1_IPS": 64, "DC1_B": 256}.items():
        monkeypatch.setattr(chip_smoke, k, v)
    rng = np.random.default_rng(13)
    model = chip_smoke.DC1Model(np)
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(
        chip_smoke.DC1_QL.replace("131072", "64"))
    got = []
    rt.add_batch_callback("dc1", lambda ts, b: got.append(b))
    rt.start()
    users = []
    for i in range(6):
        cols, ts = chip_smoke.dc1_send(np, rng, i)
        users.append(cols[1])
        got.clear()
        rt.get_input_handler("LoginStream").send_columns(cols, timestamps=ts)
        seen = model.step(cols, ts, list(got), f"DC1 send {i}")
    assert seen == np.unique(np.concatenate(users)).shape[0]


FILTERED = """
@app:playback
define stream ClickStream (user long, page int, dwell double);
@info(name='q') from ClickStream[dwell > 0.0]
select page, distinctCount(user) as users group by page insert into Out;
"""
FILTERED_SENDS = [("ClickStream", [[1, 7, 1.0], [2, 7, 0.0], [2, 7, 2.0],
                                   [1, 8, 1.0]], 1)]


def test_filter_before_distinct_count_divergence():
    """The reference hands the selector each input row's pair slot while
    its pass-through window has compacted the rows that pass the filter
    (`siddhi_tpu/core/planner.py:505-507` beside `window.py:193-195`), so
    after a dropped row the pair slots shift: page 8's first user counts
    0.  The port reads each row's pair slot by its input index: (7, 1),
    (7, 2), (8, 1), as counting the rows that pass gives."""
    want = [(1, [(1, (7, 1)), (1, (7, 2)), (1, (8, 1))], [])]
    assert chip_smoke.corpus_run(TorchManager(device="cpu"), FILTERED, "q",
                                 FILTERED_SENDS) == want
    jax = chip_smoke.corpus_run(JaxManager(), FILTERED, "q", FILTERED_SENDS)
    assert jax == [(1, [(1, (7, 1)), (1, (7, 2)), (1, (8, 0))], [])]


@pytest.mark.parametrize("body,match", [
    ("from S#window.length(4) select g, distinctCount(x) as d "
     "group by g insert into O;", "B14"),
    ("from S select g, unionSet(createSet(x)) as s group by g "
     "insert into O;", "sizeOfSet"),
    ("from S select g, unionSet(x) as s insert into O;", "createSet"),
    ("from S select g, sizeOfSet(x) as s insert into O;", "set value"),
    ("from S select createSet(x) as s insert into O;", "only valid inside"),
    ("from S select distinctCount(x + 1) as d insert into O;",
     "plain attribute"),
    ("from S#window.length(2) as a join S#window.length(2) as b "
     "on a.g == b.g select a.g, distinctCount(b.x) as d insert into O;",
     "join queries"),
])
def test_what_raises(body, match):
    ql = "define stream S (g long, x long);\n" + body
    with pytest.raises(CompileError, match=match):
        TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    with pytest.raises(Exception):
        JaxManager().create_siddhi_app_runtime(ql)


def test_pair_slots_full_raises(caplog):
    """A top-level query has 4,096 group slots and 8 x 4,096 pair slots;
    more distinct (group, value) pairs than that raise, as the
    reference's allocator does."""
    ql = """define stream S (g long, x long);
    @info(name='q') from S select distinctCount(x) as d insert into O;"""
    rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    rt.add_callback("q", lambda *a: None)
    rt.start()
    n = 8 * 4096 + 8
    rt.get_input_handler("S").send_columns(
        [np.zeros(n, np.int64), np.arange(n, dtype=np.int64)])
    assert "exhausted" in caplog.text


def test_purge_leaves_distinct_count_alone(caplog):
    ql = """
    @app:playback
    define stream L (ip long, user long);
    partition with (ip of L) begin
    @purge(enable='true', interval='1 sec', idle.period='2 sec')
    @info(name='q') from L select ip, distinctCount(user) as users
    insert into Out; end;
    """
    with caplog.at_level(logging.WARNING):
        rt = TorchManager(device="cpu").create_siddhi_app_runtime(ql)
    assert "@purge skips query q" in caplog.text
    got = []
    rt.add_callback("q", lambda ts, i, o: got.extend(
        tuple(e.data) for e in i or []))
    rt.start()
    h = rt.get_input_handler("L")
    h.send([1, 10], timestamp=1000)
    h.send([2, 10], timestamp=9000)      # ip 1 idle past the period
    h.send([1, 10], timestamp=9001)
    h.send([1, 11], timestamp=9002)
    rt.flush()
    assert got == [(1, 1), (2, 1), (1, 1), (1, 2)]
