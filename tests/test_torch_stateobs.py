"""The port's state observatory (`siddhi_tpu_torch/observability/
stateobs.py`) against the JAX package's, through the API.

Each app runs through both packages on the CPU with the same seeded sends
and `state.obs.sample.every=1`, and after every send `state_report()`'s
`structures` and `hotness` are equal exactly: the same structures (no
`window_fill` wherever the JAX package has none), occupancies, capacities,
high-water marks and key-hotness snapshots.  The apps: a window query, a
partitioned pattern, a join, a keyed window, a two-query merge group and a
`@serve` query.  Then the never-fetch checks: the observatory on and off
make the same number of device fetches (`core/event.py` `device_get`),
and the scrape surfaces run with the fetch patched to raise.
"""
import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.utils.config import InMemoryConfigManager as JaxConfig
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.core import event as tev
from siddhi_tpu_torch.utils.config import InMemoryConfigManager

OBS = {"state.obs.sample.every": "1"}

WINDOW_QL = """@app:playback
define stream S (sym string, price double, vol long);
@info(name='q') from S[price > 10.0]#window.length(24)
select sym, sum(price) as tp group by sym insert into O;
"""

PATTERN_QL = """@app:playback
define stream T (key long, price double);
partition with (key of T) begin
  @info(name='p') from every e1=T[price > 20.0] -> e2=T[price > e1.price]
  select e1.key as k, e2.price as p2 insert into M;
end;
"""

JOIN_QL = """@app:playback
define stream L (k long, v double);
define stream R (k long, w double);
@info(name='j') from L#window.length(16) join R#window.length(16)
  on L.k == R.k
select L.k as k, v, w insert into J;
"""

KEYED_QL = """@app:playback
define stream S (sym string, price double, vol long);
partition with (sym of S) begin
  @info(name='kw') from S#window.length(4)
  select sym, sum(price) as tp insert into K;
end;
"""

MERGED_QL = """@app:playback
define stream S (sym string, price double, vol long);
@info(name='m1') from S[price > 5.0]#window.length(8)
select sym, sum(price) as tp group by sym insert into O1;
@info(name='m2') from S[vol > 2]#window.length(8)
select sym, vol insert into O2;
"""

SERVE_QL = """@app:playback
define stream S (sym string, price double, vol long);
@serve @info(name='sv') from S[price > 10.0]#window.length(12)
select sym, price insert into O;
"""

SYMS = [f"s{i}" for i in range(40)]


def _s_rows(rng, n):
    return [[SYMS[int(rng.zipf(1.5)) % len(SYMS)],
             float(rng.integers(0, 50)), int(rng.integers(0, 6))]
            for _ in range(n)]


def _sends(kind, seed=7, batches=4, n=48):
    """[(stream, rows, ts)] from a seed: a few batches of at most 64
    events."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        ts = 1000 + 100 * b
        if kind == "pattern":
            out.append(("T", [[int(rng.integers(0, 12)),
                               float(rng.integers(0, 60))]
                              for _ in range(n)], ts))
        elif kind == "join":
            for sid in ("L", "R"):
                out.append((sid, [[int(rng.integers(0, 10)),
                                   float(rng.integers(0, 9))]
                                  for _ in range(n // 2)], ts))
        else:
            out.append(("S", _s_rows(rng, n), ts))
    return out


def _run(mgr, ql, sends):
    """state_report()'s structures and hotness after every send."""
    rt = mgr.create_siddhi_app_runtime(ql)
    for q in rt.query_runtimes:
        rt.add_callback(q, lambda *a: None)
    rt.start()
    reps = []
    for sid, rows, ts in sends:
        rt.get_input_handler(sid).send(rows, timestamp=ts)
        rt.flush()
        rep = rt.state_report()
        reps.append({"structures": rep["structures"],
                     "hotness": rep["hotness"]})
    final = rt.state_report()
    final["merged_groups"] = sorted(getattr(rt, "merged_groups", {}))
    mgr.shutdown()
    return reps, final


def _pair(ql, kind, conf=OBS):
    jm = siddhi_tpu.SiddhiManager()
    jm.set_config_manager(JaxConfig(dict(conf)))
    tm = TorchManager(device="cpu")
    tm.set_config_manager(InMemoryConfigManager(dict(conf)))
    sends = _sends(kind)
    return _run(jm, ql, sends), _run(tm, ql, sends)


APPS = {
    "window": (WINDOW_QL, "window", {"q": {"group_slots", "window_fill"}}),
    "pattern": (PATTERN_QL, "pattern", {"p": {"pattern_keys",
                                              "emission_cap"}}),
    "join": (JOIN_QL, "join", {"j": {"join_keys", "join_lane"}}),
    "keyed": (KEYED_QL, "window", {"kw": {"window_keys"}}),
    "merged": (MERGED_QL, "window", {"m1": {"group_slots"}}),
    "serve": (SERVE_QL, "window", {"sv": {"serve_ring"}}),
}


@pytest.fixture(scope="module", params=sorted(APPS))
def app_reports(request):
    ql, kind, expect = APPS[request.param]
    return request.param, expect, _pair(ql, kind)


def test_structures_and_hotness_equal_after_every_send(app_reports):
    name, expect, ((jreps, jfinal), (treps, tfinal)) = app_reports
    assert len(jreps) == len(treps)
    for i, (j, t) in enumerate(zip(jreps, treps)):
        assert t == j, f"{name}: send {i}"
    assert tfinal["structures"] == jfinal["structures"]
    assert tfinal["hotness"] == jfinal["hotness"]
    assert tfinal["near_capacity"] == jfinal["near_capacity"]
    assert tfinal["sizing_hints"] == jfinal["sizing_hints"]
    assert tfinal["merged_groups"] == jfinal["merged_groups"]
    assert bool(tfinal["merged_groups"]) == (name == "merged")
    for q, structs in expect.items():
        assert structs <= set(tfinal["structures"][q]), (name, q)


def test_window_fill_only_where_the_jax_package_has_it(app_reports):
    """The probe arms on unkeyed single-stream steps only: no
    `window_fill` for patterns, joins, keyed windows, merged units or
    @serve queries, in either package."""
    name, _, ((_, jfinal), (_, tfinal)) = app_reports
    has = {q for q, s in tfinal["structures"].items() if "window_fill" in s}
    assert has == {q for q, s in jfinal["structures"].items()
                   if "window_fill" in s}
    assert has == ({"q"} if name == "window" else set())


def test_hotness_fed_at_every_site(app_reports):
    """Group slots, pattern keys, join keys and window keys feed the
    hotness tracker; a merge group's keys feed under its leader."""
    name, _, ((_, jfinal), (_, tfinal)) = app_reports
    want = {"window": {"q"}, "pattern": {"p"}, "join": {"j"},
            "keyed": {"kw"}, "merged": {"m1"}, "serve": set()}[name]
    assert set(tfinal["hotness"]) == set(jfinal["hotness"]) == want


@pytest.mark.parametrize("every", ["0", "3"])
def test_sample_every(every):
    """`state.obs.sample.every`: 0 never probes, N probes every Nth
    dispatch; the fill the probe reads at N matches the JAX package's."""
    conf = {"state.obs.sample.every": every}
    (jr, jfinal), (tr, tfinal) = _pair(WINDOW_QL, "window", conf)
    assert tr == jr
    assert ("window_fill" in tfinal["structures"]["q"]) == (every != "0")


def test_observatory_off():
    """`state.obs.enabled=false`: no structures, no hotness, in both."""
    conf = {"state.obs.enabled": "false", "state.obs.sample.every": "1"}
    (jr, jfinal), (tr, tfinal) = _pair(PATTERN_QL, "pattern", conf)
    assert tr == jr
    assert tfinal["enabled"] is False and not tfinal["hotness"]


class _Count:
    def __init__(self, monkeypatch):
        self.n = 0
        orig = tev.device_get

        def counted(x):
            self.n += 1
            return orig(x)
        monkeypatch.setattr(tev, "device_get", counted)


@pytest.mark.parametrize("ql,kind", [(WINDOW_QL, "window"),
                                     (PATTERN_QL, "pattern"),
                                     (JOIN_QL, "join")],
                         ids=["window", "pattern", "join"])
def test_observatory_adds_no_fetch(monkeypatch, ql, kind):
    """The same device fetches with the observatory on (probe every
    dispatch) and off: the fill counts ride the header's transfer."""
    counts = []
    for conf in ({"state.obs.sample.every": "1"},
                 {"state.obs.enabled": "false"}):
        c = _Count(monkeypatch)
        tm = TorchManager(device="cpu")
        tm.set_config_manager(InMemoryConfigManager(conf))
        _run(tm, "@app:statistics('BASIC')\n" + ql, _sends(kind))
        counts.append(c.n)
    assert counts[0] == counts[1] > 0


def test_scrape_surfaces_never_fetch(monkeypatch):
    """state_report, statistics, health, state_memory, phase_report,
    Prometheus text, healthz and a sampler tick with the device fetch
    patched to raise (reference tests/test_stateobs.py:221-280)."""
    from siddhi_tpu_torch.observability import healthz, render_prometheus
    tm = TorchManager(device="cpu")
    tm.set_config_manager(InMemoryConfigManager(OBS))
    rt = tm.create_siddhi_app_runtime(
        "@app:statistics('DETAIL')\n" + WINDOW_QL)
    rt.add_callback("q", lambda *a: None)
    rt.start()
    for sid, rows, ts in _sends("window"):
        rt.get_input_handler(sid).send(rows, timestamp=ts)
    rt.flush()

    def bomb(x):
        raise AssertionError("a scrape surface fetched from the device")
    monkeypatch.setattr(tev, "device_get", bomb)
    rep = rt.state_report()
    assert rep["structures"]["q"]["window_fill"]["occupancy"] > 0
    rt.statistics()
    rt.health()
    rt.state_memory()
    rt.phase_report()
    rt.trace_dump()
    text = render_prometheus(tm.runtimes)
    assert "siddhi_state_occupancy" in text
    assert healthz(tm)[0] == 200
    sampler = tm.start_sampler(clock=lambda: 0.0)
    sampler.tick(1.0)
    assert rt.timeseries()["enabled"]
    monkeypatch.undo()
    tm.shutdown()
