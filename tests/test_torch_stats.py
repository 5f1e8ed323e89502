"""`@app:statistics` in the port (`siddhi_tpu_torch/utils/statistics.py`,
`observability/`) against the JAX package.

Each app runs through both packages on the CPU with the same seeded sends.
`statistics()`'s event counters, its histograms' sample counts (per query,
`<query>:e2e`, per junction) and its operational counters (emitted rows
and bytes, drops, cap growths, merged dispatches, ring drains) are equal;
latencies and state bytes are not compared.  `render_prometheus` gives the
same metric families and, per family, the same label sets, except the
families of modules the port does not have yet: recompile owners (nothing
re-traces in the port), the error store and the admission controller.
`health()` has the same keys and verdicts.  Then the levels, the include
filter, the DETAIL tracer, the phase report and the console reporter.
"""
import re

import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.observability import render_prometheus as jax_render
from siddhi_tpu.utils.config import InMemoryConfigManager as JaxConfig
from siddhi_tpu_torch import SiddhiManager as TorchManager
from siddhi_tpu_torch.observability import healthz, render_prometheus
from siddhi_tpu_torch.utils.config import InMemoryConfigManager

STATS = "@app:statistics('BASIC')\n"

APPS = {
    "chain": """@app:playback
define stream S (sym string, price double, vol long);
@info(name='q1') from S[price > 10.0]#window.length(16)
select sym, sum(price) as tp group by sym insert into O;
@info(name='q2') from O[tp > 30.0] select sym, tp insert into O2;
""",
    "pattern": """@app:playback
define stream T (key long, price double);
partition with (key of T) begin
  @info(name='p') from every e1=T[price > 20.0] -> e2=T[price > e1.price]
  select e1.key as k, e2.price as p2 insert into M;
end;
""",
    "join": """@app:playback
define stream L (k long, v double);
define stream R (k long, w double);
@info(name='j') from L#window.length(16) join R#window.length(16)
  on L.k == R.k
select L.k as k, v, w insert into J;
""",
    "serve": """@app:playback
define stream S (sym string, price double, vol long);
@serve @info(name='sv') from S[price > 10.0]#window.length(12)
select sym, price insert into O;
""",
    "merged": """@app:playback
define stream S (sym string, price double, vol long);
@info(name='m1') from S[price > 5.0]#window.length(8)
select sym, price insert into O1;
@info(name='m2') from S[vol > 2]#window.length(8)
select sym, vol insert into O2;
""",
}

# families whose machinery the port does not have: recompile owners (no
# per-shape re-trace), the error store, the admission controller
_UNPORTED = {"siddhi_query_recompiles_total", "siddhi_errorstore_events",
             "siddhi_admission_blocked_ms_total",
             "siddhi_admission_quota_state",
             "siddhi_admission_growth_denials_total",
             "siddhi_admission_compile_penalties_total",
             "siddhi_admission_shed_total"}


def _sends(app, seed=5, batches=3, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        ts = 1000 + 100 * b
        if app == "pattern":
            out.append(("T", [[int(rng.integers(0, 12)),
                               float(rng.integers(0, 60))]
                              for _ in range(n)], ts))
        elif app == "join":
            for sid in ("L", "R"):
                out.append((sid, [[int(rng.integers(0, 10)),
                                   float(rng.integers(0, 9))]
                                  for _ in range(n // 2)], ts))
        else:
            out.append(("S", [[f"s{int(rng.integers(0, 9))}",
                               float(rng.integers(0, 50)),
                               int(rng.integers(0, 6))]
                              for _ in range(n)], ts))
    return out


def _run(mgr, app, render):
    rt = mgr.create_siddhi_app_runtime(STATS + APPS[app])
    for q in rt.query_runtimes:
        rt.add_callback(q, lambda *a: None)
    rt.start()
    for sid, rows, ts in _sends(app):
        rt.get_input_handler(sid).send(rows, timestamp=ts)
    rt.flush()
    out = {"stats": rt.statistics(), "health": rt.health(),
           "prom": render({rt.name: rt})}
    mgr.shutdown()
    return out


@pytest.fixture(scope="module", params=sorted(APPS))
def both(request):
    jm = siddhi_tpu.SiddhiManager()
    jm.set_config_manager(JaxConfig({"state.obs.sample.every": "1"}))
    tm = TorchManager(device="cpu")
    tm.set_config_manager(InMemoryConfigManager(
        {"state.obs.sample.every": "1"}))
    return (request.param, _run(jm, request.param, jax_render),
            _run(tm, request.param, render_prometheus))


def _counts(rep):
    return {
        "streams": {s: v["events"] for s, v in rep["streams"].items()},
        "queries": {q: v["events"] for q, v in rep["queries"].items()},
        "junctions": {s: v["count"]
                      for s, v in rep.get("junctions", {}).items()},
        "counters": rep.get("counters", {}),
    }


def test_counters_and_histogram_counts(both):
    app, j, t = both
    assert _counts(t["stats"]) == _counts(j["stats"])
    assert t["stats"]["level"] == "BASIC"
    assert set(t["stats"]["state_bytes_by_query"]) == \
        set(j["stats"]["state_bytes_by_query"])
    assert set(t["stats"]) - {"recompiles"} == \
        set(j["stats"]) - {"recompiles"}
    # nothing feeds the port's recompile registry yet (ROADMAP A15's
    # design note): its counters read zero
    assert "recompiles" not in t["stats"]
    assert t["health"]["totals"]["recompiles"] == 0


def _families(text):
    fams, labels = set(), set()
    for line in text.splitlines():
        m = re.match(r"# TYPE (\S+) ", line)
        if m:
            fams.add(m.group(1))
            continue
        m = re.match(r"([a-zA-Z_:]+?)(_bucket|_sum|_count)?\{(.*)\} ", line)
        if m and not line.startswith("#"):
            keys = frozenset(k for k, _ in
                             re.findall(r'(\w+)="([^"]*)"', m.group(3)))
            base = m.group(1)
            if base not in _UNPORTED:
                labels.add((base + (m.group(2) or ""), keys))
    return fams, labels


def test_prometheus_families_and_labels(both):
    app, j, t = both
    jf, jl = _families(j["prom"])
    tf, tl = _families(t["prom"])
    assert tf == jf - _UNPORTED
    assert tl == jl


def test_health(both):
    app, j, t = both
    jh, th = j["health"], t["health"]
    # the JAX package's admission controller has no counterpart yet
    assert set(th) == set(jh) - {"admission"}
    for k in ("live", "ready", "degraded", "started", "totals",
              "fusion_exclusions"):
        if k == "totals":
            assert {a: b for a, b in th[k].items() if a != "recompiles"} \
                == {a: b for a, b in jh[k].items() if a != "recompiles"}
        else:
            assert th[k] == jh[k], k
    assert {s: v["status"] for s, v in th["streams"].items()} == \
        {s: v["status"] for s, v in jh["streams"].items()}
    if "serving" in jh:
        assert {k: th["serving"][k] for k in ("drainer_alive",
                                             "drainer_stalled", "pending")} \
            == {k: jh["serving"][k] for k in ("drainer_alive",
                                             "drainer_stalled", "pending")}
    assert th["state"]["near_capacity"] == jh["state"]["near_capacity"]
    assert th["state"]["hot_share_1pct"] == jh["state"]["hot_share_1pct"]


def _port_rt(ql, conf=None):
    tm = TorchManager(device="cpu")
    if conf:
        tm.set_config_manager(InMemoryConfigManager(conf))
    rt = tm.create_siddhi_app_runtime(ql)
    for q in rt.query_runtimes:
        rt.add_callback(q, lambda *a: None)
    rt.start()
    for sid, rows, ts in _sends("chain"):
        rt.get_input_handler(sid).send(rows, timestamp=ts)
    rt.flush()
    return tm, rt


def test_off_records_nothing_and_levels_switch():
    tm, rt = _port_rt(APPS["chain"])
    rep = rt.statistics()
    assert rep["level"] == "OFF" and not rep["streams"] and \
        not rep["queries"]
    rt.set_statistics_level("detail")
    rt.get_input_handler("S").send(["s1", 40.0, 3], timestamp=2000)
    rep = rt.statistics()
    assert rep["level"] == "DETAIL" and rep["streams"]["S"]["events"] == 1
    traces = rt.trace_dump()
    assert traces and traces[0]["stream"] == "S"
    assert rt.trace_dump("q1")
    tm.shutdown()


def test_include_filter_and_phase_report():
    ql = ("@app:statistics(level='BASIC', include='streams.S, queries.q1')"
          "\n" + APPS["chain"])
    tm, rt = _port_rt(ql, {"profile.sample.every": "1"})
    rep = rt.statistics()
    assert set(rep["streams"]) == {"S"}
    assert set(rep["queries"]) == {"q1"}
    ph = rt.phase_report()
    q1 = ph["queries"]["q1"]
    assert ph["sample_every"] == 1 and q1["sampled_dispatches"] == 3
    assert {"dispatch_submit", "device_compute", "d2h_drain"} <= \
        set(q1["phases"])
    assert rt.state_memory()["q1"]["window"] > 0
    tm.shutdown()


def test_console_reporter_and_healthz():
    import time
    lines = []
    ql = "@app:statistics(reporter='console', interval='50 millisec')\n" + \
        APPS["chain"]
    tm, rt = _port_rt(ql)
    rt._stats_reporter.out = lines.append
    deadline = time.time() + 10
    while not lines and time.time() < deadline:
        time.sleep(0.02)
    code, payload = healthz(tm)
    tm.shutdown()
    assert lines and lines[0].startswith("{")
    assert code == 200 and payload["apps"][rt.name]["live"]


def test_detail_traces_follow_deferred_deliveries():
    """At DETAIL a `@serve` query's deliveries run on the serving
    drainer's thread under the sending batch's trace (handoff / adopt):
    their spans land on the drain track, and the Chrome trace export has
    the drain lane with a flow arrow from the dispatch."""
    from siddhi_tpu_torch.observability import chrome_trace
    ql = "@app:statistics('DETAIL')\n" + APPS["serve"]
    tm, rt = _port_rt(ql)
    traces = rt.trace_dump("sv")
    drain = [s for t in traces for s in t["spans"]
             if s.get("track") == "drain"]
    assert traces and drain and drain[0]["stage"] == "emit"
    events = chrome_trace(tm.runtimes)["traceEvents"]
    assert any(e["ph"] == "f" and e["name"] == "handoff" for e in events)
    tm.shutdown()


def test_torch_profiler_session(tmp_path):
    """The guarded profiler session: one at a time, its Chrome trace
    written where it was asked."""
    from siddhi_tpu_torch.observability import (profiler_status,
                                                start_profiler,
                                                stop_profiler)
    start_profiler(str(tmp_path))
    with pytest.raises(RuntimeError):
        start_profiler(str(tmp_path))
    assert profiler_status()["running"]
    assert stop_profiler()["log_dir"] == str(tmp_path)
    assert (tmp_path / "trace.json").exists()
    assert not profiler_status()["running"]
    with pytest.raises(RuntimeError):
        stop_profiler()


def test_health_reports_fusion_exclusions():
    """A query whose @fuse request the wiring skipped: health() names it
    with the reason, as the JAX package's does."""
    ql = """@app:playback
define stream S (sym string, price double, vol long);
@fuse(batches='4') @info(name='m1') from S[price > 5.0]#window.length(8)
select sym, price insert into O1;
@fuse(batches='4') @info(name='m2') from S[vol > 2]#window.length(8)
select sym, vol insert into O2;
"""
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    tm = TorchManager(device="cpu")
    trt = tm.create_siddhi_app_runtime(ql)
    want = jrt.health()["fusion_exclusions"]
    assert trt.health()["fusion_exclusions"] == want and want
    tm.shutdown()


def test_recompile_registry_projects_to_its_app():
    """The registry the recompile hook will feed (ROADMAP A15's design
    note): an owner's record appears in its app's report, in health's
    totals and as a Prometheus sample; other owners do not."""
    import torch
    from siddhi_tpu_torch.observability import RECOMPILES
    tm, rt = _port_rt(STATS + APPS["chain"])
    try:
        RECOMPILES.record("q1", (torch.zeros(4, dtype=torch.int32),))
        RECOMPILES.record("elsewhere", ())
        rec = rt.statistics()["recompiles"]
        assert set(rec) == {"q1"} and rec["q1"]["count"] == 1
        assert rec["q1"]["signatures"] == ["int32[4]"]
        assert rt.health()["totals"]["recompiles"] == 1
        assert 'siddhi_query_recompiles_total{app="SiddhiApp",query="q1"} 1' \
            in render_prometheus(tm.runtimes)
    finally:
        RECOMPILES.reset()
        tm.shutdown()
