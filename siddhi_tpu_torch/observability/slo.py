"""SLO rules over the time-series sampler (port of
`siddhi_tpu/observability/slo.py`, host code, copied): each rule reads one
series over a window, a breach moves it pending -> firing, and a firing
rule flips the app's health to degraded.

  p99_latency      windowed query p99 (ms) > threshold
  drop_rate        windowed emission drops/s > threshold
  recompile_rate   windowed recompiles/s > threshold (zero in the port)
  stale_stream     last-event age (s) > threshold
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

OK, PENDING, FIRING = "ok", "pending", "firing"
STATE_GAUGE = {OK: 0, PENDING: 1, FIRING: 2}

# rate window for windowed-rate rules (recompiles/s): trailing seconds
_RATE_WINDOW_S = 60.0


@dataclass
class SLORule:
    """One declarative rule: `kind` picks the evaluator, `threshold` the
    bound, `for_ticks` the pending->firing hysteresis."""
    name: str
    kind: str
    threshold: float = 0.0
    query: Optional[str] = None        # max_p99: restrict to one query
    for_ticks: int = 3


def default_rules(config=None) -> List[SLORule]:
    """The standing rule set: zero silent drops, no open breakers, a
    recompile-rate ceiling, and (meshed apps) a shard-imbalance bound.
    `slo.max.p99.ms` opts every query into a p99 ceiling."""
    def prop(name):
        try:
            return config.extract_property(name) \
                if config is not None else None
        except Exception:  # noqa: BLE001 — config must not break boot
            return None

    for_ticks = int(prop("slo.for.ticks") or 3)
    rules = [
        SLORule("zero-drop", "zero_drop", 0.0, for_ticks=1),
        SLORule("breaker-not-broken", "breaker", 0.0, for_ticks=for_ticks),
        SLORule("recompile-rate", "recompile_rate",
                float(prop("slo.recompile.rate.per.s") or 5.0),
                for_ticks=for_ticks),
        SLORule("shard-imbalance", "shard_imbalance",
                float(prop("slo.shard.imbalance.max") or 4.0),
                for_ticks=for_ticks),
    ]
    p99 = prop("slo.max.p99.ms")
    if p99:
        rules.append(SLORule("max-p99", "max_p99", float(p99),
                             for_ticks=for_ticks))
    return rules


class SLOEngine:
    """Evaluates a rule set over one app's SeriesStore each tick and
    tracks per-(app, rule) violation streaks for the pending->firing
    hysteresis.  All reads are host-side (series values, sink states,
    shard counters) — the engine shares the sampler's never-fetch
    invariant."""

    def __init__(self, rules: Optional[List[SLORule]] = None, config=None):
        self.rules = list(rules) if rules else default_rules(config)
        self._streak: Dict = {}       # (app, rule) -> consecutive hits

    # -- per-kind evaluators (value, violated) ---------------------------------
    def _eval(self, rule: SLORule, rt, store) -> tuple:
        kind = rule.kind
        if kind == "zero_drop":
            d = store.get("dropped")
            s = store.get("sink_dropped")
            v = (d.delta() if d is not None else 0.0) + \
                (s.delta() if s is not None else 0.0)
            return v, v > rule.threshold
        if kind == "max_p99":
            worst = 0.0
            for name in store.names():
                if not name.startswith("query.") or \
                        not name.endswith(".p99_us"):
                    continue
                q = name[len("query."):-len(".p99_us")]
                if rule.query is not None:
                    if q != rule.query:
                        continue
                elif ":" in q:
                    continue       # :e2e/:fused ride-alongs opt in by name
                worst = max(worst, (store.last(name) or 0.0) / 1e3)
            return worst, worst > rule.threshold
        if kind == "breaker":
            s = store.get("sink_broken")
            v = s.last if s is not None and s.last is not None else 0.0
            return v, v > rule.threshold
        if kind == "shard_imbalance":
            s = store.get("shard_skew")
            v = s.last if s is not None and s.last is not None else 0.0
            return v, v > rule.threshold
        if kind == "recompile_rate":
            s = store.get("recompiles")
            v = s.rate(_RATE_WINDOW_S) if s is not None else 0.0
            return v, v > rule.threshold
        if kind == "max_queue_depth":
            a = store.get("async_queue_depth")
            d = store.get("drainer_queue_depth")
            v = (a.last or 0.0 if a is not None else 0.0) + \
                (d.last or 0.0 if d is not None else 0.0)
            return v, v > rule.threshold
        return 0.0, False            # unknown kind: never fires

    def evaluate(self, app_name: str, rt, store, now: float) -> Dict:
        """One evaluation pass; returns the `slo` report attached to the
        runtime ({verdict, rules: {name: {state, value, threshold,
        streak}}})."""
        rules_out: Dict[str, Dict] = {}
        verdict = OK
        for rule in self.rules:
            try:
                value, violated = self._eval(rule, rt, store)
            except Exception:  # noqa: BLE001 — a broken rule reads ok,
                value, violated = 0.0, False   # never crashes the tick
            key = (app_name, rule.name)
            streak = self._streak.get(key, 0) + 1 if violated else 0
            self._streak[key] = streak
            state = OK if not violated else \
                (FIRING if streak >= rule.for_ticks else PENDING)
            rules_out[rule.name] = {
                "state": state,
                "value": round(float(value), 6),
                "threshold": rule.threshold,
                "streak": streak,
            }
            if state == FIRING:
                verdict = FIRING
            elif state == PENDING and verdict == OK:
                verdict = PENDING
        return {"verdict": verdict, "now": now, "rules": rules_out}
