"""The dispatch decisions of the JAX package's plan facts (port of
`siddhi_tpu/core/plan_facts.py`): which queries request `@async`,
`@pipeline`, `@fuse` and `@serve`, and the whole-app multi-query merge
plan (`merge_plan`), copied as they are so the port's grouping, units and
reason strings equal the JAX package's string for string.  Pure AST
walks: nothing here plans or runs a query.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# default serving emission-ring slot count (serving/ring.py) when neither
# @serve(ring.capacity=) nor `serving.ring.capacity` says otherwise
SERVE_RING_SLOTS = 8


def iter_named_queries(app):
    """(name, query, partition|None) with runtime-identical naming
    (mirrors SiddhiAppRuntime._query_name: @info name, else `query<i>`
    numbered across top-level queries and partition bodies)."""
    from ..query_api.query import Partition, Query
    qi = 0

    def name_of(q) -> str:
        info = q.get_annotation("info")
        if info:
            n = info.element("name")
            if n:
                return n
        return f"query{qi + 1}"

    for element in app.execution_element_list:
        if isinstance(element, Query):
            yield name_of(element), element, None
            qi += 1
        elif isinstance(element, Partition):
            for q in element.query_list:
                yield name_of(q), q, element
                qi += 1


def query_kind(q) -> str:
    from ..query_api.query import JoinInputStream, StateInputStream
    if isinstance(q.input_stream, JoinInputStream):
        return "join"
    if isinstance(q.input_stream, StateInputStream):
        return "pattern"
    return "plain"


def window_handler(sis):
    from ..query_api.query import Window
    for h in getattr(sis, "stream_handlers", ()):
        if isinstance(h, Window):
            return h
    return None


def capacity_annotation(q, part) -> Dict[str, int]:
    """@capacity(keys=, slots=, window=) merged across the query and its
    partition (runtime._add_partition scans both)."""
    out: Dict[str, int] = {}
    anns = list(q.annotations)
    if part is not None:
        anns += list(part.annotations)
        for pq in part.query_list:
            anns += list(pq.annotations)
    for ann in anns:
        if ann.name.lower() == "capacity":
            for k in ("keys", "slots", "window"):
                v = ann.element(k)
                if v is not None:
                    out[k] = int(v)
    return out


def _expr_fp(e) -> str:
    """Stable structural fingerprint of a query_api expression tree —
    two filters with this fingerprint compile to the identical device
    program, which is the merge pass's sharing precondition."""
    from ..query_api import expression as ex
    if e is None:
        return "-"
    if isinstance(e, ex.Constant):
        return f"c:{e.type}:{e.value!r}"
    if isinstance(e, ex.Variable):
        idx = "" if e.stream_index is None else f"[{e.stream_index}]"
        return f"v:{e.stream_id or ''}{idx}.{e.attribute_name}"
    if isinstance(e, ex.Compare):
        return f"({_expr_fp(e.left)}{e.operator}{_expr_fp(e.right)})"
    if isinstance(e, ex.Not):
        return f"not({_expr_fp(e.expression)})"
    if isinstance(e, ex.IsNull):
        if getattr(e, "expression", None) is not None:
            return f"isnull({_expr_fp(e.expression)})"
        return f"isnull({e.stream_id})"
    if isinstance(e, ex.In):
        return f"in({_expr_fp(e.expression)},{e.source_id})"
    if isinstance(e, ex.AttributeFunction):
        ns = f"{e.namespace}:" if e.namespace else ""
        args = ",".join(_expr_fp(p) for p in e.parameters)
        return f"f:{ns}{e.name}({args})"
    left = getattr(e, "left", None)
    right = getattr(e, "right", None)
    if left is not None and right is not None:
        return f"{type(e).__name__}({_expr_fp(left)},{_expr_fp(right)})"
    return type(e).__name__


def handler_fingerprints(sis) -> Tuple[Tuple[str, ...], str,
                                       Tuple[str, ...]]:
    """(pre-window chain, window, post-window chain) fingerprints of a
    SingleInputStream's handler chain.  Queries can only share one
    window buffer when the pre-chain AND window fingerprints agree —
    different pre-filters would admit different rows into the buffer."""
    from ..query_api.query import Filter, StreamFunction, Window
    pre: List[str] = []
    post: List[str] = []
    win = "-"
    seen = False
    for h in getattr(sis, "stream_handlers", ()):
        if isinstance(h, Window):
            ns = f"{h.namespace}:" if h.namespace else ""
            win = f"w:{ns}{h.name}(" + ",".join(
                _expr_fp(p) for p in h.parameters) + ")"
            seen = True
        elif isinstance(h, Filter):
            (post if seen else pre).append(f"filt:{_expr_fp(h.expression)}")
        elif isinstance(h, StreamFunction):
            ns = f"{h.namespace}:" if h.namespace else ""
            fp = f"fn:{ns}{h.name}(" + ",".join(
                _expr_fp(p) for p in h.parameters) + ")"
            (post if seen else pre).append(fp)
    return tuple(pre), win, tuple(post)


def async_enabled(app, q) -> bool:
    """@async on the app, the query, or any input stream definition —
    the ONE implementation runtime wiring (`_async_enabled`) and the
    merge planner share."""
    if app.get_annotation("async") is not None:
        return True
    if q.get_annotation("async") is not None:
        return True
    ist = q.input_stream
    sids = getattr(ist, "all_stream_ids", None) or \
        [getattr(ist, "stream_id", None)]
    for sid in sids:
        sdef = app.stream_definition_map.get(sid)
        if sdef is not None and sdef.get_annotation("async") is not None:
            return True
    return False


def pipeline_depth(app, q) -> int:
    """@pipeline(depth=k) on the query (wins) or @app:pipeline; 0 = off
    (shared by runtime `_pipeline_enabled` and the merge planner)."""
    ann = q.get_annotation("pipeline")
    if ann is None:
        ann = app.get_annotation("app:pipeline")
    if ann is None:
        return 0
    return max(1, int(ann.element("depth", 1) or 1))


def fuse_depth(app, q) -> int:
    """@fuse(batches=K) on the query, any input stream definition, or
    @app:fuse; 0 = off (shared by runtime `_fuse_enabled`, lint's
    `fuse_requested`, and the merge planner)."""
    ann = q.get_annotation("fuse")
    if ann is None:
        ist = q.input_stream
        sids = getattr(ist, "all_stream_ids", None) or \
            [getattr(ist, "stream_id", None)]
        for sid in sids:
            sdef = app.stream_definition_map.get(sid)
            if sdef is not None and \
                    sdef.get_annotation("fuse") is not None:
                ann = sdef.get_annotation("fuse")
                break
    if ann is None:
        ann = app.get_annotation("app:fuse")
    if ann is None:
        return 0
    k = ann.element("batches", ann.element(None, 8)) or 8
    return max(1, int(k))


def serve_enabled(app, q) -> bool:
    """@serve on the query, any input stream definition, or @app:serve —
    the device-resident serving loop (siddhi_tpu/serving): emissions
    append to an on-device ring and the async drainer delivers them;
    the send path never fetches.  `enabled='false'` opts a query out of
    an app-wide @app:serve.  The ONE implementation runtime wiring
    (`_serve_enabled`), the merge planner, EXPLAIN, and lint SERVE001
    share.  (The `serving.enabled` config property enables serving at
    the runtime level without annotations — that path is resolved in
    runtime wiring, not here: plan facts stay pure AST.)"""
    ann = q.get_annotation("serve")
    if ann is None:
        ist = q.input_stream
        sids = getattr(ist, "all_stream_ids", None) or \
            [getattr(ist, "stream_id", None)]
        for sid in sids:
            sdef = app.stream_definition_map.get(sid)
            if sdef is not None and \
                    sdef.get_annotation("serve") is not None:
                ann = sdef.get_annotation("serve")
                break
    if ann is None:
        ann = app.get_annotation("app:serve")
    if ann is None:
        return False
    flag = str(ann.element("enabled", "true") or "true").lower()
    return flag not in ("false", "0", "no", "off")


def serve_ring_capacity(app, q) -> int:
    """@serve(ring.capacity=S) on the query (wins) or @app:serve; 0
    means "use the `serving.ring.capacity` config property / default"."""
    ann = q.get_annotation("serve")
    if ann is None:
        ann = app.get_annotation("app:serve")
    if ann is None:
        return 0
    try:
        return max(0, int(ann.element("ring.capacity", 0) or 0))
    except Exception:  # noqa: BLE001 — malformed element reads as unset
        return 0


def merge_decorations(app, q) -> Tuple:
    """The emission/dispatch decorations that must agree across a merge
    group: members of one dispatch share the demux path, so @async,
    @pipeline depth, @fuse K, and @serve cannot differ within a
    group."""
    return (async_enabled(app, q), pipeline_depth(app, q),
            fuse_depth(app, q), serve_enabled(app, q))


def merge_ineligibility(app, q, kind: str, part,
                        mesh_devices: int = 0) -> Optional[str]:
    """Why ONE query can never join any merge group (None = eligible).
    Static AST properties only — the runtime optimizer pass re-validates
    against the actual plan and demotes on any surprise."""
    if mesh_devices > 1:
        return (f"app deployed on a {mesh_devices}-device mesh — "
                f"sharded dispatch is not merged")
    if part is not None:
        return "partitioned query — per-key dispatch is not merged"
    if kind == "pattern":
        return "pattern/sequence NFA keeps its own per-stream steps"
    if kind == "join":
        return "join side steps keep their own dispatch"
    sid = q.input_stream.unique_stream_id
    if sid in getattr(app, "window_definition_map", {}):
        return ("named-window input is delivered by the window "
                "runtime, not a stream junction")
    win = window_handler(q.input_stream)
    if win is not None:
        from .window import window_types
        WINDOW_TYPES = window_types()
        full = (win.namespace + ":" if win.namespace else "") + win.name
        cls = WINDOW_TYPES.get(full)
        if cls is not None and getattr(cls, "needs_timer", False):
            return (f"timer-bearing window ({full}) — the device wake "
                    f"scalar cannot ride a merged dispatch")
        if win.name == "session" and len(win.parameters) >= 2:
            return ("session(gap, key) runs the keyed-window slab — "
                    "per-key dispatch is not merged")
    return None


def _in_table_deps(app, q) -> set:
    """Tables this query probes with the `in` operator (filters +
    selector expressions) — merge-relevant because an unmerged plan
    lets a query observe a co-resident query's SAME-BATCH table writes,
    which a merged dispatch (one table snapshot per dispatch) would
    relax; the planner demotes such probers instead of relaxing."""
    from ..query_api.expression import In, walk
    from ..query_api.query import Filter
    exprs = []
    for h in getattr(q.input_stream, "stream_handlers", ()):
        if isinstance(h, Filter):
            exprs.append(h.expression)
    sel = q.selector
    exprs += [oa.expression for oa in sel.selection_list]
    if sel.having_expression is not None:
        exprs.append(sel.having_expression)
    deps = set()
    for e in exprs:
        for node in walk(e):
            if isinstance(node, In):
                deps.add(node.source_id)
    return {d for d in deps if d in app.table_definition_map}


def merge_plan(app, mesh_devices: int = 0) -> Dict:
    """The whole-app merge decision, statically.

    Returns ``{"groups": [...], "reasons": {query: reason}}`` where each
    group is ``{"group", "stream", "members", "decorations", "units"}``
    and each unit is ``{"mode": "shared"|"solo", "members": [...]}``.
    A *shared* unit's members stage one window buffer and one group-slot
    space (identical pre-chain + window + group-by); *solo* units run
    their full per-query body inside the merged dispatch.  Every query
    in no group appears in ``reasons`` with the planner's exact
    ineligibility string — lint MQO001, EXPLAIN, and the runtime
    optimizer pass (siddhi_tpu/optimizer) all read THIS plan."""
    reasons: Dict[str, str] = {}
    eligible: List[Tuple[str, object, Tuple]] = []
    for name, q, part in iter_named_queries(app):
        kind = query_kind(q)
        why = merge_ineligibility(app, q, kind, part, mesh_devices)
        if why is not None:
            reasons[name] = why
            continue
        eligible.append((name, q, merge_decorations(app, q)))

    # dispatch groups: same stream + same @async/@pipeline/@fuse
    by_key: Dict[Tuple, List[Tuple[str, object]]] = {}
    order: List[Tuple] = []
    for name, q, deco in eligible:
        key = (q.input_stream.unique_stream_id, deco)
        if key not in by_key:
            by_key[key] = []
            order.append(key)
        by_key[key].append((name, q))

    groups: List[Dict] = []
    per_stream: Dict[str, int] = {}
    for key in order:
        sid, deco = key
        members = by_key[key]
        # exactness demotions: merging must stay BYTE-IDENTICAL per
        # query, so (a) a member inserting into the group's own input
        # stream keeps its own dispatch (the unmerged plan interleaves
        # the feedback recursion mid-fanout; a merged demux would
        # reorder what co-members' windows see), and (b) a member
        # probing a table a CO-MEMBER writes keeps its own dispatch
        # (unmerged, it observes same-batch writes; a merged dispatch
        # snapshots tables once)
        written = {q.output_stream.target_id: name
                   for name, q in members
                   if q.output_stream is not None and
                   q.output_stream.target_id in app.table_definition_map}
        demoted: List[Tuple[str, str]] = []
        for name, q in members:
            if q.output_stream is not None and \
                    q.output_stream.target_id == sid:
                demoted.append((name, (
                    f"inserts into its own input stream {sid!r} — "
                    f"merging would reorder the feedback loop the "
                    f"unmerged fan-out interleaves")))
                continue
            hit = sorted(t for t in _in_table_deps(app, q)
                         if written.get(t) not in (None, name))
            if hit:
                demoted.append((name, (
                    f"probes table {hit[0]!r} written by co-resident "
                    f"query {written[hit[0]]!r} — same-batch "
                    f"read-your-writes must stay exact")))
        if demoted:
            dropped = {n for n, _ in demoted}
            for name, why in demoted:
                reasons[name] = why
            members = [(n, q) for n, q in members if n not in dropped]
        if len(members) < 2:
            for name, _q in members:
                reasons[name] = (
                    f"no co-resident query shares stream {sid!r} and "
                    f"its @async/@pipeline/@fuse/@serve decorations")
            continue
        gi = per_stream.get(sid, 0)
        per_stream[sid] = gi + 1
        gid = f"{sid}#{gi}"
        # state-share units: identical pre-chain + window + group-by
        # (and window capacity) members reference ONE window buffer and
        # ONE group-slot space; windowless members stay solo (their
        # window state is a scalar seq counter — nothing to share)
        units: List[Dict] = []
        shared: Dict[Tuple, List[str]] = {}
        shared_order: List[Tuple] = []
        for name, q in members:
            pre, win, _post = handler_fingerprints(q.input_stream)
            if win == "-":
                units.append({"mode": "solo", "members": [name]})
                continue
            caps = capacity_annotation(q, None)
            gby = tuple(_expr_fp(v) for v in q.selector.group_by_list)
            skey = (pre, win, gby, caps.get("window", 0))
            if skey not in shared:
                shared[skey] = []
                shared_order.append(skey)
                units.append({"mode": "solo", "members": [],
                              "_skey": skey})
            shared[skey].append(name)
        resolved: List[Dict] = []
        for u in units:
            skey = u.pop("_skey", None)
            if skey is None:
                resolved.append(u)
                continue
            names = shared[skey]
            resolved.append({
                "mode": "shared" if len(names) >= 2 else "solo",
                "members": names})
        groups.append({
            "group": gid, "stream": sid,
            "members": [n for n, _ in members],
            "decorations": {"async": bool(deco[0]),
                            "pipeline": int(deco[1]),
                            "fuse": int(deco[2]),
                            "serve": bool(deco[3])},
            "units": resolved,
        })
    return {"groups": groups, "reasons": reasons}
