"""Chip smoke test of the PyTorch / CUDA port (siddhi_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. the card: name and power limit from nvidia-smi;
  2. build: compiles the five kernels of siddhi_tpu_torch/csrc/ with
     nvcc, one process each, all started together;
  3. pattern_step vs plain: the kernel against its plain PyTorch version
     on the card from the same state, on seeded random traffic: the
     flagship query at its step's shapes (2^20-key state, 131,072 keys per
     send, 4 events per key, and one send of 1 event per key), a within /
     bool / string query and a two-stream query without `every` at 65,536
     keys; dense and gather steps, ts-delta and raw-ts wires, compacted and
     uncompacted rows.  State blobs, overflow counter, header and the
     valid output rows must be equal (floats: NaN equals NaN, +0 equals
     -0, otherwise exact);
  4. timing at the flagship step's shapes, on the flagship's own traffic
     and on random traffic: the kernel (CUDA events) beside its plain
     version and the bound of the bytes and operations these inputs need;
  5. the flagship through SiddhiManager at full size: 2^20 partition keys,
     131,072-key sends of 4 events each, one warm sweep and 4 timed sweeps;
     the match count must be 4 x 2^20 with the kernel launched and the
     plain step never called, and sampled match rows must hold the values
     the traffic implies.  Per-send p50 / p99 are over the 32 timed sends,
     so p99 is close to the slowest send;
  6. the single-stream kernels filter_compact, time_window, length_batch
     and group_agg against their plain versions on the card from the same
     state (exact: every row, state word and float equal, NaN equal to
     NaN): all-pass, all-drop, partial and empty batches; in-order, equal
     and out-of-order timestamps, TIMER-only steps, an overflowing ring, a
     step that expires the whole window and TIMER steps sized by a
     deliberately short expire bound (both versions must leave the ring
     as it was and report the missed rows); sends with no, one and 131
     flushes; add / min / max on each dtype with RESET epochs and rows
     without a group slot;
  7. three configurations through SiddhiManager, 32 timed sends of
     131,072 events each: bench.py's config_time_groupby_having with a
     2^24-row window (13,107,200 rows alive: each send one TIMER step that
     expires 131,072 rows and one data step that appends 131,072), its
     config_length_batch (about 131 flushes per send) and the
     simple_filter sample (about half the rows pass); each with its
     closed-form checks against numpy (config 1: count, avg and the f32
     sum of every symbol), every kernel of its path launched
     and no plain version called;
  8. per-kernel times on the configurations' own traffic (CUDA-graph
     replays between CUDA events), the plain versions' times and the bound
     of the bytes the inputs need;
  9. a profiled sweep of config 1: device busy time, idle share, top ops.
It prints one JSON line of kernel records, the card line, and as its last
line {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

N_KEYS = 1 << 20          # partition keys (bench.py's flagship size)
BATCH = 1 << 17           # keys per send, 4 events each
SWEEPS = 4                # timed sweeps over all keys
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12        # non-tensor float32, H100 SXM data sheet


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def random_step_inputs(rng, torch, dev, types, K, Kb, E, dense,
                       wide_ts=False):
    """One send's raw columns (by attribute type: LONG keys, INT volumes
    1-4, FLOAT prices with a few NaN, BOOL flags, STRING ids with nulls),
    timestamps as the ts-delta wire and as the raw i64 column, the [Kb, E]
    selection and the key reference: ~10% padding events, and in gather
    mode random distinct keys with ~5% padding rows.  `wide_ts` spreads the
    timestamps past the int32 range, as when the runtime takes the raw-ts
    step."""
    import numpy as np
    B = Kb * E
    cols = []
    for t in types:
        if t == "LONG":
            c = rng.integers(0, K, B).astype(np.int64)
        elif t == "INT":
            c = rng.integers(1, 5, B).astype(np.int32)
        elif t in ("FLOAT", "DOUBLE"):
            c = rng.random(B).astype(np.float32)
            c[rng.random(B) < 0.01] = np.nan
        elif t == "BOOL":
            c = rng.random(B) < 0.5
        else:
            c = rng.integers(-1, 3, B).astype(np.int32)
        cols.append(torch.from_numpy(c).to(dev))
    span = (1 << 33) if wide_ts else 4 * B
    ts = 1000 + np.sort(rng.integers(0, span, B)).astype(np.int64)
    sel = rng.permutation(B).astype(np.int32).reshape(Kb, E)
    sel[rng.random((Kb, E)) < 0.1] = -1
    if dense:
        key_ref = int(rng.integers(0, K - Kb + 1))
    else:
        ki = rng.choice(K, Kb, replace=False).astype(np.int32)
        pad = rng.random(Kb) < 0.05
        ki[pad] = K
        sel[pad] = -1
        key_ref = torch.from_numpy(ki).to(dev)
    wire = None if wide_ts else \
        (int(ts[0]), torch.from_numpy((ts - ts[0]).astype(np.int32)).to(dev))
    now = int(ts[-1])
    return (tuple(cols), wire, torch.from_numpy(ts).to(dev),
            torch.from_numpy(sel).to(dev), key_ref, now)


def compare_plan(torch, planned, K, Kb, sends, rng, dev):
    """Each of `sends` (stream, dense, ts wire, events per key) through the
    kernel and its plain version from the same initial state; returns the
    largest float difference and the final states (plain, kernel)."""
    plain_state = planned.init_state(K)[0]
    kern_state = (plain_state[0].clone(), plain_state[1].clone(),
                  tuple(s.clone() for s in plain_state[2]))
    max_err = 0.0
    for it, (stream, dense, wire, E) in enumerate(sends):
        kind = (f"{stream} {'dense' if dense else 'gather'} "
                f"{'ts-delta' if wire else 'raw-ts'} E={E}")
        steps = (planned.dense_steps_w if wire else planned.dense_steps) \
            if dense else (planned.steps_w if wire else planned.steps)
        step = steps[stream]
        cols, tsw, raw_ts, sel, key_ref, now = random_step_inputs(
            rng, torch, dev, planned.in_schemas[stream].types, K, Kb, E,
            dense, wide_ts=not wire)
        ts_args = tsw if wire else (raw_ts,)
        before = (plain_state[0].clone(), plain_state[1].clone())
        EP = E * (planned.slots + 1)
        compact = min(planned.compact_rows, EP) < EP
        a = step.plain(plain_state, (), cols, *ts_args, sel, key_ref, now)
        b = step.kernel(kern_state, (), cols, *ts_args, sel, key_ref, now)
        torch.cuda.synchronize()
        if not torch.equal(a[0][0], b[0][0]) or \
                not torch.equal(a[0][1], b[0][1]):
            describe_state_mismatch(torch, planned, before, a[0], b[0],
                                    sel, key_ref, cols, ts_args, now)
        err, header = compare_steps(
            torch, a, b, f"{planned.name} step {it} ({kind})", compact)
        max_err = max(max_err, err)
        plain_state, kern_state = a[0], b[0]
        print(f"compare: {planned.name} step {it} {kind} "
              f"{'compacted' if compact else 'uncompacted'} rows equal, "
              f"header {header}")
    return max_err, plain_state, kern_state


def describe_state_mismatch(torch, planned, before, pa, pb, sel, key_ref,
                            cols, ts_args, now):
    """Print, to stderr, where the kernel's state left the plain step's:
    the differing rows by leaf, and the first differing key's state before
    and after both steps (rows that changed or differ, and the control
    rows) with its events."""
    names = ["active", "pos", "count", "lmask", "start", "entry", "seed_on",
             "done", "dropped"]
    caps = planned.packer._caps_layout
    for ck, n in caps:
        names += [f"{ck}.ts"] + [f"{ck}.c{j}" for j in range(n)]
    rows = {"i32": [], "i64": []}
    for name, (kind, _, _, off, width) in zip(names, planned.packer.recs):
        if kind != "scalar":
            rows[kind] += [f"{name}[{j}]" for j in range(width)]
    first = None
    for kind, i in (("i32", 0), ("i64", 1)):
        diff = pa[i] != pb[i]
        if not bool(diff.any()):
            continue
        r = diff.any(1).nonzero().flatten().tolist()
        c = diff.any(0).nonzero().flatten()
        print(f"mismatch {kind}: {int(diff.sum())} words in {c.numel()} "
              f"keys; rows {[rows[kind][x] for x in r]}", file=sys.stderr)
        first = int(c[0]) if first is None else min(first, int(c[0]))
    if isinstance(key_ref, int):
        k = first - key_ref
    else:
        k = int((key_ref == first).nonzero().flatten()[0])
    ev_idx = sel[k].tolist()
    print(f"key column {first} (row {k}), sel {ev_idx}, now {now}",
          file=sys.stderr)
    for e in ev_idx:
        if e >= 0:
            ts = (int(ts_args[0]) + int(ts_args[1][e]) if len(ts_args) == 2
                  else int(ts_args[0][e]))
            print(f"  event {e}: ts {ts} cols "
                  f"{[c[e].item() for c in cols]}", file=sys.stderr)
    for kind, i in (("i32", 0), ("i64", 1)):
        for r, name in enumerate(rows[kind]):
            x, y, z = (int(before[i][r, first]), int(pa[i][r, first]),
                       int(pb[i][r, first]))
            if x == y == z and name.split("[")[0] not in (
                    "active", "pos", "start", "seed_on", "done"):
                continue
            flag = "  <-- differs" if y != z else ""
            print(f"  {name}: before {x} plain {y} kernel {z}{flag}",
                  file=sys.stderr)


def compare_steps(torch, a, b, what, compact):
    """Kernel result `b` against plain result `a`; returns the largest
    absolute float difference over valid output rows and the header.
    Compacted rows must be equal
    throughout (both sides zero the rows that hold no match); uncompacted
    rows must be equal where valid, since a row without a match carries
    no event and the plain step leaves its event's timestamp there."""
    (pa, _, oa, _), (pb, _, ob, _) = a, b
    if not torch.equal(pa[0], pb[0]) or not torch.equal(pa[1], pb[1]):
        fail(f"{what}: state blobs differ")
    if int(pa[2][0]) != int(pb[2][0]):
        fail(f"{what}: overflow counter {int(pa[2][0])} != {int(pb[2][0])}")
    ha, hb = (int(oa[0]), int(oa[1])), (int(ob[0]), int(ob[1]))
    if ha != hb:
        fail(f"{what}: header {ha} != {hb}")
    if not torch.equal(oa[4], ob[4]):
        fail(f"{what}: valid masks differ")
    v = oa[4]
    if compact:
        rows_a, rows_b = (oa[2], oa[3], *oa[5]), (ob[2], ob[3], *ob[5])
    else:
        rows_a, rows_b = ((x[v] for x in (oa[2], oa[3], *oa[5])),
                          (x[v] for x in (ob[2], ob[3], *ob[5])))
    for i, (ca, cb) in enumerate(zip(rows_a, rows_b)):
        try:
            torch.testing.assert_close(ca, cb, rtol=0, atol=0,
                                       equal_nan=True)
        except AssertionError as exc:
            fail(f"{what}: output {('ts', 'kind')[i] if i < 2 else 'column'}"
                 f" rows differ: {exc}")
    err = 0.0
    for ca, cb in zip(oa[5], ob[5]):
        if ca.dtype.is_floating_point and bool(v.any()):
            x, y = ca[v], cb[v]
            both = ~(torch.isnan(x) & torch.isnan(y))
            if bool(both.any()):
                err = max(err, float((x[both] - y[both]).abs().max()))
    return err, ha


def device_profile(torch, rt, blocks, send):
    """One more flagship sweep under torch.profiler: its wall, the time of
    the device activities (kernels and copies, not the host ops that
    launched them, and not the profiler's own buffer requests), and the
    largest of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rt.flush()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(blocks):
            send(b)
        rt.flush()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                e.key == "Activity Buffer Request":
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops.append((e.key[:60], us / 1e3, e.count))
    ops.sort(key=lambda x: -x[1])
    device_ms = sum(t for _, t, _ in ops)
    if device_ms <= 0:          # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "top": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms, "top": ops[:6]}


def timed(torch, restore, fn, rounds, per):
    """Mean device ms of one fn(j) call: `rounds` rounds of fn(0) ..
    fn(per - 1) between two CUDA events, the state restored before each
    round outside the events (the restore keeps the device busy while the
    host queues the round)."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(rounds):
        restore()
        start.record()
        for j in range(per):
            fn(j)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / (rounds * per)


def replicate_block(state, Kb):
    """Copy the state of keys [0, Kb) into every other block of Kb keys,
    so that dense steps on any block do the same work."""
    for blob in state[:2]:
        v = blob.view(blob.shape[0], blob.shape[1] // Kb, Kb)
        v[:, 1:] = v[:, :1]


def flagship_inputs(torch, dev, Kb):
    """One block's send as the flagship's main path stages it: each key's
    4 events with volumes 1-4 and price = volume, ts deltas 0-3."""
    vol = torch.arange(1, 5, dtype=torch.int32, device=dev).repeat(Kb)
    key = torch.arange(Kb, dtype=torch.int64, device=dev).repeat_interleave(4)
    delta = torch.arange(4, dtype=torch.int32, device=dev).repeat(Kb)
    sel = torch.arange(Kb * 4, dtype=torch.int32, device=dev).view(Kb, 4)
    return (key, vol.to(torch.float32), vol), delta, sel


POISON32, POISON64 = 0x5A5A5A5A, 0x5A5A5A5A5A5A5A5A


def must_move(torch, step, before, after, cols, wire, sel, key_lo, now,
              nrows, out_row):
    """Bytes and operations one dense step on keys [key_lo, key_lo + Kb)
    needs for these inputs, counting only what the data requires.

    Read: the selection; the columns and ts delta of the events it selects;
    each key's control words (P `active` flags, `seed_on`, `done`); for
    every slot live when the key's events arrive, its `pos` word and the
    capture words its atom's filter loads; with `within`, each active
    slot's `start`.  Written: the output rows, the header, and every state
    word the step assigns.  The assigned words are found by running the
    plain step once more from a copy of `before` whose other rows (those
    the step's decisions never read) hold a marker value: a word that no
    longer holds it was assigned.  On the rows the decisions do read, a
    word counts as written where its value changed.  Operations: one per
    bytecode word of the seed filter on each event that reaches the NFA
    (the least any step evaluates)."""
    from siddhi_tpu_torch.kernels.filter_bytecode import cap_loads
    t = step.kernel_plan.template
    P, S = step.kernel_plan.P, t.S
    Kb = sel.shape[0]
    ks = slice(key_lo, key_lo + Kb)
    b32, b64 = before[0][:, ks], before[1][:, ks]
    valid = sel >= 0
    n = sel.numel() * 4 + int(valid.sum()) * (
        sum(c.element_size() for c in cols) + 4)
    n += Kb * (P + 2) * 4
    active = b32[t.off_active:t.off_active + P] != 0
    done = b32[t.off_done] != 0
    live = active & (valid.any(1) & ~done)[None]
    loads = [cap_loads(list(t.code[t.code_start[a]:
                                   t.code_start[a] + t.code_len[a]]))
             for a in range(S)]
    cap_bytes = torch.tensor(
        [4 + sum(8 if t.cap_ty[a][c] == 1 else 4 for a, c in ld)
         for ld in loads], dtype=torch.int64, device=sel.device)
    pos = b32[t.off_pos:t.off_pos + P].long().clamp(0, S - 1)
    n += int(cap_bytes[pos][live].sum())
    if t.has_within:
        n += int(active.sum()) * 8
    # rows the step's decisions read keep their values; the rest are marked
    read32 = torch.zeros(before[0].shape[0], dtype=torch.bool)
    read64 = torch.zeros(before[1].shape[0], dtype=torch.bool)
    for off, width in ((t.off_active, P), (t.off_pos, P),
                       (t.off_seed_on, 1), (t.off_done, 1)):
        read32[off:off + width] = True
    if t.has_within:
        read64[t.off_start:t.off_start + P] = True
    for a, c in {x for ld in loads for x in ld}:
        rows = read64 if t.cap_ty[a][c] == 1 else read32
        rows[t.cap_off[a][c]:t.cap_off[a][c] + P] = True
    m32 = before[0].clone()
    m64 = before[1].clone()
    m32[~read32] = POISON32
    m64[~read64] = POISON64
    step.plain((m32, m64, tuple(x.clone() for x in before[2])), (), cols,
               *wire, sel, key_lo, now)
    for blob, marked, read, poison, size in (
            (b32, m32, read32, POISON32, 4), (b64, m64, read64, POISON64, 8)):
        r = read.to(sel.device)[:, None]
        after_blob = after[0 if size == 4 else 1][:, ks]
        written = torch.where(r, after_blob != blob,
                              marked[:, ks] != poison)
        n += int(written.sum()) * size
    n += nrows * out_row + 16
    seed_on = b32[t.off_seed_on] != 0
    ops = int((valid & (seed_on & ~done)[:, None]).sum()) * t.code_len[0]
    return n, ops


def time_traffic(torch, ps, step, state, cols, wire, sel, now):
    """Kernel, kernel + projection and plain step at one send's inputs on
    a state whose Kb-key blocks are all alike: each timed call is a dense
    step on the next block, from the same restored state.  Returns the
    times and the bound of one step."""
    kp = step.kernel_plan
    b32, b64, scal = state
    Kb = sel.shape[0]
    per = b32.shape[1] // Kb
    snap = (b32.clone(), b64.clone(), tuple(x.clone() for x in scal))
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=b32.device)

    def restore():
        b32.copy_(snap[0])
        b64.copy_(snap[1])
        for x, y in zip(scal, snap[2]):
            x.copy_(y)
        # read 256 MB, so that the copy's dirty lines leave L2 before the
        # timed launches rather than during them
        flush.sum()

    restore()
    kout = ps.launch(kp, state, cols, None, wire, sel, 0, now, True)[1]
    nrows = kout[1].shape[0]
    out_row = 8 + 4 + 1 + sum(c.element_size() for c in kout[4].values())
    nbytes, ops = must_move(torch, step, snap, state, cols, wire, sel, 0,
                            now, nrows, out_row)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_PER_S * 1e3
    res = {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    res["ms"] = timed(torch, restore, lambda j: ps.launch(
        kp, state, cols, None, wire, sel, j * Kb, now, True), 6, per)
    res["step_ms"] = timed(torch, restore, lambda j: step.kernel(
        state, (), cols, *wire, sel, j * Kb, now), 3, per)
    res["plain_ms"] = timed(torch, restore, lambda j: step.plain(
        state, (), cols, *wire, sel, j * Kb, now), 1, per)
    restore()
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import numpy as np
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.kernels import pattern_step as ps

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build: every kernel, one nvcc each, all started together ----------
    from siddhi_tpu_torch.kernels import _nvcc
    t0 = time.perf_counter()
    _nvcc.build_all()
    ps.build()
    build_s = time.perf_counter() - t0
    print(f"build: {len(_nvcc.SOURCES)} kernels in {build_s:.2f} s")
    for name in _nvcc.SOURCES:
        for ln in _nvcc.ptxas_report(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}")

    ql = FLAGSHIP_QL.format(n_keys=N_KEYS)

    # -- kernel vs plain at the flagship step's shapes -----------------------
    # (stream, dense, ts-delta wire, events per key): dense and gather
    # steps, the raw-ts step the runtime takes when a send's ts span does
    # not fit in int32, and one event per key
    T = "TradeStream"
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(ql)
    planned = rt.query_runtimes["flagship"].planned
    rng = np.random.default_rng(7)
    max_err, _, kern_state = compare_plan(
        torch, planned, N_KEYS, BATCH,
        [(T, True, True, 4), (T, False, True, 4)] * 3 +
        [(T, True, False, 4), (T, False, True, 1)], rng, dev)
    n_sends = 8
    # at 65,536 keys: within, bool and string columns, integer division,
    # 3 slots, and one event per key (uncompacted rows under the default
    # cap of 8)
    vrt = SiddhiManager(device=dev).create_siddhi_app_runtime(VARIANT_QL)
    sends = [("T", True, True, 4), ("T", False, True, 4),
             ("T", True, True, 1), ("T", False, False, 1),
             ("T", True, False, 4), ("T", False, True, 4)]
    err, _, _ = compare_plan(torch, vrt.query_runtimes["variant"].planned,
                             1 << 16, 1 << 14, sends, rng, dev)
    max_err, n_sends = max(max_err, err), n_sends + len(sends)
    # a pattern without `every` across two streams
    trt = SiddhiManager(device=dev).create_siddhi_app_runtime(TWO_STREAM_QL)
    sends = [("A", True, True, 4), ("B", False, True, 4),
             ("A", False, True, 1), ("B", True, False, 1),
             ("A", True, True, 4), ("B", False, True, 4),
             ("A", True, False, 4), ("B", True, True, 1)]
    err, _, _ = compare_plan(torch, trt.query_runtimes["two"].planned,
                             1 << 16, 1 << 14, sends, rng, dev)
    max_err, n_sends = max(max_err, err), n_sends + len(sends)
    print(f"compare: kernel == plain over {n_sends} sends, max_abs_err "
          f"{max_err}")

    # -- timing at the same shapes -------------------------------------------
    step = planned.dense_steps_w[T]
    # the flagship's own traffic, from the state its warm sweep leaves
    flag_state = planned.init_state(N_KEYS)[0]
    cols, delta, sel = flagship_inputs(torch, dev, BATCH)
    hdr = ps.launch(step.kernel_plan, flag_state, cols, None, (1000, delta),
                    sel, 0, 1003, True)[1][0]
    if [int(x) for x in hdr] != [BATCH, 0]:
        fail(f"flagship block step header {[int(x) for x in hdr]}")
    replicate_block(flag_state, BATCH)
    flag = time_traffic(torch, ps, step, flag_state, cols, (1010, delta),
                        sel, 1013)
    del flag_state
    # seeded random traffic, from the state the comparison left
    replicate_block(kern_state, BATCH)
    rcols, wire, _, rsel, _, now = random_step_inputs(
        rng, torch, dev, planned.in_schemas[T].types, N_KEYS, BATCH, 4, True)
    rand = time_traffic(torch, ps, step, kern_state, rcols, wire, rsel, now)
    del kern_state
    for name, t in (("flagship traffic", flag), ("random traffic", rand)):
        print(f"timing ({name}, dense step, 2^20-key state, {BATCH} keys x "
              f"4 events): kernel {t['ms']:.4f} ms/send, kernel+projection "
              f"{t['step_ms']:.4f} ms/send, plain torch step "
              f"{t['plain_ms']:.4f} ms/send, bound {t['bound_ms']:.4f} ms "
              f"by {t['bound_by']} ({t['bytes']} bytes, {t['ops']} ops)")
    mgr.shutdown()

    # -- the flagship through SiddhiManager ----------------------------------
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(ql)
    matches = [0]
    samples = []

    def on_batch(ts, payload):
        matches[0] += payload["n_current"]
        if len(samples) < 2:
            cols = payload["cols"]
            v = payload["valid"]
            samples.append({k: c[v] for k, c in cols.items()})

    rt.add_batch_callback("flagship", on_batch)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    blocks = N_KEYS // BATCH
    key_block = [np.repeat(np.arange(b * BATCH, (b + 1) * BATCH,
                                     dtype=np.int64), 4)
                 for b in range(blocks)]
    vol4 = np.tile(np.array([1, 2, 3, 4], np.int32), BATCH)
    price4 = vol4.astype(np.float32)
    clock = [1000]

    def send(block):
        clock[0] += 10
        ts = clock[0] + np.tile(np.arange(4, dtype=np.int64), BATCH)
        h.send_columns([key_block[block], price4, vol4], timestamps=ts)

    ps.reset_counts()
    for b in range(blocks):                 # warm sweep
        send(b)
    rt.flush()
    warm = matches[0]
    lat = []
    t0 = time.perf_counter()
    for _ in range(SWEEPS):
        for b in range(blocks):
            tb = time.perf_counter()
            send(b)
            lat.append(time.perf_counter() - tb)
    rt.flush()
    dt = time.perf_counter() - t0
    launches, plain_calls = ps.launches, ps.plain_calls
    got = matches[0] - warm
    profile = device_profile(torch, rt, blocks, send)
    mgr.shutdown()
    expected = SWEEPS * N_KEYS
    events = SWEEPS * blocks * BATCH * 4
    lat_ms = np.sort(np.array(lat)) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    # what each send copies to the card: its three columns, the ts deltas
    # and the [Kb, 4] selection
    h2d = (key_block[0].nbytes + price4.nbytes + vol4.nbytes +
           4 * BATCH * 4 + 4 * BATCH * 4)
    print(f"flagship: {events} events in {dt:.3f} s -> {events / dt:.0f} "
          f"ev/s; matches {got} (expected {expected}); per-send p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms over {len(lat)} sends; "
          f"host-to-device {h2d} bytes per send; kernel launches "
          f"{launches}, plain step calls {plain_calls}")
    if got != expected:
        fail(f"flagship match count {got} != {expected}")
    if launches <= 0:
        fail("the flagship path never launched the kernel")
    if plain_calls != 0:
        fail(f"the flagship path called the plain step {plain_calls} times")
    for b, s in enumerate(samples):        # the first sends: blocks 0, 1
        want = np.arange(b * BATCH, (b + 1) * BATCH, dtype=np.int64)
        if not (np.array_equal(np.sort(s["k"]), want) and
                np.all(s["p1"] == 1.0) and np.all(s["p2"] == 2.0) and
                np.all(s["p4"] == 4.0)):
            fail(f"flagship match rows of block {b} do not hold the sent "
                 f"values")
    if profile["device_ms"] is None:
        print(f"profile (one more sweep, {blocks} sends): wall "
              f"{profile['wall_ms']:.3f} ms, device time not measured")
    else:
        print(f"profile (one more sweep, {blocks} sends): wall "
              f"{profile['wall_ms']:.3f} ms, device busy "
              f"{profile['device_ms']:.3f} ms (idle share "
              f"{profile['idle_share']:.4f}); top device ops: "
              + "; ".join(f"{n} {t:.3f} ms over {c} calls"
                          for n, t, c in profile["top"]))

    records = single_stream_phases(torch, np, dev)

    kernels = {"kernels": [{
        "name": "pattern_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/pattern_step.cu",
        "replaces": "siddhi_tpu/core/pattern_planner.py:268",
        "launches": launches, "max_abs_err": max_err, "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": None}] + records}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# single-stream queries: kernels K1-K4 (filter_compact, time_window,
# length_batch, group_agg)
# ---------------------------------------------------------------------------

B1 = 1 << 17              # events per send in the three configurations
N_SYM = 256               # config 1's symbols
WINDOW = 1 << 24          # config 1's @capacity(window=...)
FILL = 100                # sends that fill config 1's 1-second window
TIMED = 32                # timed sends per configuration
ROW_OUT = 8 + 4 + 1 + 8 + 4   # an output row's ts, kind, valid, seq, slot


def single_modules():
    from siddhi_tpu_torch.kernels import filter_compact, group_agg, \
        length_batch, time_window
    return {"filter_compact": filter_compact, "time_window": time_window,
            "length_batch": length_batch, "group_agg": group_agg}


def float_err(torch, a, b, what):
    """Largest |a - b| over two equal-shaped columns, which must be equal:
    the kernels and their plain versions walk every row in the same order,
    so the stated tolerance is 0 for floats too (NaN equal to NaN)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        fail(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    same = (a == b) | (a != a) & (b != b)
    err = 0.0
    if a.dtype.is_floating_point and a.numel():
        err = float(torch.where(same, 0.0, (a - b).abs().nan_to_num(
            float("inf"))).max())
    try:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    except AssertionError:
        d = torch.nonzero(~same).flatten()[:5].tolist()
        fail(f"{what}: differ (max |a - b| {err}) at rows {d}: "
             f"{a[d].tolist()} vs {b[d].tolist()}")
    return err


def rows_err(torch, ra, rb, what, full=False):
    """Two window outputs agree: the valid flags everywhere, every field
    on the valid rows (on all rows with `full`)."""
    err = float_err(torch, ra.valid, rb.valid, f"{what} valid")
    m = slice(None) if full else ra.valid
    for f in ("ts", "kind", "seq", "gslot"):
        err = max(err, float_err(torch, getattr(ra, f)[m],
                                 getattr(rb, f)[m], f"{what} {f}"))
    for j, (x, y) in enumerate(zip(ra.cols, rb.cols)):
        err = max(err, float_err(torch, x[m], y[m], f"{what} col {j}"))
    return err


def ring_err(torch, a, b, what):
    err = float_err(torch, a.meta[:3], b.meta[:3], f"{what} meta")
    pos = a.live()[3]
    for x, y in ((a.ts, b.ts), (a.add_seq, b.add_seq),
                 (a.expire_ts, b.expire_ts), (a.gslot, b.gslot),
                 *zip(a.cols, b.cols)):
        err = max(err, float_err(torch, x[pos], y[pos], f"{what} ring"))
    return err


def batch_state_err(torch, a, b, what):
    err = float_err(torch, a.meta, b.meta, f"{what} meta")
    fill, pc = int(a.meta[0]), int(a.meta[1])
    for x, y, n in ((a.p_ts, b.p_ts, fill), (a.p_gslot, b.p_gslot, fill),
                    *((x, y, fill) for x, y in zip(a.p_cols, b.p_cols)),
                    (a.q_ts, b.q_ts, pc), (a.q_gslot, b.q_gslot, pc),
                    *((x, y, pc) for x, y in zip(a.q_cols, b.q_cols))):
        err = max(err, float_err(torch, x[:n], y[:n], f"{what} state"))
    return err


def staged_rows(torch, np, dev, types, ts, n, kind=0, seed=0, cols=None):
    """One staged batch on the card: capacity len(ts), rows [0, n) valid,
    random columns by attribute type unless given."""
    rng = np.random.default_rng(seed)
    B = len(ts)
    mk = {"LONG": lambda: rng.integers(0, N_SYM, B).astype(np.int64),
          "INT": lambda: rng.integers(0, 9, B).astype(np.int32),
          "FLOAT": lambda: rng.random(B, dtype=np.float32),
          "DOUBLE": lambda: rng.random(B, dtype=np.float32),
          "STRING": lambda: rng.integers(-1, 16, B).astype(np.int32)}
    cols = cols or [mk[t]() for t in types]
    valid = np.zeros(B, np.bool_)
    valid[:n] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(np.asarray(ts, np.int64)), t(np.full(B, kind, np.int32)),
            t(valid), t(rng.integers(0, 64, B).astype(np.int32)),
            tuple(t(c) for c in cols))


def compare_filter(torch, np, dev, spec, types):
    """K1 against its plain version at B = 131,072: all rows pass, none
    pass, a partial bucket, a random mix; every row of the stable
    partition, the count and the seq counter compared."""
    fc = single_modules()["filter_compact"]
    rng = np.random.default_rng(31)
    ids = rng.integers(0, 16, B1).astype(np.int32)
    cases = {
        "all pass": [ids, np.full(B1, 75.0, np.float32),
                     np.full(B1, 150, np.int64)],
        "none pass": [ids, np.full(B1, 75.0, np.float32),
                      np.zeros(B1, np.int64)],
        "random": [ids, (25 + 75 * rng.random(B1)).astype(np.float32),
                   rng.integers(50, 250, B1).astype(np.int64)]}
    err, n = 0.0, 0
    # an empty bucket queues no kernel: the count is 0 and seq unmoved
    ts, kind, valid, gslot, dcols = staged_rows(
        torch, np, dev, types, np.zeros(0, np.int64), 0,
        cols=[c[:0] for c in cases["random"]])
    s1 = torch.tensor([7], dtype=torch.int64, device=dev)
    ra, ca = fc.launch(spec, ts, kind, valid, gslot, dcols, s1)
    rb, cb = fc.plain(spec, ts, kind, valid, gslot, dcols, 0, s1.clone())
    torch.cuda.synchronize()
    if int(ca) != 0 or int(s1) != 7 or int(cb) != 0:
        fail(f"K1 empty bucket: count {int(ca)}, seq {int(s1)}")
    err = max(err, rows_err(torch, ra, rb, "K1 empty", full=True))
    print("compare: filter_compact empty bucket: count 0, seq unmoved")
    n += 1
    for name, cols in cases.items():
        for valid_n in (B1, 3 * B1 // 4 + 1):
            ts, kind, valid, gslot, dcols = staged_rows(
                torch, np, dev, types, 1000 + np.arange(B1), valid_n,
                cols=cols)
            s1 = torch.tensor([7], dtype=torch.int64, device=dev)
            s2 = s1.clone()
            ra, ca = fc.launch(spec, ts, kind, valid, gslot, dcols, s1)
            rb, cb = fc.plain(spec, ts, kind, valid, gslot, dcols, 0, s2)
            torch.cuda.synchronize()
            err = max(err, rows_err(torch, ra, rb, f"K1 {name}", full=True),
                      float_err(torch, ca, cb, "K1 count"),
                      float_err(torch, s1, s2, "K1 seq"))
            n += 1
            print(f"compare: filter_compact {name}, {valid_n} of {B1} rows "
                  f"valid: equal ({int(ca)} kept)")
    return err, n


def ring_step(torch, np, tw, fc, spec, types, ka, kb, B, ts, n, now, t,
              kind=0, seed=0):
    """One K2 step from two equal rings: kernel on `ka`, plain on `kb`;
    host facts as the runtime keeps them."""
    dev = ka.ts.device
    ts_d, kind_d, valid, gslot, cols = staged_rows(
        torch, np, dev, types, ts, n, kind=kind, seed=seed)
    arr, na = fc.plain(spec, ts_d, kind_d, valid, gslot, cols, now)
    cur = np.asarray(ts[:n] if kind == 0 else ts[:0], np.int64)
    f = ka.facts
    e_bound = f.expire_bound(now)
    kb.facts.expire_bound(now)
    cap = e_bound + cur.shape[0]
    a_sorted = cur.shape[0] < 2 or bool(np.all(cur[1:] >= cur[:-1]))
    ra, wa = tw.launch(ka, arr, na, now, t, B, cap, e_bound, f.sorted,
                       a_sorted)
    rb, wb = tw.plain(kb, arr, na, now, t, B, cap, e_bound)
    torch.cuda.synchronize()
    ka.facts.after_step(cur, now, t)
    kb.facts.after_step(cur, now, t)
    return ra, rb, wa, wb, (e_bound, cap, f.sorted, a_sorted)


def short_bound_case(torch, np, tw, fc, spec, types, ka, kb, now, t):
    """A TIMER step at `now` sized by a deliberately short expire bound of
    one row: kernel and plain must both leave the ring as it was, emit no
    valid row and report the same number of missed rows."""
    snap = ka.clone()
    ts_d, kind_d, valid, gslot, cols = staged_rows(
        torch, np, ka.ts.device, types, np.full(8, now), 1, kind=2)
    arr, na = fc.plain(spec, ts_d, kind_d, valid, gslot, cols, now)
    ra, wa = tw.launch(ka, arr, na, now, t, 8, 1, 1, ka.facts.sorted, True)
    rb, wb = tw.plain(kb, arr, na, now, t, 8, 1, 1)
    torch.cuda.synchronize()
    missed = int(wa[1])
    if missed <= 0 or bool(ra.valid.any()) or bool(rb.valid.any()):
        fail(f"K2 short bound at {now}: missed {missed}, valid rows "
             f"{int(ra.valid.sum())} / {int(rb.valid.sum())}")
    err = max(float_err(torch, wa, wb, "K2 short bound wake"),
              ring_err(torch, ka, snap, "K2 short bound kernel ring"),
              ring_err(torch, kb, snap, "K2 short bound plain ring"))
    print(f"compare: time_window TIMER step at {now} with an expire bound "
          f"of 1 row (ring in expiry order {ka.facts.sorted}): both "
          f"versions leave the ring as it was and report {missed} missed "
          f"rows")
    return err


def compare_time_window(torch, np, dev, spec, types, schema):
    """K2 against its plain version on a ring of 8 sends (2^20 rows at
    131,072-row sends): in-order sends with equal timestamps, out-of-order and jittered
    ones, TIMER-only steps, an overflowing ring, a step that expires the
    whole window."""
    mods = single_modules()
    tw, fc = mods["time_window"], mods["filter_compact"]
    C, t = 8 * B1, 1000
    ka = tw.TimeRing.empty(schema, C, dev)
    kb = ka.clone()
    rng = np.random.default_rng(32)
    plan = []                      # (what, ts array or None for TIMER, now)
    for i in range(5):
        plan.append(("in order, equal ts", np.full(B1, 1000 + 100 * i), None))
    plan.append(("TIMER", None, 2150))
    plan.append(("out of order", 1400 + rng.integers(-300, 300, B1), None))
    plan.append(("sorted within", np.sort(1500 + rng.integers(0, 90, B1)),
                 None))
    for i in range(4):             # 2^20 rows: the ring overflows
        plan.append(("overflow", np.full(B1, 1600 + 10 * i), None))
    plan.append(("TIMER", None, 2500))
    plan.append(("whole window expires", np.full(B1, 9000), None))
    err = 0.0
    for it, (what, ts, now) in enumerate(plan):
        if ts is None:
            ts_arr, n, kind = np.full(8, now), 1, 2
            err = max(err, short_bound_case(torch, np, tw, fc, spec, types,
                                            ka, kb, now, t))
        else:
            ts_arr, n, kind, now = ts, B1, 0, int(ts.max())
        ra, rb, wa, wb, info = ring_step(torch, np, tw, fc, spec, types, ka,
                                         kb, len(ts_arr), ts_arr, n, now, t,
                                         kind=kind, seed=100 + it)
        err = max(err, rows_err(torch, ra, rb, f"K2 step {it} {what}"),
                  float_err(torch, wa, wb, f"K2 step {it} wake"),
                  ring_err(torch, ka, kb, f"K2 step {it}"))
        print(f"compare: time_window step {it} ({what}; expire bound "
              f"{info[0]}, rows out <= {info[1]}, prefix {info[2]}, "
              f"arrivals in order {info[3]}): equal, "
              f"{int(ra.valid.sum())} rows, wake {int(wa[0])}")
    return err, len(plan)


def compare_length_batch(torch, np, dev, spec, types, schema):
    """K3 against its plain version at n = 1000: sends that complete no
    batch, one, and many (131,072 rows: 131 or 132 flushes)."""
    mods = single_modules()
    lb, fc = mods["length_batch"], mods["filter_compact"]
    ka = lb.BatchState.empty(schema, 1000, dev)
    kb = ka.clone()
    err = 0.0
    sizes = [(8, 0), (512, 500), (1024, 700), (B1, B1), (8, 0),
             (B1, 3 * B1 // 4 - 1), (2048, 1999), (B1, B1)]
    for it, (B, n) in enumerate(sizes):
        ts_d, kind_d, valid, gslot, cols = staged_rows(
            torch, np, dev, types, np.full(B, 1000 + it), n, seed=200 + it)
        arr, na = fc.plain(spec, ts_d, kind_d, valid, gslot, cols, 0)
        cap = lb.out_capacity(1000, n)
        ra = lb.launch(ka, arr, na, 1000 + it, cap)
        rb = lb.plain(kb, arr, na, 1000 + it, cap)
        torch.cuda.synchronize()
        err = max(err, rows_err(torch, ra, rb, f"K3 send {it}"),
                  batch_state_err(torch, ka, kb, f"K3 send {it}"))
        print(f"compare: length_batch send {it} ({n} arrivals): equal, "
              f"{int((ra.kind[ra.valid] == 3).sum())} flushes")
    return err, len(sizes)


def agg_specs(torch):
    from siddhi_tpu_torch.kernels import group_agg as ga
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    return [ga.ScanSpec(ga.OP_ADD, i64, 0), ga.ScanSpec(ga.OP_ADD, f32, 0.0),
            ga.ScanSpec(ga.OP_MIN, i32, 2 ** 31 - 1),
            ga.ScanSpec(ga.OP_MAX, i32, -2 ** 31),
            ga.ScanSpec(ga.OP_MIN, i64, 2 ** 63 - 1),
            ga.ScanSpec(ga.OP_MAX, i64, -2 ** 63),
            ga.ScanSpec(ga.OP_MIN, f32, float("inf")),
            ga.ScanSpec(ga.OP_MAX, f32, float("-inf"))]


def compare_group_agg(torch, np, dev):
    """K4 against its plain version on 262,144 rows (two sends) and 4096
    slots: add,
    min and max on each dtype, RESET epochs, rows without a slot (-1),
    non-contributing rows, carry states."""
    ga = single_modules()["group_agg"]
    specs = agg_specs(torch)
    rng = np.random.default_rng(34)
    K, err = 4096, 0.0
    for trial, (B, n_slots, p_reset) in enumerate(
            ((2 * B1, 4096, 0.0005), (2 * B1, 1, 0.001),
             (3 * B1 // 4, 300, 0.0))):
        kind = rng.choice([0, 1, 3, 2], B,
                          p=[0.55 - p_reset, 0.35, p_reset, 0.1])
        kind_d = torch.from_numpy(kind.astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.random(B) < 0.95).to(dev)
        sign = ((valid & (kind_d == 0)).to(torch.int32) -
                (valid & (kind_d == 1)).to(torch.int32))
        gslot = torch.from_numpy(
            rng.integers(-1, n_slots, B).astype(np.int32)).to(dev)
        vals, state = [], []
        for s in specs:
            if s.dtype == torch.float32:
                v = rng.random(B, dtype=np.float32) * 8 - 4
                st = rng.random(K, dtype=np.float32) * 64
            else:
                v = rng.integers(-10 ** 6, 10 ** 6, B)
                st = rng.integers(-10 ** 6, 10 ** 6, K)
            v = torch.from_numpy(v).to(device=dev, dtype=s.dtype)
            vals.append(torch.where(sign != 0, v, torch.full_like(v, s.init)))
            state.append(torch.from_numpy(st).to(device=dev, dtype=s.dtype))
        na, ra = ga.launch(specs, state, vals, sign, kind_d, valid, gslot)
        nb, rb = ga.plain(specs, state, vals, sign, kind_d, valid, gslot)
        torch.cuda.synchronize()
        for j in range(len(specs)):
            err = max(err, float_err(torch, na[j], nb[j], f"K4 state {j}"),
                      float_err(torch, ra[j], rb[j], f"K4 rows {j}"))
        print(f"compare: group_agg {B} rows, {n_slots} slots, "
              f"{int((valid & (kind_d == 3)).sum())} RESET rows, "
              f"{len(specs)} specs: equal")
    return err, 3


def event_timer(torch, fn, reps, before=None):
    """Mean device ms of fn() over `reps` calls, each timed by CUDA events
    (`before()` runs outside the events)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def graph_ms(torch, fn, reps, before=None):
    """Device ms of the kernels fn() launches: captured once in a CUDA
    graph (host launch costs left out) and replayed `reps` times between
    CUDA events, `before()` running outside the events."""
    if before is not None:
        before()
    fn()                       # warm: builds and loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return event_timer(torch, g.replay, reps, before)


def bound(nbytes, ops=0):
    b_ms = nbytes / H100_BYTES_PER_S * 1e3
    o_ms = ops / H100_FP32_PER_S * 1e3
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def col_bytes(cols):
    return sum(c.element_size() for c in cols)


def time_filter(torch, np, dev, spec, types):
    """K1 at config 3's traffic, about half the rows passing."""
    fc = single_modules()["filter_compact"]
    rng = np.random.default_rng(35)
    cols = [rng.integers(0, 16, B1).astype(np.int32),
            (25 + 75 * rng.random(B1)).astype(np.float32),
            rng.integers(50, 250, B1).astype(np.int64)]
    ts, kind, valid, gslot, dcols = staged_rows(
        torch, np, dev, types, 1000 + np.arange(B1), B1, cols=cols)
    seq = torch.zeros(1, dtype=torch.int64, device=dev)
    args = (spec, ts, kind, valid, gslot, dcols)
    res = {"ms": graph_ms(torch, lambda: fc.launch(*args, seq), 20),
           "plain_ms": event_timer(torch, lambda: fc.plain(*args, 0, seq),
                                   5)}
    row_in = 8 + 4 + 1 + 4 + col_bytes(dcols)
    row_out = ROW_OUT + col_bytes(dcols)
    res.update(bound(B1 * (row_in + row_out) + 16,
                     B1 * len(spec.bytecode)))
    return res


def config_rows(np, rng):
    """One send of config 1 (bench.py config_time_groupby_having)."""
    return [rng.integers(0, N_SYM, B1).astype(np.int64),
            rng.random(B1, dtype=np.float32), np.ones(B1, np.int32)]


def drive(torch, np, rt, qname, stream, sends, warm, mods, last=None):
    """`warm` untimed sends, TIMED timed ones, then the rest untimed;
    `last(i)` runs before send i.  Kernel and plain-version counts from
    just before the first send to just after the last.  Returns (per-send
    host seconds of the timed sends, per-send (n_current, n_expired),
    launches, plain calls, wall seconds of the timed sends)."""
    counts = []

    def on_batch(ts, b):
        counts[-1][0] += b["n_current"]
        counts[-1][1] += b["n_expired"]
    rt.add_batch_callback(qname, on_batch)
    h = rt.get_input_handler(stream)
    for m in mods.values():
        m.reset_counts()
    lat = []
    for i, (cols, ts) in enumerate(sends):
        if i == warm:
            rt.flush()
            t_start = time.perf_counter()
        if i == warm + TIMED:
            rt.flush()
            wall = time.perf_counter() - t_start
        if last is not None:
            last(i)
        counts.append([0, 0])
        tb = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if warm <= i < warm + TIMED:
            lat.append(time.perf_counter() - tb)
    rt.flush()
    launches = {k: m.launches for k, m in mods.items()}
    plain = {k: m.plain_calls for k, m in mods.items()}
    return lat, [tuple(c) for c in counts], launches, plain, wall


def lat_line(np, name, lat, wall, n_events, h2d):
    ms = np.array(lat) * 1e3
    print(f"{name}: {n_events} events in {wall:.3f} s -> "
          f"{n_events / wall:.0f} ev/s; per-send p50 "
          f"{float(np.percentile(ms, 50)):.3f} ms, p99 "
          f"{float(np.percentile(ms, 99)):.3f} ms (over {len(lat)} sends, "
          f"so p99 is close to the slowest); host-to-device {h2d} bytes per "
          f"send")


def check_launched(name, launches, plain, which):
    for k in which:
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was never launched")
    if any(plain.values()):
        fail(f"{name}: plain versions called {plain}")
    print(f"{name}: kernel launches {launches}, plain-version calls "
          f"{plain}")


def check_sum_price(np, sends, last, syms, fetched):
    """Config 1's sum(price) on the last send against numpy: each symbol's
    last EXPIRED row holds its sum over the window after the expiry, its
    last CURRENT row the sum after the send.  The running float32 sum has
    taken one rounding per add or subtract since the first send, each at
    most 2^-24 of a value below the symbol's largest window count (prices
    lie in [0, 1)): the stated n_seg * 2^-23 * max|running value| bound.
    Returns the worst |sp - exact| as a share of its bound."""
    prices = np.stack([s[0][1] for s in sends]).astype(np.float64)
    per_send = np.stack([np.bincount(r, minlength=N_SYM) for r in syms])
    wmax = max(per_send[i:i + FILL].sum(0).max()
               for i in range(0, last + 1 - FILL + 1))
    ops = 2 * per_send[:last + 1].sum(0)           # adds + subtracts
    worst = 0.0
    first = last - FILL + 1
    for kinds, cols in fetched:
        hi = last if kinds[0] == 1 else last + 1   # the expiry or the send
        exact = np.bincount(syms[first:hi].ravel(),
                            weights=prices[first:hi].ravel(),
                            minlength=N_SYM)
        sym = cols["symbol"]
        rev = np.unique(sym[::-1], return_index=True)
        s_last = rev[0]
        got = cols["sp"][len(sym) - 1 - rev[1]].astype(np.float64)
        tol = ops[s_last] * 2.0 ** -23 * wmax
        d = np.abs(got - exact[s_last])
        if len(s_last) < N_SYM // 2 or np.any(d > tol):
            bad = s_last[d > tol][:4]
            fail(f"config 1: sum(price) of symbols {bad} is "
                 f"{got[d > tol][:4]}, numpy {exact[bad]} (bound "
                 f"{tol[d > tol][:4]})")
        worst = max(worst, float((d / tol).max()))
    return worst


def run_config1(torch, np, dev, mods):
    """Config 1 at full size: the 1-second window of 13,107,200 rows.
    Fills with 100 sends, then 32 timed sends, each a TIMER step that
    expires 131,072 rows and a data step that appends 131,072."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(CONFIG1_QL)
    qr = rt.query_runtimes["q"]
    rng = np.random.default_rng(2)
    # fill, timed, and one more whose rows are fetched for the checks
    sends = [(config_rows(np, rng), np.full(B1, 1000 + 10 * i, np.int64))
             for i in range(FILL + TIMED + 1)]
    last = len(sends) - 1
    fetch = []
    rt.add_batch_callback("q", lambda ts, b: fetch and fetch[-1].append(
        (b["kind"][b["valid"]], {k: v[b["valid"]] for k, v in
                                 b["cols"].items()})))
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "q", "S", sends, FILL, mods,
        last=lambda i: i == last and fetch.append([]))
    check_launched("config 1", launches, plain,
                   ("filter_compact", "time_window", "group_agg"))
    steady = counts[FILL:]
    if any(c != (B1, B1) for c in steady):
        fail(f"config 1: steady-state (n_current, n_expired) per send "
             f"{steady[:4]}..., expected ({B1}, {B1})")
    # the last send expires send last-100 and appends send `last`
    syms = np.stack([s[0][0] for s in sends])
    (k_exp, c_exp), (k_cur, c_cur) = fetch[-1]
    if not (np.all(k_exp == 1) and np.all(k_cur == 0)):
        fail("config 1: the TIMER step must emit EXPIRED rows only and the "
             "data step CURRENT rows only")
    win_after = np.bincount(syms[last - FILL + 1:last + 1].ravel(),
                            minlength=N_SYM)
    win_mid = np.bincount(syms[last - FILL + 1:last].ravel(),
                          minlength=N_SYM)
    for what, cols, want, pick, init in (
            ("after the send", c_cur, win_after, np.maximum, -1),
            ("after the expiry", c_exp, win_mid, np.minimum, 1 << 62)):
        got = np.full(N_SYM, init, np.int64)
        pick.at(got, cols["symbol"], cols["c"])
        seen = np.bincount(cols["symbol"], minlength=N_SYM) > 0
        if seen.sum() < N_SYM // 2 or \
                not np.array_equal(got[seen], want[seen]):
            bad = np.nonzero(seen & (got != want))[0][:4]
            fail(f"config 1: count per symbol {what}: symbols {bad} have "
                 f"{got[bad]}, numpy {want[bad]}")
        if not np.all(cols["av"] == 1.0):
            fail("config 1: avg(volume) != 1.0")
    sp_worst = check_sum_price(np, sends, last, syms, fetch[-1])
    fetch.clear()               # the sends below fetch no rows
    print(f"config 1 check: {len(steady)} steady sends with n_current = "
          f"n_expired = {B1}; last send: c of every symbol equals numpy's "
          f"count over the window after the expiry ({int(win_mid.sum())} "
          f"rows) and after the send ({int(win_after.sum())} rows); "
          f"av = 1.0; sp of every symbol within {sp_worst:.3g} of its "
          f"window's float64 sum (the bound's share)")
    h2d = B1 * (8 + 4 + 1 + 4 + 8 + 4 + 4) + 8 * (8 + 4 + 1 + 4 + 8 + 4 + 4)
    lat_line(np, "config 1 (time window group-by having, 2^24-row window)",
             lat, wall, TIMED * B1, h2d)
    clock = [1000 + 10 * len(sends)]

    def send(_):
        rt.get_input_handler("S").send_columns(
            config_rows(np, rng), timestamps=np.full(B1, clock[0], np.int64))
        clock[0] += 10
    profile = device_profile(torch, rt, 8, send)
    return mgr, rt, qr, launches, profile, clock


def time_config1_kernels(torch, np, dev, qr, clock):
    """K2 and K4 at config 1's steady state, from the end-to-end run's
    state: one TIMER step (131,072 rows expire) and one data step (131,072
    arrive), each from restored counters; the plain versions on the same
    state; the K2 pair compared with its plain version."""
    mods = single_modules()
    tw, fc, ga = mods["time_window"], mods["filter_compact"], \
        mods["group_agg"]
    p = qr.planned
    wstate, astate = qr.state
    spec, t = p.filter_spec, p.window.time_ms
    types = p.in_schema.types
    now1 = clock[0]
    rng = np.random.default_rng(36)
    timer = staged_rows(torch, np, dev, types, np.full(8, now1), 1, kind=2)
    cols = config_rows(np, rng)
    data = staged_rows(torch, np, dev, types, np.full(B1, now1), B1,
                       cols=cols)
    # the group slots the runtime gives these symbols, as on the main path
    slots = p.slot_allocator.slots_for([cols[0]], np.ones(B1, np.bool_))
    data = data[:3] + (torch.from_numpy(slots).to(dev),) + data[4:]
    meta0, facts0 = wstate.meta.clone(), wstate.facts.copy()

    def restore():
        wstate.meta.copy_(meta0)
        wstate.facts = facts0.copy()

    def one(batch, kernel):
        arr, na = fc.plain(spec, *batch, now1)
        cur = (batch[0][:B1].cpu().numpy() if batch is data else
               np.zeros(0, np.int64))
        f = wstate.facts
        eb = f.expire_bound(now1)
        cap = eb + cur.shape[0]
        B = batch[0].shape[0]
        if kernel:
            out = tw.launch(wstate, arr, na, now1, t, B, cap, eb, f.sorted,
                            cur.shape[0] < 2 or bool(np.all(
                                cur[1:] >= cur[:-1])))
        else:
            out = tw.plain(wstate, arr, na, now1, t, B, cap, eb)
        f.after_step(cur, now1, t)
        return out, arr, na

    def pair(kernel):
        return one(timer, kernel), one(data, kernel)

    restore()
    (kt, _, _), (kd, arr_d, na_d) = pair(True)
    torch.cuda.synchronize()
    meta_k = wstate.meta.clone()
    restore()
    (pt, _, _), (pd, _, _) = pair(False)
    torch.cuda.synchronize()
    err = max(rows_err(torch, kt[0], pt[0], "K2 full-size TIMER step"),
              rows_err(torch, kd[0], pd[0], "K2 full-size data step"),
              float_err(torch, kd[1], pd[1], "K2 full-size wake"),
              float_err(torch, meta_k, wstate.meta, "K2 full-size meta"))
    e = int(kt[0].valid.sum())
    print(f"compare: time_window at config 1's full size (2^24-row ring, "
          f"{e} rows expire, {B1} arrive): kernel == plain")
    # times: the pair from restored counters (the data step rewrites only
    # the ring rows past the tail, which are dead before it)
    fc_pre = [fc.plain(spec, *b, now1) for b in (timer, data)]
    curs = [np.zeros(0, np.int64), data[0].cpu().numpy()]

    def run_pair(kernel):
        for (arr, na), batch, cur in zip(fc_pre, (timer, data), curs):
            f = wstate.facts
            eb = f.expire_bound(now1)
            cap = eb + cur.shape[0]
            if kernel:
                tw.launch(wstate, arr, na, now1, t, batch[0].shape[0], cap,
                          eb, True, True)
            else:
                tw.plain(wstate, arr, na, now1, t, batch[0].shape[0], cap,
                         eb)
    tw_ms = graph_ms(torch, lambda: run_pair(True), 10, restore) / 2
    tw_plain = event_timer(torch, lambda: run_pair(False), 2, restore) / 2
    restore()
    cb = col_bytes(data[4])
    # per step: the expiring rows read (expire_ts, slot, columns) and
    # emitted; the arrivals read, emitted and written to the ring; counters
    nbytes = (e * (8 + 4 + cb + ROW_OUT + cb) +
              B1 * (8 + 4 + cb + ROW_OUT + cb + 8 + 8 + 8 + 4 + cb) +
              4 * 64) / 2
    res_tw = {"ms": tw_ms, "plain_ms": tw_plain, **bound(nbytes)}
    # K4 on the data step's rows, as the selector feeds it
    sel = p.selector_exec
    rows = kd[0]
    cur = torch.logical_and(rows.valid, rows.kind == 0)
    exp = torch.logical_and(rows.valid, rows.kind == 1)
    sign = cur.to(torch.int32) - exp.to(torch.int32)
    env = {p.input_stream_id: rows.cols, "__ts__": rows.ts,
           "__now__": now1, "__kind__": rows.kind}
    specs = [ga.ScanSpec(s.op, s.dtype, s.init) for s in sel.bank.specs]
    vals = [torch.where(sign != 0, s.vals_fn(env, sign).to(s.dtype),
                        torch.full(sign.shape, s.init, dtype=s.dtype,
                                   device=dev))
            for s in sel.bank.specs]
    args = (specs, astate, vals, sign, rows.kind, rows.valid, rows.gslot)
    na_, ra_ = ga.launch(*args)
    nb_, rb_ = ga.plain(*args)
    torch.cuda.synchronize()
    err_ga = 0.0
    for j in range(len(specs)):
        err_ga = max(err_ga, float_err(torch, na_[j], nb_[j], "K4 state"),
                     float_err(torch, ra_[j], rb_[j], "K4 rows"))
    print(f"compare: group_agg on config 1's data step ({rows.ts.shape[0]} "
          f"rows, {len(specs)} specs): kernel == plain")
    R = rows.ts.shape[0]
    vb = sum(v.element_size() for v in vals)
    K = astate[0].shape[0]
    res_ga = {"ms": graph_ms(torch, lambda: ga.launch(*args), 20),
              "plain_ms": event_timer(torch, lambda: ga.plain(*args), 2),
              **bound(R * (4 + 4 + 1 + 4 + 2 * vb) + 2 * K * vb)}
    return res_tw, res_ga, err, err_ga


def run_config2(torch, np, dev, mods):
    """Config 2 (bench.py config_length_batch): lengthBatch(1000) +
    avg(price), 131,072 events per send, about 131 flushes per send."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(CONFIG2_QL)
    rng = np.random.default_rng(1)
    warm = 4
    sends = [([np.zeros(B1, np.int64), rng.random(B1, dtype=np.float32),
               np.ones(B1, np.int32)], np.full(B1, 1000 + i, np.int64))
             for i in range(warm + TIMED + 1)]
    last = len(sends) - 1
    fetch = []
    rt.add_batch_callback("q", lambda ts, b: fetch and fetch.append(
        (b["kind"][b["valid"]], b["cols"]["ap"][b["valid"]])))
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "q", "StockStream", sends, warm, mods,
        last=lambda i: i == last and fetch.append(None))
    check_launched("config 2", launches, plain,
                   ("filter_compact", "length_batch", "group_agg"))
    sent = 0
    for i, c in enumerate(counts):
        flushes = (sent + B1) // 1000 - sent // 1000
        if c[0] != 1000 * flushes or (i and c[1] != 1000 * flushes):
            fail(f"config 2 send {i}: (n_current, n_expired) {c}, "
                 f"expected {1000 * flushes} each")
        sent += B1
    # the last send: each flushed batch's last CURRENT row holds its mean
    prices = np.concatenate([s[0][1] for s in sends]).astype(np.float64)
    kind, ap = fetch[1]
    cur_ap = ap[kind == 0]
    b0 = (B1 * last) // 1000
    flushes = (B1 * (last + 1)) // 1000 - b0
    worst = 0.0
    for f in range(flushes):
        want = prices[(b0 + f) * 1000:(b0 + f + 1) * 1000].mean()
        worst = max(worst, abs(float(cur_ap[(f + 1) * 1000 - 1]) - want))
    # float32 running sum of 1000 prices below 1: within 1000 * 2^-23 * 1000
    # of the exact sum, so the mean within 2^-23 * 1000
    if worst > 2 ** -23 * 1000:
        fail(f"config 2: a batch's avg(price) is {worst} from numpy's mean")
    print(f"config 2 check: n_current = n_expired = 1000 x flushes on all "
          f"{len(counts)} sends; on the last, avg(price) of each of its "
          f"{flushes} batches within {worst:.3g} of numpy's mean")
    h2d = B1 * (8 + 4 + 1 + 4 + 8 + 4 + 4)
    lat_line(np, "config 2 (lengthBatch(1000) avg)", lat, wall, TIMED * B1,
             h2d)
    return mgr, rt, launches


def time_length_batch(torch, np, dev, qr):
    """K3 at config 2's traffic: one 131,072-row send from the end-to-end
    run's state, from restored state each time."""
    mods = single_modules()
    lb, fc = mods["length_batch"], mods["filter_compact"]
    p = qr.planned
    st = qr.state[0]
    snap = st.clone()
    rng = np.random.default_rng(37)
    batch = staged_rows(torch, np, dev, p.in_schema.types,
                        np.full(B1, 5000), B1,
                        cols=[np.zeros(B1, np.int64),
                              rng.random(B1, dtype=np.float32),
                              np.ones(B1, np.int32)])
    arr, na = fc.plain(p.filter_spec, *batch, 5000)
    cap = lb.out_capacity(1000, B1)

    def restore():
        for a, b in ((st.p_ts, snap.p_ts), (st.q_ts, snap.q_ts),
                     (st.p_gslot, snap.p_gslot), (st.q_gslot, snap.q_gslot),
                     (st.meta, snap.meta), *zip(st.p_cols, snap.p_cols),
                     *zip(st.q_cols, snap.q_cols)):
            a.copy_(b)
    restore()
    out = lb.launch(st, arr, na, 5000, cap)
    torch.cuda.synchronize()
    n_out = int(out.valid.sum())
    cb = col_bytes(arr.cols)
    res = {"ms": graph_ms(torch, lambda: lb.launch(st, arr, na, 5000,
                                                   cap), 20, restore),
           "plain_ms": event_timer(torch, lambda: lb.plain(
               st, arr, na, 5000, cap), 3, restore),
           # each emitted row read once (ts, slot, columns) and written;
           # the previous and pending batches rewritten
           **bound(n_out * (8 + 4 + cb + ROW_OUT + cb) +
                   2 * 1000 * (8 + 4 + cb) + 3 * 8)}
    restore()
    return res


def run_config3(torch, np, dev, mods):
    """Config 3: the simple_filter sample at 131,072 events per send,
    about half the rows passing."""
    from siddhi_tpu_torch import SiddhiManager
    mgr = SiddhiManager()
    with open("samples/apps/simple_filter.siddhi") as fh:
        rt = mgr.create_siddhi_app_runtime(fh.read())
    ids = np.array([rt.interner.intern(f"S{i}") for i in range(16)],
                   np.int32)
    rng = np.random.default_rng(3)
    warm = 2
    sends = [([ids[rng.integers(0, 16, B1)],
               (25 + 75 * rng.random(B1)).astype(np.float32),
               rng.integers(50, 250, B1).astype(np.int64)],
              np.full(B1, 1000 + i, np.int64))
             for i in range(warm + TIMED + 1)]
    last = len(sends) - 1
    fetch = []
    rt.add_batch_callback("filterQuery", lambda ts, b: fetch and fetch.append(
        {k: v[b["valid"]] for k, v in b["cols"].items()}))
    lat, counts, launches, plain, wall = drive(
        torch, np, rt, "filterQuery", "StockStream", sends, warm, mods,
        last=lambda i: i == last and fetch.append(None))
    check_launched("config 3", launches, plain, ("filter_compact",))
    for i, ((sym, price, vol), _) in enumerate(sends):
        keep = (vol > 100) & (price >= 50.0)
        if counts[i][0] != int(keep.sum()):
            fail(f"config 3 send {i}: {counts[i][0]} rows, numpy "
                 f"{int(keep.sum())}")
    sym, price, vol = sends[last][0]
    keep = (vol > 100) & (price >= 50.0)
    got = fetch[1]
    if not (np.array_equal(got["symbol"], sym[keep]) and
            np.array_equal(got["price"], price[keep])):
        fail("config 3: the last send's rows are not the sent ones")
    print(f"config 3 check: on all {len(sends)} sends the count equals "
          f"numpy's ({counts[-1][0]} of {B1} on the last), and the last "
          f"send's rows are the sent ones, in order")
    h2d = B1 * (8 + 4 + 1 + 4 + 4 + 4 + 8)
    lat_line(np, "config 3 (simple_filter)", lat, wall, TIMED * B1, h2d)
    return mgr, rt, launches


def single_stream_phases(torch, np, dev):
    """Phases 6-9: K1-K4 against their plain versions, the three
    configurations end to end, per-kernel times at full-size traffic, a
    profiled sweep of config 1.  Returns the four kernel records."""
    from siddhi_tpu_torch import SiddhiManager
    mods = single_modules()
    # -- kernel vs plain ----------------------------------------------------
    crt = SiddhiManager(device=dev).create_siddhi_app_runtime(CONFIG1_QL)
    c1 = crt.query_runtimes["q"].planned
    frt = SiddhiManager(device=dev)
    with open("samples/apps/simple_filter.siddhi") as fh:
        frt = frt.create_siddhi_app_runtime(fh.read())
    c3 = frt.query_runtimes["filterQuery"].planned
    err = {}
    err["filter_compact"], n1 = compare_filter(torch, np, dev,
                                               c3.filter_spec,
                                               c3.in_schema.types)
    err["time_window"], n2 = compare_time_window(
        torch, np, dev, c1.filter_spec, c1.in_schema.types, c1.in_schema)
    err["length_batch"], n3 = compare_length_batch(
        torch, np, dev, c1.filter_spec, c1.in_schema.types, c1.in_schema)
    err["group_agg"], n4 = compare_group_agg(torch, np, dev)
    print(f"compare: K1-K4 == plain over {n1 + n2 + n3 + n4} steps")
    times = {"filter_compact": time_filter(torch, np, dev, c3.filter_spec,
                                           c3.in_schema.types)}
    del crt, frt
    # -- the three configurations end to end ---------------------------------
    launches = {k: 0 for k in mods}
    mgr, rt, qr, l1, profile, clock = run_config1(torch, np, dev, mods)
    times["time_window"], times["group_agg"], e2, e4 = \
        time_config1_kernels(torch, np, dev, qr, clock)
    err["time_window"] = max(err["time_window"], e2)
    err["group_agg"] = max(err["group_agg"], e4)
    mgr.shutdown()
    del mgr, rt, qr
    torch.cuda.empty_cache()
    mgr, rt, l2 = run_config2(torch, np, dev, mods)
    times["length_batch"] = time_length_batch(torch, np, dev,
                                              rt.query_runtimes["q"])
    mgr.shutdown()
    mgr, rt, l3 = run_config3(torch, np, dev, mods)
    mgr.shutdown()
    for lx in (l1, l2, l3):
        for k, v in lx.items():
            launches[k] += v
    if profile["device_ms"] is None:
        print(f"profile (config 1, 8 more sends): wall "
              f"{profile['wall_ms']:.3f} ms, device time not measured")
    else:
        print(f"profile (config 1, 8 more sends): wall "
              f"{profile['wall_ms']:.3f} ms, device busy "
              f"{profile['device_ms']:.3f} ms (idle share "
              f"{profile['idle_share']:.4f}); top device ops: "
              + "; ".join(f"{n} {t:.3f} ms over {c} calls"
                          for n, t, c in profile["top"]))
    reasons = {
        "filter_compact": "no single torch call filters and stably "
                          "partitions every column with seq numbers",
        "time_window": "no single torch call runs a window's expiry and "
                       "append",
        "length_batch": "no single torch call runs a batch window's "
                        "flushes",
        "group_agg": "no single torch call computes a segmented scan "
                     "with carry state"}
    records = []
    for k, src, rep in (
            ("filter_compact", "filter_compact.cu",
             "siddhi_tpu/core/planner.py:124"),
            ("time_window", "time_window.cu", "siddhi_tpu/core/window.py:346"),
            ("length_batch", "length_batch.cu",
             "siddhi_tpu/core/window.py:447"),
            ("group_agg", "group_agg.cu", "siddhi_tpu/core/selector.py:320")):
        t = times[k]
        print(f"timing {k}: kernel {t['ms']:.4f} ms/launch, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
              f"{t['bound_by']} ({t['bytes']} bytes, {t['ops']} ops), "
              f"launches on the main path {launches[k]}; library_ms null: "
              f"{reasons[k]}")
        records.append({
            "name": k, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[k], "max_abs_err": err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return records


# bench.py:241 config_time_groupby_having with the window sized to hold
# the whole second (13,107,200 rows at its traffic)
CONFIG1_QL = """
@app:playback
define stream S (symbol long, price float, volume int);
@capacity(window='16777216')
@info(name='q') from S#window.time(1 sec)
select symbol, sum(price) as sp, count() as c, avg(volume) as av
group by symbol having sp > 0.0
insert into Out;
"""

# bench.py:224 config_length_batch
CONFIG2_QL = """
@app:playback
define stream StockStream (symbol long, price float, volume int);
@info(name='q') from StockStream#window.lengthBatch(1000)
select avg(price) as ap insert into OutputStream;
"""


# the flagship query (siddhi_tpu/analysis/corpus.py FLAGSHIP_QL_TEMPLATE
# with no async/pipeline annotation and 4 NFA slots)
FLAGSHIP_QL = """
@app:playback
define stream TradeStream (key long, price float, volume int);
partition with (key of TradeStream)
begin
  @capacity(keys='{n_keys}', slots='4')
  @emit(rows='2')
  @info(name='flagship')
  from every e1=TradeStream[volume == 1]
       -> e2=TradeStream[volume == 2 and price >= e1.price]
       -> e3=TradeStream[volume == 3]
       -> e4=TradeStream[volume == 4 and price >= e3.price]
  select e1.key as k, e1.price as p1, e2.price as p2, e4.price as p4
  insert into Matches;
end;
"""

VARIANT_QL = """
define stream T (key long, price float, volume int, flag bool, sym string);
partition with (key of T)
begin
  @capacity(keys='65536', slots='3')
  @info(name='variant')
  from every e1=T[volume == 1 and not (sym is null)]
       -> e2=T[volume >= 2 and (price * 2.0 >= e1.price + 0.1 or flag)]
       -> e3=T[volume == 3 and e1.sym == sym and key / 2 != e2.key - 100L]
       within 100 sec
  select e1.key as k, e1.price as p1, e3.flag as f, e2.sym as s
  insert into M;
end;
"""

TWO_STREAM_QL = """
define stream A (key long, price float, volume int);
define stream B (key long, level int, ok bool);
partition with (key of A, key of B)
begin
  @capacity(keys='65536', slots='2')
  @info(name='two')
  from e1=A[volume == 1] -> e2=B[level > e1.volume and ok]
       -> e3=A[price >= e1.price and volume != e2.level]
  select e1.key as k, e2.level as l, e3.price as p3
  insert into M2;
end;
"""

if __name__ == "__main__":
    main()
