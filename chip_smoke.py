"""Chip smoke test of the PyTorch / CUDA port (siddhi_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. the card: name and power limit from nvidia-smi;
  2. build: compiles the pattern_step kernel from
     siddhi_tpu_torch/csrc/pattern_step.cu with nvcc;
  3. kernel vs plain: the kernel against its plain PyTorch version on the
     card from the same state, on seeded random traffic: the flagship query
     at its step's shapes (2^20-key state, 131,072 keys per send, 4 events
     per key, and one send of 1 event per key), a within / bool / string
     query and a two-stream query without `every` at 65,536 keys; dense and
     gather steps, ts-delta and raw-ts wires, compacted and uncompacted
     rows.  State blobs, overflow counter, header and the valid output rows
     must be equal (floats: NaN equals NaN, +0 equals -0, otherwise exact);
  4. timing at the flagship step's shapes, on the flagship's own traffic
     and on random traffic: the kernel (CUDA events) beside its plain
     version and the bound of the bytes and operations these inputs need;
  5. the flagship through SiddhiManager at full size: 2^20 partition keys,
     131,072-key sends of 4 events each, one warm sweep and 4 timed sweeps;
     the match count must be 4 x 2^20 with the kernel launched and the
     plain step never called, and sampled match rows must hold the values
     the traffic implies.  Per-send p50 / p99 are over the 32 timed sends,
     so p99 is close to the slowest send.
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

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    ps.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in ps.ptxas_report().splitlines()
             if "pattern_step_kernel" in ln or "registers" in ln or
             "spill" in ln]
    print(f"build: {build_s:.2f} s ({ps.library_path()})")
    for ln in ptxas:
        print(f"ptxas: {ln}")

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

    kernels = {"kernels": [{
        "name": "pattern_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/pattern_step.cu",
        "replaces": "siddhi_tpu/core/pattern_planner.py:268",
        "launches": launches, "max_abs_err": max_err, "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": None}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


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
